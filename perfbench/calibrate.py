"""The readings the limits of ``correct`` are set from, in one process:
the program on a dozen seeds or more, then the control (the reference in
the program's place, in the precision below the configuration's) on three
or more, and a planted fault (``perfbench/faults.py``) on three or more,
each a short run of the cell at its own size and load. Not run by the
benchmark's own runs.

    python3 perfbench/calibrate.py --workload <cell> --seeds 101,102,... \
        --control_seeds 201,202,203 --seconds 4 [--out cal.jsonl]

Prints one JSON line per run: the seed, whether it was the control, and
every compared number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--fault_seeds", default="")
    p.add_argument("--fault", default="half", help="the fault of perfbench/faults.py to read")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import faults, harness

    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec(ROOT, args.workload)
    control = spec.cfg["control_precision"]
    runs = [(int(s), None, None) for s in args.seeds.split(",") if s]
    runs += [(int(s), control, None) for s in args.control_seeds.split(",") if s]
    runs += [(int(s), None, args.fault) for s in args.fault_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, ctl, fault in runs:
            t = time.perf_counter()
            r = harness.run_cell(ROOT, args.workload, seed=seed, seconds=args.seconds,
                                 trace=False, control=ctl,
                                 run_class=faults.run_class(fault) if fault else harness.Run)
            line = {"workload": args.workload, "seed": seed, "control": ctl, "fault": fault,
                    "correct": r["correct"], "failed": r["failed"],
                    "seconds": time.perf_counter() - t,
                    "checks": r["info"]["readings"],
                    "metrics": {k: v["value"] for k, v in r.get("metrics", {}).items()},
                    "setup_marks": r["info"]["setup_marks"]}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
