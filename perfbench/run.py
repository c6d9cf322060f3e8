"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced
slice after the window. The last line of standard output is the result
as one JSON object; the numbers that decided ``correct`` end standard
error, each beside its limit. A run without a CUDA card exits 2 and
prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "perfbench_cache")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    spec = harness.Spec(ROOT, args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), started=STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}, which the port must not import",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        bound = f"<= {c['limit']}" if "limit" in c else f">= {c['limit_min']}"
        print(f"check {name} {c['value']!r} {bound} {'holds' if c['holds'] else 'FAILS'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
