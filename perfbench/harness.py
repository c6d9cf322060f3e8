"""One run of one cell: find its files by name, drive it, read its metrics,
judge its outputs, and build the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix. Everything else is found by name under ``perfbench/``:

- ``configs/<config>.json``: the model, its widths, precision and knobs,
  and ``family``, the module ``families/<family>.py`` that builds it in
  the port, holds its plain reference and counts its work;
- ``traffic/<traffic>.json``: the mix's parameters, and ``driver``, the
  general driver ``drivers/<driver>.py`` that reads them;
- ``cells/<cell>.json``: the limits of the numbers that decide
  ``correct``, and the readings they were set from;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``, which
  returns a number or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
import zlib

import numpy as np
import torch

from .reference.precision import Precision, exact

FORBIDDEN = ("jax", "jaxlib", "flax", "image_enhancement_deglaring_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Spec:
    """A cell's entries and files."""

    def __init__(self, root: str, workload: str):
        self.root = root
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
        self.cell = cells[workload]
        entry = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.cfg = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(self._file("traffic", self.cell["traffic"], ".json"))
        self.limits = load_json(self._file("cells", workload, ".json"))["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if self._has(m) if m["moves"] in reported]

    def _has(self, metric: dict) -> bool:
        return self.cell["name"] in metric.get("workloads", [self.cell["name"]])

    def _file(self, kind: str, name: str, ext: str) -> str:
        return os.path.join(self.root, "perfbench", kind, name + ext)

    def module(self, kind: str, name: str):
        """``perfbench/<kind>/<name>.py`` (``metrics`` files are loaded by
        path: their names hold dots)."""
        if kind != "metrics":
            return importlib.import_module(f"perfbench.{kind}.{name}")
        path = self._file(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


class Run:
    """What a driver fills in and a reader reads. ``control``: None, or the
    precision the reference takes the program's place in."""

    def __init__(self, spec: Spec, *, seed: int, seconds: float, trace: bool, device,
                 started: float, control: str | None = None):
        self.spec, self.cfg, self.traffic = spec, spec.cfg, spec.traffic
        self.root, self.seed, self.seconds, self.trace = spec.root, seed, seconds, trace
        self.device = torch.device(device)
        self.started, self.control = started, control
        self.family = spec.module("families", spec.cfg["family"])
        self.peaks = load_json(os.path.join(spec.root, "perfbench", "peaks.json"))
        self.setup_s = None
        self.window: dict = {}
        self.checks: dict = {}
        self.attempted = self.failed = 0
        self.peak_bytes = 0
        self.trace_data = None
        self.trace_spans: list = []
        self.ops_trace = None  # a capture with the host's ops, where a driver takes one
        self.ops_steps = 0
        self.marks: dict = {}

    def subseed(self, name: str) -> int:
        """A 63-bit seed for one of the run's streams, from ``--seed``."""
        state = np.random.SeedSequence([self.seed % 2 ** 64, zlib.crc32(name.encode())])
        return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def mark(self, name: str) -> None:
        """Seconds since the start at one step of set-up (in ``info``)."""
        self.marks[name] = time.perf_counter() - self.started

    def window_opened(self) -> None:
        self.setup_s = time.perf_counter() - self.started

    def memory_peak(self) -> None:
        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def set_trace(self, trace, spans: list) -> None:
        self.trace_data, self.trace_spans = trace, spans

    def peak(self, key: str) -> float:
        """The card's published peak ``key`` (FLOP/s or bytes/s)."""
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else ""
        for prefix, row in self.peaks["cards"].items():
            if name.startswith(prefix):
                return float(row[key])
        raise KeyError(f"no published peaks for {name!r} in perfbench/peaks.json")

    # ---------------------------------------------------------------- models
    def reference_params(self) -> dict:
        return self.family.onnx_params(self.cfg, self.root, self.device)

    def serving_model(self):
        if self.control is None:
            return self.family.serving_model(self.cfg, self.root, self.device)
        return ReferenceInPlace(self.family.reference_forward(self.cfg, Precision(self.control)),
                                self.reference_params())

    # hooks a fault test overrides: the timed path broken underneath
    def patch_engine(self, engine) -> None:
        pass

    def patch_segment(self, segment, state):
        return segment


class ReferenceInPlace(torch.nn.Module):
    """The reference in a lower precision, where the engine expects the
    model: NHWC in, NHWC float32 out."""

    def __init__(self, forward, params: dict):
        super().__init__()
        self.forward_fn, self.params = forward, params
        self.anchor = torch.nn.Parameter(torch.zeros(1, device=next(iter(params.values())).device))

    def forward(self, x):
        with exact():
            return self.forward_fn(self.params, x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; ``correct`` when every one
    holds and none is missing."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = checks.get(name)
        if "max" in lim:
            holds = v is not None and v <= lim["max"]
            out[name] = {"value": v, "limit": lim["max"], "holds": holds}
        else:
            holds = v is not None and v >= lim["min"]
            out[name] = {"value": v, "limit_min": lim["min"], "holds": holds}
        ok = ok and holds
    return ok, out


def run_cell(root: str, workload: str, *, seed: int, seconds: float, trace: bool,
             device="cuda", started: float | None = None, control: str | None = None,
             run_class=Run) -> dict:
    """Drive one run of ``workload`` and return its result line (a dict)."""
    started = time.perf_counter() if started is None else started
    spec = Spec(root, workload)
    run = run_class(spec, seed=seed, seconds=seconds, trace=trace, device=device,
                    started=started, control=control)
    spec.module("drivers", spec.traffic["driver"]).run(run)
    correct, checks = judge(run.checks, spec.limits)
    result = {"correct": correct and run.failed == 0, "attempted": run.attempted,
              "failed": run.failed}
    if control is None:
        metrics = {}
        for m in (spec.per_layer if trace else spec.end_to_end):
            value = spec.module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    dev = run.device
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                        "count": 1, "memory_peak_bytes": run.peak_bytes}
    if trace and run.trace_data is not None:
        result["device"].update(busy_s=run.trace_data.busy_s, window_s=run.trace_data.window_s)
        result["breakdown"] = run.trace_data.breakdown()
    result["info"] = {k: v for k, v in run.window.items() if not isinstance(v, list)}
    result["info"]["setup_marks"] = run.marks
    result["info"]["readings"] = run.checks
    result["checks"] = checks
    return result
