"""The traced slice of a run: a ``torch.profiler`` capture of the device
and the host, and the reductions the per-layer readers share.

A capture records every CUDA kernel, copy and memset, and the host's
aten ops and ``record_function`` ranges; the slice itself is the range
``perfbench.window`` on the thread that opened it. Times are seconds.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import time

import torch

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def record(name: str):
    """A host range in the capture (nothing when no capture runs)."""
    return torch.profiler.record_function(name)


class Capture:
    """``with Capture() as cap:`` traces its body; ``cap.trace`` is the
    :class:`Trace` after the block, or None when the profiler saw no
    device work. By default only the device and the CUDA runtime calls
    are recorded, which costs the host little; ``host_ops=True`` adds
    every aten op and ``record_function`` range (the attribution of
    kernels to the ops that launched them), and slows a host-bound loop."""

    def __init__(self, host_ops: bool = False):
        self.trace = None
        self.host_ops = host_ops
        self._prof = None
        self._window = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA] if cuda else []
        if self.host_ops or not cuda:
            acts.append(ProfilerActivity.CPU)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = record(WINDOW)
        self._window.__enter__()
        if cuda:  # a runtime call on this thread marks the slice's start
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t0
        self._window.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        trace = Trace(events, self.host_s, self._t0)
        self.trace = trace if trace.device and trace.window_s > 0 else None
        print(f"perfbench: traced slice of {self.host_s:.3f} s: {len(events)} events, "
              f"{len(trace.device)} device ops, {len(trace.runtime)} CUDA calls, "
              f"{sum(e['name'] == 'cudaDeviceSynchronize' for e in trace.runtime)} synchronizes, "
              f"window {trace.window_s:.3f} s", file=sys.stderr)
        return False


class _Ranges:
    """Host ranges of one kind, per thread, for containment lookups."""

    def __init__(self, events):
        self.by_tid: dict = {}
        for e in sorted(events, key=lambda e: float(e["ts"])):
            s = float(e["ts"])
            self.by_tid.setdefault(e["tid"], ([], []))
            starts, items = self.by_tid[e["tid"]]
            starts.append(s)
            items.append((s, s + float(e.get("dur", 0.0)), e))

    def containing(self, tid, t: float):
        """The innermost range on ``tid`` that holds time ``t``, or None."""
        starts, items = self.by_tid.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        best = None
        for j in range(i, max(i - 64, -1), -1):
            s, end, e = items[j]
            if s <= t <= end and (best is None or s >= best[0]):
                best = (s, end, e)
        return None if best is None else best[2]


class Trace:
    """One capture's events, reduced."""

    def __init__(self, events: list, host_s: float = 0.0, host_t0: float = 0.0):
        win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
        runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "dur" in e]
        syncs = sorted(float(e["ts"]) + float(e["dur"]) for e in runtime
                       if e["name"] == "cudaDeviceSynchronize")
        if win:
            self.t0 = float(win[0]["ts"])
            self.t1 = self.t0 + float(win[0]["dur"])
        elif syncs:  # host ranges not recorded: from the opening synchronize
            self.t0, self.t1 = syncs[0], syncs[0] + host_s * 1e6
        else:
            self.t0 = self.t1 = 0.0
        # host perf_counter seconds -> trace microseconds (the opening synchronize)
        self.offset_us = (syncs[0] if syncs else self.t0) - host_t0 * 1e6
        self.window_s = (self.t1 - self.t0) / 1e6
        self.runtime = runtime
        self.host_spans: list[tuple[float, float, str]] = []
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
                       and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
                    and "dur" in e and e.get("name") != WINDOW]
        self.launch = {e["args"]["correlation"]: e for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "correlation" in e.get("args", {})}
        self.intervals = self._merged()
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6

    def _merged(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for e in sorted(self.device, key=lambda e: float(e["ts"])):
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def add_host_spans(self, spans) -> None:
        """The benchmark's own host spans, (label, start, end) in perf_counter
        seconds, for the idle gaps' labels where the profiler recorded no
        host ranges."""
        self.host_spans = sorted((a * 1e6 + self.offset_us, b * 1e6 + self.offset_us, label)
                                 for label, a, b in spans)

    def kernel_s(self, match) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name ``match`` accepts."""
        hits = [e for e in self.kernels if match(e["name"])]
        return sum(float(e["dur"]) for e in hits) / 1e6, len(hits)

    def scoped_kernel_s(self, scope: str, aten_ops=()) -> float:
        """Seconds of the kernels launched inside the host range ``scope``,
        by the backward of ops run inside it (autograd's ranges carry the
        sequence number of the forward op they differentiate), or inside
        an aten op named in ``aten_ops``."""
        scoped = _Ranges([e for e in self.ops if e["name"] == scope])
        inside = set()
        for e in self.ops:
            if e.get("cat") == "cpu_op" and "Sequence number" in e.get("args", {}):
                if scoped.containing(e["tid"], float(e["ts"])) is not None:
                    inside.add(e["args"]["Sequence number"])
        backward = _Ranges([e for e in self.ops if e["name"].startswith(
            "autograd::engine::evaluate_function")
            and e.get("args", {}).get("Sequence number") in inside])
        named = _Ranges([e for e in self.ops if e["name"] in aten_ops])
        total = 0.0
        for k in self.kernels:
            op = self.launch.get(k.get("args", {}).get("correlation"))
            if op is None:
                continue
            tid, t = op["tid"], float(op["ts"])
            if (scoped.containing(tid, t) is not None or backward.containing(tid, t) is not None
                    or named.containing(tid, t) is not None):
                total += float(k["dur"])
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle gaps summed by
        what the host was doing at their middle: the innermost
        ``perfbench.*`` range there, else the benchmark's own host span
        (:meth:`add_host_spans`), else the outermost host op of the earliest
        thread (a CUDA runtime call where host ops were not recorded), else
        outside any traced call."""
        ops: dict[str, float] = {}
        for e in self.device:
            ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"]) / 1e6
        spans = _Ranges([e for e in self.ops if e["name"].startswith("perfbench.")])
        outer = _Ranges([e for e in self.ops if e.get("cat") == "cpu_op"] or self.runtime)
        gaps: dict[str, float] = {}
        edges = [self.t0] + [t for iv in self.intervals for t in iv] + [self.t1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = None
            for tid in sorted(spans.by_tid, key=str):
                e = spans.containing(tid, mid)
                if e is not None:
                    label = e["name"]
                    break
            if label is None:
                i = bisect.bisect_right(self.host_spans, (mid, float("inf"), "")) - 1
                for j in range(i, max(i - 8, -1), -1):
                    if self.host_spans[j][0] <= mid <= self.host_spans[j][1]:
                        label = self.host_spans[j][2]
                        break
            if label is None:
                for tid in sorted(outer.by_tid, key=str):
                    e = _outermost(outer, tid, mid)
                    if e is not None:
                        label = e["name"]
                        break
            label = label or "host: outside any traced call"
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6

        def ranked(d):
            return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


def _outermost(ranges: _Ranges, tid, t: float):
    starts, items = ranges.by_tid.get(tid, ((), ()))
    i = bisect.bisect_right(starts, t) - 1
    best = None
    for j in range(i, max(i - 64, -1), -1):
        s, end, e = items[j]
        if s <= t <= end and (best is None or s <= best[0]):
            best = (s, end, e)
    return None if best is None else best[2]


def idle_share(run):
    """The share of the traced slice in which no kernel, copy or memset ran
    on the device (the ``idle_share.*`` readers)."""
    t = run.trace_data
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
