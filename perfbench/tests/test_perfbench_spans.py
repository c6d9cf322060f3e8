"""The span reader (``perfbench/spans.py``) and its five metrics against a
synthetic traced slice on the CPU; on the card, the port's spans against
the device trace's own clock.

The synthetic slice is built around spans the port really recorded: its
opening synchronize is placed so that the slice's ``offset_us`` maps
them onto chosen trace times, and its kernels leave known idle gaps
inside and between them.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_enhancement_deglaring_tpu_torch.utils import profiling
from image_enhancement_deglaring_tpu_torch.utils.profiling import span
from perfbench import faults, harness, spans
from perfbench.trace import Trace

from .conftest import ROOT

SYNC_END = 5_000.0  # the opening synchronize's end on the trace clock, us
NEW = {"queue_wait_ms.serve", "step_host_ms.serve", "fetch_copy_ms.serve",
       "step_host_ms.train", "launch_idle_ms.train"}


class _Run:
    def __init__(self, trace):
        self.trace_data = trace


def _metric(name: str):
    spec = harness.Spec(ROOT, "lwunet_prod.serve_closed_b64")
    return spec.module("metrics", name)


def _record(plan):
    """Record ``plan`` ((name, ms, attrs), ...) one after another in a
    session, 1 ms apart; returns (perf_counter seconds before the first,
    the records)."""
    before = time.perf_counter()
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for name, ms, attrs in plan:
            time.sleep(0.001)
            with span(name, **attrs):
                time.sleep(ms / 1e3)
    return before, [r for r in profiling.spans(t0) if r.name in {p[0] for p in plan}]


def _slice(host_t0: float, host_s: float, kernels, extra=()) -> Trace:
    """A device-only slice that opens with a synchronize ending at
    SYNC_END (the host's ``host_t0``) and lasts ``host_s``, with
    ``extra`` events besides."""
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "pid": 1,
               "tid": 1, "ts": SYNC_END - 10.0, "dur": 10.0}]
    events += [{"ph": "X", "cat": "kernel", "name": f"k{i}", "pid": 0, "tid": 7, "ts": a,
                "dur": b - a} for i, (a, b) in enumerate(kernels)]
    return Trace(events + list(extra), host_s, host_t0)


def _call(name: str, tid: int, ts: float, dur: float, correlation: int) -> dict:
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": dur, "args": {"correlation": correlation}}


def _on_trace(r, trace):
    return r.start_ns / 1e3 + trace.offset_us, r.end_ns / 1e3 + trace.offset_us


def test_the_new_metrics_are_listed_with_their_cells():
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    new = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(new) == NEW
    assert {n: m["source"] for n, m in new.items() if m["source"] != "program_span"} == {
        "fetch_copy_ms.serve": "device_trace"}
    for name, m in new.items():
        cells = (["lwunet_prod.serve_closed_b64"] if name.endswith(".serve") else
                 ["enhanced_unet16.train_resident_b32", "lwunet_prod.train_resident_b32"])
        assert m["workloads"] == cells
        assert m["moves"] == ("serve_img_per_s" if name.endswith(".serve") else "train_img_per_s")


def test_serving_metrics_read_the_spans_inside_the_slice():
    """Three batches: the first formed before the slice opens is left out,
    and a step still open when it ends; the queue wait is the
    row-weighted mean; step and copy are means."""
    _, recs = _record([
        ("engine.form", 1, {"rows": 64, "bucket": 64, "wait_ms_sum": 640.0, "wait_ms_max": 11.0}),
        ("engine.step", 4, {}), ("engine.fetch.copy", 2, {}),
        ("engine.form", 1, {"rows": 60, "bucket": 64, "wait_ms_sum": 120.0, "wait_ms_max": 3.0}),
        ("engine.step", 6, {}), ("engine.fetch.copy", 2, {}),
        ("engine.form", 1, {"rows": 4, "bucket": 4, "wait_ms_sum": 8.0, "wait_ms_max": 2.0}),
        ("engine.step", 8, {}), ("engine.fetch.copy", 4, {})])
    first_step = next(r for r in recs if r.name == "engine.step")
    opens = first_step.start_ns / 1e9 - 0.0001  # after the first form, before the first step
    trace = _slice(opens, 1.0, [])
    inside = [r for r in recs if r.start_ns / 1e9 >= opens]
    assert len(inside) == len(recs) - 1
    steps = [r for r in inside if r.name == "engine.step"]
    copies = [r for r in inside if r.name == "engine.fetch.copy"]
    # each copy's runtime call in the middle of its span, its device op
    # 0.5, 0.7 and 0.9 ms long, and a host-to-device copy that is not counted
    extra = []
    for i, r in enumerate(copies):
        a, b = _on_trace(r, trace)
        mid = (a + b) / 2
        extra += [_call("cudaMemcpyAsync", r.tid, mid - 100.0, 200.0, 10 + i),
                  {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
                   "pid": 0, "tid": 7, "ts": mid, "dur": 500.0 + 200.0 * i,
                   "args": {"correlation": 10 + i}}]
    a, b = _on_trace(steps[0], trace)
    extra += [_call("cudaMemcpyAsync", steps[0].tid, (a + b) / 2 - 100.0, 200.0, 20),
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
               "pid": 0, "tid": 7, "ts": (a + b) / 2, "dur": 300.0, "args": {"correlation": 20}}]
    run = _Run(_slice(opens, 1.0, [(SYNC_END, SYNC_END + 1e6)], extra))
    assert spans.offset_us(run) == pytest.approx(run.trace_data.offset_us, abs=1.0)
    assert _metric("queue_wait_ms.serve").read(run) == pytest.approx(128.0 / 64)
    assert _metric("step_host_ms.serve").read(run) == pytest.approx(
        sum(r.end_ns - r.start_ns for r in steps) / len(steps) / 1e6)
    assert _metric("fetch_copy_ms.serve").read(run) == pytest.approx((0.5 + 0.7 + 0.9) / 3)
    assert _metric("step_host_ms.serve").read(run) >= 6
    last = steps[-1]
    cut = _Run(_slice(opens, (last.start_ns + last.end_ns) / 2e9 - opens,
                      [(SYNC_END, SYNC_END + 1e6)]))
    assert _metric("step_host_ms.serve").read(cut) == pytest.approx(
        sum(r.end_ns - r.start_ns for r in steps[:-1]) / (len(steps) - 1) / 1e6)


def test_a_late_offset_is_corrected_from_the_threads_calls():
    """The slice's ``offset_us`` 2.5 ms off the spans' true place: the
    readers find it again from the thread's runtime calls, each inside
    a child of ``engine.step``, to within the gaps between the calls, and
    take the spans inside the slice by it."""
    t0 = time.perf_counter_ns()
    before = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            time.sleep(0.002)
            with span("engine.step"):
                with span("engine.step.copy_in"):
                    time.sleep(0.002)
                with span("engine.step.launch"):
                    time.sleep(0.003)
    recs = [r for r in profiling.spans(t0) if r.name.startswith("engine.step")]
    steps = [r for r in recs if r.name == "engine.step"]
    true_offset = _slice(before, 1.0, []).offset_us + 2500.0
    calls = []
    for r in recs:
        if r.name == "engine.step":
            continue
        a, b = r.start_ns / 1e3 + true_offset, r.end_ns / 1e3 + true_offset
        calls += [_call("cudaLaunchKernel", r.tid, ts, 10.0, len(calls))
                  for ts in (a + 20.0 + 50.0 * k for k in range(int((b - a - 50.0) // 50.0)))]
    late = _Run(_slice(before, 1.0, [(SYNC_END, SYNC_END + 1e6)], calls))
    assert abs(spans.offset_us(late) - true_offset) <= 50.0
    found = spans.records(late, "engine.step")
    assert len(found) == 3
    for s, r in zip(found, steps):
        assert s.start == pytest.approx(r.start_ns / 1e3 + true_offset, abs=50.0)
    assert _metric("step_host_ms.serve").read(late) == pytest.approx(
        sum(r.end_ns - r.start_ns for r in steps) / 3 / 1e6)


@pytest.mark.parametrize("fault", faults.SERVING)
def test_the_serving_faults_answer_every_request_wrongly(tiny_root, fault):
    """The engine's spans leave ``_step`` and ``_fetch`` as the faults
    take them: a planted fault answers every request, and wrongly."""
    broken = harness.run_cell(tiny_root, "lwunet_prod.serve_closed_b64", seed=2 ** 31 + 77,
                              seconds=1.0, trace=False, device="cpu",
                              run_class=faults.run_class(fault))
    checks = broken["checks"]
    assert broken["correct"] is False and checks["answered_share"]["value"] == 1.0, checks
    gap = checks["worst_image_mean_gap"]
    assert gap["value"] > gap["limit"], checks


def test_train_metrics_count_idle_inside_the_steps_only():
    """Two steps; the device is busy but for one gap inside the first step
    and one between the steps: only the first counts, per step."""
    before, recs = _record([("train.step", 6, {}), ("train.step", 6, {})])
    host_t0 = before
    trace0 = _slice(host_t0, 1.0, [])
    (a0, a1), (b0, b1) = (_on_trace(r, trace0) for r in recs)
    gap_in = (a0 + 1000.0, a0 + 3000.0)  # 2 ms inside the first step
    gap_between = (a1 + 100.0, b0 - 100.0)
    end = b1 + 5000.0
    host_s = (end - SYNC_END) / 1e6
    kernels = [(SYNC_END, gap_in[0]), (gap_in[1], gap_between[0]), (gap_between[1], end)]
    run = _Run(_slice(host_t0, host_s, kernels))
    idle = sum(b - a for a, b in spans.idle_gaps(run.trace_data)) / 1e3
    assert idle == pytest.approx(2.0 + (gap_between[1] - gap_between[0]) / 1e3)
    assert _metric("launch_idle_ms.train").read(run) == pytest.approx(2.0 / 2)
    assert _metric("launch_idle_ms.train").read(run) * 2 <= idle
    assert _metric("step_host_ms.train").read(run) == pytest.approx(
        sum(r.end_ns - r.start_ns for r in recs) / 2 / 1e6)


def test_readers_find_nothing_without_the_spans(monkeypatch):
    """No slice, no span of the name in it, or a port without the
    recorder (the parent commit's): every new metric reads None."""
    assert all(_metric(m).read(_Run(None)) is None for m in NEW)
    empty = _Run(_slice(time.perf_counter() + 3600.0, 1.0, [(SYNC_END, SYNC_END + 1e6)]))
    assert all(_metric(m).read(empty) is None for m in NEW)
    _, recs = _record([("engine.step", 1, {}), ("train.step", 1, {})])
    run = _Run(_slice(recs[0].start_ns / 1e9 - 0.001, 1.0, [(SYNC_END, SYNC_END + 1e6)]))
    assert _metric("step_host_ms.train").read(run) is not None
    monkeypatch.delattr(profiling, "spans")
    assert all(_metric(m).read(run) is None for m in NEW)


# ------------------------------------------------------------------ card


def _inside(calls, ranges) -> float:
    """The share of ``calls`` (trace events) that lie inside one of
    ``ranges`` ((start, end) on the trace clock)."""
    ranges = sorted(ranges)
    hit = sum(any(a <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b
                  for a, b in ranges) for e in calls)
    return hit / len(calls)


LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync")


def _bracketed_launches(n: int = 20) -> list[tuple[int, int]]:
    """``n`` one-kernel launches, each between two reads of the host's
    clock (in a span, so that ``trace_tids`` knows this thread)."""
    x = torch.zeros(1, device="cuda")
    marks = []
    with span("test.anchor"):
        for _ in range(n):
            a = time.perf_counter_ns()
            x.add_(1)
            marks.append((a, time.perf_counter_ns()))
    return marks


def _reanchored(t, marks) -> float:
    """The host clock's offset onto the trace from the tightest of the
    bracketed launches: the launch's middle against its bracket's."""
    rows = _rows(t.runtime, threading.get_native_id())
    launches = sorted((e for e in _calls(t.runtime, rows, t.t0, t.t1)
                       if e["name"].startswith(LAUNCHES[:2])), key=lambda e: float(e["ts"]))
    e, (a, b) = min(zip(launches, marks), key=lambda p: p[1][1] - p[1][0])
    return float(e["ts"]) + float(e["dur"]) / 2 - (a + b) / 2e3


def _rows(events, native_id) -> set:
    """The rows of the thread ``native_id``'s CUDA calls in ``events``."""
    present = {e["tid"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    return set(profiling.trace_tids(native_id)) & present


def _calls(events, rows, lo, hi):
    return [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and e["tid"] in rows and e["name"].startswith(LAUNCHES) and lo <= float(e["ts"]) <= hi]


@pytest.mark.card
def test_spans_share_the_device_traces_clock(card, tmp_path):
    """On the card: the collector's launches and copies in a serving slice
    lie inside its ``engine.step`` spans, the trainer's launches inside
    ``train.step`` or ``train.gather``, mapped as the readers map them
    (``spans.offset_us``); the readers' offset is printed beside that of
    the tightest of twenty bracketed one-kernel launches, and beside the
    slice's own ``offset_us``, which ``Capture`` reads after its opening
    synchronize returns. The same in a ``/trace?ms=1000`` capture that
    ``stop_trace`` wrote. Serving calls count over the steps inside the
    slice. Sums of spans stay within the slice, and the idle inside
    steps within its idle."""
    import socket

    from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch
    from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine
    from image_enhancement_deglaring_tpu_torch.train import TrainState, make_optimizer
    from image_enhancement_deglaring_tpu_torch.train.resident import make_train_epoch_segmented
    from perfbench.families import lightweight_unet as lw
    from perfbench.trace import Capture

    cfg = harness.load_json(os.path.join(ROOT, "perfbench/configs/lwunet_prod.json"))
    dev = torch.device("cuda")
    eng = InferenceEngine(lw.serving_model(cfg, ROOT, dev), image_size=512, max_batch_size=64,
                          compute_dtype=torch.bfloat16, device=dev)
    pages = (torch.rand(64, 512, 512) * 255).to(torch.uint8).numpy()
    stop = threading.Event()
    slots = threading.Semaphore(256)

    def client():
        n = 0
        while not stop.is_set():
            if slots.acquire(timeout=0.1):
                eng.submit(pages[n % 64]).add_done_callback(lambda f: slots.release())
                n += 1

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = profiling.start_trace_server(port, str(tmp_path))
    feeder = threading.Thread(target=client, daemon=True)
    feeder.start()
    try:
        time.sleep(2.0)
        with Capture(host_ops=False) as cap:
            marks = _bracketed_launches()
            time.sleep(1.0)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/trace?ms=1000", timeout=120) as r:
            written = json.loads(r.read())["trace"]
        collector = eng._worker.native_id
    finally:
        stop.set()
        feeder.join(timeout=30)
        server.shutdown()
        server.server_close()
        eng.stop()
    t = cap.trace
    run = _Run(t)
    found = spans.records(run, "engine.step")
    held = sum(min(s.end, t.t1) - s.start for s in found)
    print(f"serving slice: {len(found)} engine.step spans, {held / 1e3:.1f} ms of them inside "
          f"the {(t.t1 - t.t0) / 1e3:.1f} ms slice ({sum(s.end - s.start for s in found) / 1e3:.1f}"
          f" ms whole)")
    assert held <= t.t1 - t.t0
    offset = _reanchored(t, marks)
    mine = [(s.start, s.end) for s in found if s.tid == collector]
    calls = _calls(t.runtime, _rows(t.runtime, collector), mine[0][0], mine[-1][1])
    share = _inside(calls, mine)
    print(f"serving slice: {len(calls)} collector calls, {share:.4%} inside engine.step by the "
          f"readers' offset, {(spans.offset_us(run) - offset) / 1e3:+.3f} ms from the bracketed "
          f"launches' (the slice's own {(t.offset_us - offset) / 1e3:+.3f} ms)")
    assert len(calls) > 100 and share >= 0.99

    with open(written) as f:
        events = json.load(f)["traceEvents"]
    rows = _rows(events, collector)
    steps = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "program_span" and e["name"] == "engine.step"
             and e["tid"] in rows]
    calls = _calls(events, rows, min(a for a, _ in steps), max(b for _, b in steps))
    share = _inside(calls, steps)
    print(f"/trace?ms=1000: {len(calls)} collector calls, {share:.4%} inside engine.step")
    assert len(calls) > 100 and share >= 0.99

    model = lw.training_model(cfg, dev)
    state = TrainState(model=model, optimizer=make_optimizer(model, 1e-3, 1e-4, 1.0),
                       generator=torch.Generator(device=dev).manual_seed(1))
    x = torch.rand(64, 512, 512, 1, device=dev).to(torch.bfloat16)
    y = torch.rand(64, 512, 512, 1, device=dev)
    plan, segment = make_train_epoch_segmented(batch_size=32, augment_fn=device_augment_batch)
    idx = plan(3, 0, 64, dev)
    for _ in range(2):
        state, losses = segment(state, x, y, idx)
    losses.cpu()
    rows = torch.cat([idx, idx])
    with Capture(host_ops=False) as cap:
        marks = _bracketed_launches()
        state, losses = segment(state, x, y, rows)
        losses.cpu()
    t = cap.trace
    run = _Run(t)
    found = spans.records(run, "train.step")
    idle = sum(b - a for a, b in spans.idle_gaps(t))
    per_step = spans.idle_inside_ms(run, "train.step")
    print(f"training slice: {len(found)} train.step spans, "
          f"{sum(s.end - s.start for s in found) / 1e3:.1f} ms of a {(t.t1 - t.t0) / 1e3:.1f} ms "
          f"slice; idle {idle / 1e3:.2f} ms, {per_step * len(found):.2f} ms of it inside steps")
    assert sum(s.end - s.start for s in found) <= t.t1 - t.t0
    assert per_step * len(found) * 1e3 <= idle + 1e-6
    me = _rows(t.runtime, threading.get_native_id())
    held = [(s.start, s.end) for name in ("train.step", "train.gather")
            for s in spans.records(run, name)]
    offset = _reanchored(t, marks)
    calls = [e for e in _calls(t.runtime, me, t.t0, t.t1)
             if e["name"].startswith(LAUNCHES[:2])][len(marks):]
    share = _inside(calls, held)
    print(f"training slice: {len(calls)} launches, {share:.4%} inside train.step/train.gather "
          f"by the readers' offset, {(spans.offset_us(run) - offset) / 1e3:+.3f} ms from the "
          f"bracketed launches' (the slice's own {(t.offset_us - offset) / 1e3:+.3f} ms)")
    assert len(calls) > 100 and share >= 0.99
