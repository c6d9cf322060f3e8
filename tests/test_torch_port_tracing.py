"""The port's spans (``utils.profiling.span``) on the CPU.

- Nothing is recorded without a ``torch.profiler`` session; inside one,
  spans are recorded on every thread, with their parents, in a ring that
  stays bounded.
- The serving engine records every span of a batch under one ``batch``
  number (the step's children under the step), on the collector's and
  the drainer's threads; the train step
  records its children inside ``train.step``.
- ``profiling.trace`` writes the spans on their threads' rows (their
  native ids on the CPU), on the trace's clock.
- The engine's answers and ``train_model`` are bit for bit the same with
  and without a session.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch
from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine
from image_enhancement_deglaring_tpu_torch.train import TrainState, make_optimizer, train_model
from image_enhancement_deglaring_tpu_torch.train.resident import make_train_epoch_segmented
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree, profiling
from image_enhancement_deglaring_tpu_torch.utils.profiling import span, spans
from tests.loaders import ArrayLoader

SIZE = 16
SERVING = {"engine.form", "engine.step", "engine.step.copy_in", "engine.step.launch",
           "engine.backpressure", "engine.fetch.wait", "engine.fetch.copy", "engine.resolve"}
STEP_CHILDREN = {"train.augment", "train.forward", "train.backward", "train.clip", "train.update"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(records):
    out: dict = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _engine():
    model = LightweightUNet(features_start=4, generator=torch.Generator().manual_seed(1))
    return InferenceEngine(model, image_size=SIZE, max_batch_size=4, batch_timeout_ms=300.0,
                           compute_dtype=torch.float32, warmup=False, device="cpu")


def _frames(n, seed=0):
    return (np.random.default_rng(seed).random((n, SIZE, SIZE)) * 255).astype(np.uint8)


def _served(eng, frames):
    futs = [eng.submit(f) for f in frames]
    return np.stack([f.result(timeout=60) for f in futs])


def test_nothing_is_recorded_without_a_session():
    t0 = time.perf_counter_ns()
    with span("idle", batch=1) as sp:
        sp.set(rows=2)
    assert not sp and spans(t0) == []


def test_spans_in_a_session_link_parents_across_threads():
    t0 = time.perf_counter_ns()

    def work():
        with span("worker.outer", batch=7) as outer:
            outer.set(rows=3)
            with span("worker.inner", batch=7):
                pass

    with _session():
        with span("main.outer") as sp:
            assert sp
            w = threading.Thread(target=work, name="span-worker")
            w.start()
            w.join(timeout=30)
            assert not w.is_alive()
            with span("main.inner"):
                pass
    got = _by_name(spans(t0))
    (mo,), (mi,) = got["main.outer"], got["main.inner"]
    (wo,), (wi,) = got["worker.outer"], got["worker.inner"]
    assert mi.parent == mo.id and mo.parent is None and mo.tid == threading.get_native_id()
    assert wi.parent == wo.id and wo.parent is None and wo.tid == w.native_id != mo.tid
    assert wo.attrs == {"batch": 7, "rows": 3} and wi.attrs == {"batch": 7}
    assert mo.start_ns <= wo.start_ns <= wi.start_ns <= wi.end_ns <= wo.end_ns <= mo.end_ns


def test_the_ring_stays_bounded():
    t0 = time.perf_counter_ns()
    n = profiling.SPAN_RING + 10
    with _session():
        for i in range(n):
            with span("ring", i=i):
                pass
    kept = [r for r in spans(t0) if r.name == "ring"]
    assert len(spans()) <= profiling.SPAN_RING
    assert len(kept) == profiling.SPAN_RING and kept[0].attrs["i"] == 10
    assert kept[-1].attrs["i"] == n - 1


def test_engine_records_every_serving_span_of_a_batch():
    """Three frames at bucket 4: one batch, every span of it on the
    collector's or the drainer's thread under one ``batch`` number."""
    eng = _engine()
    try:
        t0 = time.perf_counter_ns()
        with _session():
            _served(eng, _frames(3))
        collector, drainer = eng._worker.native_id, eng._drainer.native_id
    finally:
        eng.stop()
    got = _by_name(spans(t0))
    assert set(got) == SERVING
    assert all(len(v) == 1 for v in got.values())
    children = ("engine.step.copy_in", "engine.step.launch")
    assert len({r.attrs["batch"] for n, v in got.items() if n not in children for r in v}) == 1
    (form,), (step,) = got["engine.form"], got["engine.step"]
    assert form.attrs["rows"] == 3 and form.attrs["bucket"] == 4
    assert 0 <= form.attrs["wait_ms_max"] <= form.attrs["wait_ms_sum"] <= 3 * form.attrs[
        "wait_ms_max"]
    assert form.end_ns <= step.start_ns
    for name in children:
        (child,) = got[name]
        assert child.parent == step.id and child.attrs == {"replica": 0}
    assert {r.tid for n in ("engine.form", "engine.step", "engine.backpressure") + children
            for r in got[n]} == {collector}
    assert {r.tid for n in ("engine.fetch.wait", "engine.fetch.copy", "engine.resolve")
            for r in got[n]} == {drainer}


def test_engine_answers_the_same_with_and_without_a_session():
    frames = _frames(7, seed=3)
    eng = _engine()
    try:
        plain = _served(eng, frames)
        with _session():
            traced = _served(eng, frames)
        np.testing.assert_array_equal(traced, plain)
        np.testing.assert_array_equal(eng.infer_batch(frames[:3]), plain[:3])
    finally:
        eng.stop()


def test_train_step_records_its_children_inside_it():
    """Two resident steps of LightweightUNet with device augmentation: each
    ``train.step`` holds one of each child, whose durations sum to no more
    than it; each step follows its ``train.gather``."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(8, SIZE, SIZE, 1, generator=g)
    y = torch.rand(8, SIZE, SIZE, 1, generator=g)
    model = LightweightUNet(features_start=4, generator=torch.Generator().manual_seed(0))
    state = TrainState(model=model, optimizer=make_optimizer(model, 1e-3, 1e-4, 1.0),
                       generator=torch.Generator().manual_seed(1))
    plan, segment = make_train_epoch_segmented(batch_size=4, augment_fn=device_augment_batch)
    t0 = time.perf_counter_ns()
    with _session():
        segment(state, x, y, plan(5, 0, 8, "cpu"))
    got = _by_name(spans(t0))
    steps, gathers = got["train.step"], got["train.gather"]
    assert len(steps) == len(gathers) == 2 and "train.reduce" not in got
    for step, gather in zip(steps, gathers):
        assert step.parent is None and gather.end_ns <= step.start_ns
        children = [r for r in spans(t0) if r.parent == step.id]
        assert {c.name for c in children} == STEP_CHILDREN and len(children) == 5
        assert all(step.start_ns <= c.start_ns <= c.end_ns <= step.end_ns for c in children)
        assert sum(c.end_ns - c.start_ns for c in children) <= step.end_ns - step.start_ns


def test_trace_writes_spans_on_the_native_tid_inside_the_capture(tmp_path):
    """The written spans sit on their threads' rows, named, and on the
    trace's clock: the host op run inside a span lies inside it there.
    A thread that has ended is forgotten once its spans are written."""

    seen = {}

    def work():
        with span("worker.span", batch=2):
            seen["tids"] = profiling.trace_tids(threading.get_native_id())

    with profiling.trace(str(tmp_path)):
        with span("main.span", batch=1):
            torch.ones(4).add_(1)
        w = threading.Thread(target=work, name="span-worker")
        w.start()
        w.join(timeout=30)
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    written = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(written) == {"main.span", "worker.span"}
    main, worker = written["main.span"], written["worker.span"]
    assert main["tid"] == threading.get_native_id() and worker["tid"] == w.native_id
    assert seen["tids"] == (w.native_id, w.ident & 0xFFFFFFFF, (1 << 32) - (w.ident & 0xFFFFFFFF))
    assert profiling.trace_tids(w.native_id) == (w.native_id,)  # ended: dropped at the stop
    assert main["args"]["batch"] == 1 and worker["args"]["batch"] == 2
    (op,) = [e for e in events if e.get("name") == "aten::add_"]
    assert op["tid"] == main["tid"]
    assert main["ts"] <= op["ts"] and op["ts"] + op["dur"] <= main["ts"] + main["dur"]
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert names[w.native_id] == "span-worker"


@pytest.mark.parametrize("resident", [False, True], ids=["streaming", "resident"])
def test_train_model_trains_the_same_in_a_session(tmp_path, resident):
    """``train_model`` inside a session equals the run outside it bit for
    bit, and records its loop's spans."""
    rng = np.random.default_rng(3)
    y = rng.random((8, SIZE, SIZE, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.1, y.shape), 0, 1).astype(np.float32)

    def run(name):
        model = LightweightUNet(features_start=4, generator=torch.Generator().manual_seed(0))
        best, _, val, state = train_model(
            model, ArrayLoader(x, y, 2), ArrayLoader(x[:4], y[:4], 4), epochs=2, lr=1e-3,
            output_dir=str(tmp_path / name), progress=False, device="cpu", resident=resident,
            device_augment=True, validation_metrics_every=100, log_images_every=100,
            handle_preemption=False)
        return flatten_tree(best), val, state

    t0 = time.perf_counter_ns()
    with _session():
        s_best, s_val, s_state = run("session")
    got = _by_name(spans(t0))
    b_best, b_val, b_state = run("plain")
    assert s_val == b_val and s_state.step == b_state.step == 8
    for k in b_best:
        np.testing.assert_array_equal(s_best[k], b_best[k], err_msg=k)
    assert len(got["train.step"]) == 8 and len(got["train.augment"]) == 8
    assert len(got["train.fetch"]) == (2 * 4 if resident else 2)
    assert len(got.get("train.gather", [])) == (8 if resident else 0)
    assert len(got.get("train.data_wait", [])) == (0 if resident else 2 * 5)
