"""Traffic into ``InferenceEngine.submit``: a closed loop of a fixed number
of outstanding requests over 512^2 uint8 glared pages made from the seed.

Traffic parameters (the mix's ``.json``):
  ``max_batch_size``   the engine's largest bucket
  ``batch_timeout_ms`` the engine's batching window
  ``outstanding``      requests kept in flight
  ``warm_s``           traffic before the window (set-up)
  ``trace_s``          the traced slice after the window (``--trace 1``)
  ``pages``            distinct pages drawn from the seed
  ``sample``           answers kept for the comparison

Every seed sends the same load; it changes the pages and their order.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import trace as tracing
from ..inputs.pages import glared_pages
from ..reference.precision import Precision, exact

GRACE_S = 60.0


class _Book:
    """Requests' send times and answers, and a seeded reservoir of answers
    of the window's requests; the engine's drainer thread calls
    :meth:`done`."""

    def __init__(self, sample: int, rng: np.random.Generator, window):
        self.sent: list[float] = []
        self.page: list[int] = []
        self.finish: dict[int, float] = {}
        self.failed: set[int] = set()
        self.sample, self.rng, self.window = sample, rng, window
        self.kept: list[tuple[int, np.ndarray]] = []
        self.seen = 0
        self.lock = threading.Lock()

    def add(self, sent: float, page: int) -> int:
        with self.lock:
            self.sent.append(sent)
            self.page.append(page)
            return len(self.sent) - 1

    def done(self, i: int, fut) -> None:
        t = time.perf_counter()
        if fut.exception() is not None:
            self.failed.add(i)
            return
        self.finish[i] = t
        if not self.window(t):
            return
        self.seen += 1
        if len(self.kept) < self.sample:
            self.kept.append((i, fut.result()))
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.sample:
                self.kept[j] = (i, fut.result())


def run(run) -> dict:
    from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine

    cfg, tr, dev = run.cfg, run.traffic, run.device
    size = cfg["image_size"]
    gen = torch.Generator(device=dev).manual_seed(run.subseed("pages"))
    glared, _ = glared_pages(gen, tr["pages"], size, dev)
    pages = glared.cpu().numpy()
    del glared
    run.mark("inputs")
    model = run.serving_model()
    eng = InferenceEngine(model, image_size=size, max_batch_size=tr["max_batch_size"],
                          batch_timeout_ms=tr["batch_timeout_ms"],
                          compute_dtype=getattr(torch, cfg["compute_dtype"]), device=dev)
    run.mark("engine_warm")
    run.patch_engine(eng)
    spans: list[int] = []  # the bucket of each _step
    host: list[tuple[str, float, float]] = []  # labelled host spans, for the trace
    if run.trace:
        step, fetch = eng._step, eng._fetch

        def timed_step(batch):
            t = time.perf_counter()
            out = step(batch)
            spans.append(batch.shape[0])
            host.append(("engine _step (host enqueue)", t, time.perf_counter()))
            return out

        def timed_fetch(ys):
            t = time.perf_counter()
            out = fetch(ys)
            host.append(("engine _fetch (copy to host)", t, time.perf_counter()))
            return out

        eng._step, eng._fetch = timed_step, timed_fetch

    order = np.random.default_rng(run.subseed("traffic")).permutation(tr["pages"])
    t_start = time.perf_counter() + 0.05
    w0 = t_start + tr["warm_s"]
    w1 = w0 + run.seconds
    book = _Book(tr["sample"], np.random.default_rng(run.subseed("sample")),
                 lambda t: w0 <= t < w1)
    stop = threading.Event()
    slots = threading.Semaphore(tr["outstanding"])

    def client():
        n = 0
        while not stop.is_set():
            if not slots.acquire(timeout=0.1):
                continue
            i = book.add(time.perf_counter(), int(order[n % len(order)]))
            fut = eng.submit(pages[book.page[i]])
            fut.add_done_callback(lambda f, i=i: book.done(i, f))
            fut.add_done_callback(lambda f: slots.release())
            n += 1

    thread = threading.Thread(target=client, name="perfbench-client", daemon=True)
    base = eng.stats()
    time.sleep(max(0.0, t_start - time.perf_counter()))
    thread.start()
    time.sleep(max(0.0, w0 - time.perf_counter()))
    run.window_opened()
    at_w0 = eng.stats()
    time.sleep(max(0.0, w1 - time.perf_counter()))
    at_w1 = eng.stats()
    if run.trace:
        with tracing.Capture(host_ops=False) as cap:
            k0, h0 = len(spans), len(host)
            time.sleep(tr["trace_s"])
        if cap.trace is not None:
            cap.trace.add_host_spans(host[h0:])
        run.set_trace(cap.trace, spans[k0:len(spans)] if cap.trace else [])
    stop.set()
    thread.join(timeout=GRACE_S)
    deadline = time.perf_counter() + GRACE_S
    while time.perf_counter() < deadline:
        pending = len(book.sent) - len(book.finish) - len(book.failed)
        if pending <= 0:
            break
        time.sleep(0.01)
    run.memory_peak()
    eng.stop()
    del eng, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    attempted = [i for i, d in enumerate(book.sent) if d < w1]
    window = {
        "window_s": w1 - w0,
        "images": sum(1 for t in book.finish.values() if w0 <= t < w1),
        "served": at_w1["requests_served"] - at_w0["requests_served"],
        "batches": at_w1["batches_dispatched"] - at_w0["batches_dispatched"],
        "warm_batches": at_w0["batches_dispatched"] - base["batches_dispatched"],
    }
    unanswered = [i for i in attempted if i not in book.finish]
    run.attempted, run.failed = len(attempted), len(unanswered)
    run.window = window
    run.checks = _compare(run, pages, book)
    return window


def _compare(run, pages: np.ndarray, book: _Book) -> dict:
    """The sampled answers against the reference's at the same pages: the
    worst image's mean gap and the largest gap, in uint8 levels; and
    whether every attempted request was answered."""
    if not book.kept:
        return {"answered_share": 0.0}
    dev = run.device
    ids = sorted(i for i, _ in book.kept)
    answers = dict(book.kept)
    uniq = sorted({book.page[i] for i in ids})
    params = run.reference_params()
    forward = run.family.reference_forward(run.cfg, Precision("f32"))
    ref: dict[int, np.ndarray] = {}
    with torch.no_grad(), exact():
        for lo in range(0, len(uniq), 16):
            block = uniq[lo:lo + 16]
            x = torch.from_numpy(pages[block]).to(dev).float()[:, None] / 255.0
            y = forward(params, x)[:, 0]
            out = torch.floor(y.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
            ref.update(zip(block, out))
    worst_mean = max_gap = 0.0
    for i in ids:
        gap = np.abs(answers[i].astype(np.int16) - ref[book.page[i]].astype(np.int16))
        worst_mean = max(worst_mean, float(gap.mean()))
        max_gap = max(max_gap, float(gap.max()))
    answered = 1.0 - run.failed / max(run.attempted, 1)
    return {"worst_image_mean_gap": worst_mean, "max_gap": max_gap,
            "answered_share": answered, "compared": len(ids)}
