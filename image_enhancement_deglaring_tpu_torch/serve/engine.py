"""Batched inference engine on one CUDA device, or over the local cards.

PyTorch counterpart of ``image_enhancement_deglaring_tpu.serve.engine``
with the same public surface (``submit``, ``infer_batch``, ``infer_one``,
``stats``, ``reload_params``, ``start``/``stop``, ``warmup``):

- requests enqueue uint8 (S, S) grayscale frames;
- a collector thread drains the queue up to ``max_batch_size`` or until
  ``batch_timeout_ms`` passes, pads to the next power-of-two bucket and
  launches one device step: uint8 -> /255 in the compute dtype -> U-Net ->
  float32 -> clip to [0, 1] -> x255 -> floor -> uint8;
- launches are asynchronous, so the collector keeps up to
  ``pipeline_depth`` batches in flight; a drainer thread copies each result
  to the host (the synchronisation point) and resolves the futures.

While a ``torch.profiler`` session runs, both threads record spans
(``utils.profiling.span``), the batch's sequence number in ``batch``:
``engine.form`` (from the first request's dequeue to the padded array;
``rows``, ``bucket``, and the requests' waits since ``submit`` in
``wait_ms_sum`` / ``wait_ms_max``), ``engine.step`` (the ``_step`` call)
with ``engine.step.copy_in`` and ``engine.step.launch`` for each replica
(``replica``), ``engine.backpressure`` (the collector blocked at
``pipeline_depth``), ``engine.fetch.wait`` (on CUDA events recorded after
each replica's work, only while a session runs), ``engine.fetch.copy``
(the ``_fetch`` call) and ``engine.resolve``.

The uint8 output truncates (floor of x*255), as the reference does.

``mesh=`` (a ``parallel.mesh.LocalMesh``) serves over several devices of
this process, as the JAX engine serves over a 1-D mesh of the local
chips: one model replica per device, each batch bucket a multiple of the
mesh size, its rows split into equal slices, slice ``i`` copied to and run
on device ``i``; the drainer joins the slices in row order. Every copy and
launch names its replica's device.

``quantize="int8"`` serves int8 weights: the model's rank >= 2 parameters
are quantized per output channel once (``models.model_utils.
quantize_params_int8``) and kept on the device as int8 tensors with
float32 scales; each step widens them to float32
(``dequantize_params_int8``) and runs the model on them through
``torch.func.functional_call``, which then casts them to the compute dtype
as it casts its own parameters (the JAX engine's
``dequantize_params_int8(..., dtype=float32)`` inside its compiled step).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np
import torch

from ..modelio.params_import import load_jax_params
from ..models.model_utils import dequantize_params_int8, quantize_params_int8
from ..parallel.mesh import replica_devices
from ..utils.profiling import span
from ..utils.pytree import flatten_tree, unflatten_tree


def _bucket_sizes(max_batch: int) -> list[int]:
    sizes = [1]
    while sizes[-1] < max_batch:
        sizes.append(min(sizes[-1] * 2, max_batch))
    return sizes


class _Replica(NamedTuple):
    """One device's copy of the served model, and its int8 weights (model,
    int8 tree, scales tree) when the engine quantizes."""

    device: torch.device
    model: torch.nn.Module
    int8: tuple | None


def _done_events(devices) -> tuple:
    """A CUDA event recorded on each of ``devices``' current stream, after
    the work launched there so far (none on the CPU)."""
    events = []
    for device in devices:
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            events.append(event)
    return tuple(events)


def on_device(device: torch.device):
    """``device`` as the current CUDA device (launches and allocations that
    name no device land there); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def replicate_model(model: torch.nn.Module, devices: tuple) -> tuple:
    """``model`` moved to ``devices[0]`` in eval mode, and a copy of it on
    each further device (the same weights)."""
    first = model.to(devices[0]).eval()
    return (first,) + tuple(copy.deepcopy(first).to(d) for d in devices[1:])


def reloaded(models, params) -> tuple:
    """Copies of ``models`` carrying the JAX package's parameter tree
    ``params`` (float32 numpy arrays of their shapes)."""
    out = []
    for m in models:
        m = copy.deepcopy(m)
        load_jax_params(m, params)
        out.append(m)
    return tuple(out)


def _int8_weights(model: torch.nn.Module) -> tuple:
    """(model, int8 tree, scales tree): the model's parameters as the JAX
    package's nested tree ({"enc1": {"conv1": ...}}), quantized per output
    channel."""
    tree = unflatten_tree({name.replace(".", "/"): p.detach()
                           for name, p in model.named_parameters()})
    return (model, *quantize_params_int8(tree, per_channel=True))


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, *, image_size: int = 512,
                 max_batch_size: int = 8, batch_timeout_ms: float = 3.0,
                 compute_dtype: torch.dtype = torch.bfloat16, warmup: bool = True,
                 mesh=None, quantize: str | None = None, pipeline_depth: int = 4,
                 device=None):
        """``model`` maps NHWC float (B, S, S, 1) to (B, S, S, 1); it is moved
        to ``device`` and put in eval mode. ``device`` defaults to CUDA and
        raises without a card unless "cpu" is passed. ``mesh``: a
        ``parallel.mesh.LocalMesh`` whose devices take one replica each
        (the model itself on the first, copies on the others);
        ``max_batch_size`` must divide by its size. ``quantize``: None or
        "int8" (see the module docstring)."""
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        devices = replica_devices(device, mesh)
        if mesh is not None and max_batch_size % mesh.size:
            raise ValueError(f"max_batch_size {max_batch_size} must divide by mesh size "
                             f"{mesh.size}")
        self.mesh = mesh
        self.device = devices[0]
        self.quantize = quantize
        # one per device, swapped whole by reload_params
        self._replicas = self._build_replicas(replicate_model(model, devices))
        self.image_size = image_size
        self.max_batch_size = max_batch_size
        self.batch_timeout_s = batch_timeout_ms / 1e3
        self.compute_dtype = compute_dtype

        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._lifecycle = threading.Lock()
        self._worker: threading.Thread | None = None
        self.pipeline_depth = max(1, pipeline_depth)
        self._inflight: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        self._drainer: threading.Thread | None = None
        # rolling serving stats (last 1024 requests), guarded against the
        # drainer's concurrent appends
        self._stats_lock = threading.Lock()
        self._latencies: deque[float] = deque(maxlen=1024)
        self._batch_fill: deque[int] = deque(maxlen=1024)
        self._served = 0
        self._batches = 0
        self._batch_ids = itertools.count()  # the spans' batch numbers
        if warmup:
            self.warmup()

    def _build_replicas(self, models) -> tuple:
        return tuple(_Replica(next(m.parameters()).device, m,
                              _int8_weights(m) if self.quantize else None) for m in models)

    @property
    def _model(self) -> torch.nn.Module:
        """The first replica's model (the one the engine was given)."""
        return self._replicas[0].model

    @property
    def _int8(self) -> tuple | None:
        """The first replica's (model, int8 tree, scales tree), or None."""
        return self._replicas[0].int8

    def reload_params(self, params) -> None:
        """Weight swap from the JAX package's parameter tree (float32 numpy
        arrays of the running model's shapes). The new weights go into
        copies of the replicas that replace the old ones in one attribute
        rebind: batches launched before it finish on the old weights. An
        int8 engine quantizes the new weights again."""
        self._replicas = self._build_replicas(reloaded([r.model for r in self._replicas],
                                                       params))

    def stats(self) -> dict:
        """Serving observability: request latencies and batch fill."""
        with self._stats_lock:
            lat = sorted(self._latencies)
            fill = list(self._batch_fill)
            served, batches = self._served, self._batches

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))] * 1000 if lat else None

        return {
            "requests_served": served,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99),
            "mean_batch_fill": sum(fill) / len(fill) if fill else None,
            "max_batch_size": self.max_batch_size,
            "queue_depth": self._queue.qsize(),
            "inflight_batches": self._inflight.qsize(),
            # device steps launched so far, warmup and infer_batch included
            "batches_dispatched": batches,
        }

    def _bucket_for(self, b: int) -> int:
        """The power-of-two ladder up to ``max_batch_size``; on a mesh of
        ``n`` devices each rung snapped up to a multiple of ``n`` (at least
        ``n``), and a batch beyond the ladder up to one, as the JAX engine."""
        n = self.mesh.size if self.mesh is not None else 1
        sizes = sorted({max(n, -(-s // n) * n) for s in _bucket_sizes(self.max_batch_size)})
        for s in sizes:
            if s >= b:
                return s
        return -(-b // n) * n

    # ---------------------------------------------------------------- device
    def _step(self, batch_u8: np.ndarray) -> tuple:
        """uint8 (B, S, S, 1) -> one uint8 (B / n, S, S, 1) tensor per
        replica, slice ``i`` on replica ``i``'s device, launched
        asynchronously; the caller's copy to the host (:meth:`_fetch`)
        waits for them."""
        replicas = self._replicas  # read once: a concurrent reload swaps it whole
        rows = batch_u8.shape[0] // len(replicas)
        outs = []
        for i, rep in enumerate(replicas):
            with on_device(rep.device), torch.inference_mode():
                with span("engine.step.copy_in", replica=i):
                    part = np.ascontiguousarray(batch_u8[i * rows:(i + 1) * rows])
                    x = torch.from_numpy(part).to(rep.device, non_blocking=True)
                with span("engine.step.launch", replica=i):
                    x = x.to(self.compute_dtype) / 255.0
                    if rep.int8 is None:
                        out = rep.model(x).float()
                    else:
                        weights = {name.replace("/", "."): w for name, w in flatten_tree(
                            dequantize_params_int8(rep.int8[1], rep.int8[2])).items()}
                        out = torch.func.functional_call(rep.model, weights, (x,)).float()
                    outs.append(torch.floor(out.clamp(0.0, 1.0) * 255.0).to(torch.uint8))
        with self._stats_lock:
            self._batches += 1
        return tuple(outs)

    @staticmethod
    def _fetch(ys: tuple) -> np.ndarray:
        """The replicas' slices on the host, joined in row order."""
        if len(ys) == 1:
            return ys[0].cpu().numpy()
        return np.concatenate([y.cpu().numpy() for y in ys])

    def warmup(self) -> None:
        """Run every batch bucket once on every replica, so that the kernels
        are built and the allocators hold the buffers before the first
        request."""
        s = self.image_size
        for b in sorted({self._bucket_for(b) for b in _bucket_sizes(self.max_batch_size)}):
            self._fetch(self._step(np.zeros((b, s, s, 1), np.uint8)))

    # ----------------------------------------------------------------- sync
    def infer_batch(self, batch_u8: np.ndarray) -> np.ndarray:
        """Synchronous: uint8 (B,S,S) or (B,S,S,1) -> uint8 same shape."""
        squeeze = batch_u8.ndim == 3
        if squeeze:
            batch_u8 = batch_u8[..., None]
        b = batch_u8.shape[0]
        bucket = self._bucket_for(b)
        if bucket > b:
            pad = np.zeros((bucket - b,) + batch_u8.shape[1:], np.uint8)
            batch_u8 = np.concatenate([batch_u8, pad])
        out = self._fetch(self._step(batch_u8))[:b]
        return out[..., 0] if squeeze else out

    def infer_one(self, img_u8: np.ndarray) -> np.ndarray:
        """uint8 (S,S) -> uint8 (S,S)."""
        return self.infer_batch(img_u8[None])[0]

    # ---------------------------------------------------------------- async
    def start(self) -> None:
        with self._lifecycle:
            self._start_locked()

    def _start_locked(self) -> None:
        if self._worker is not None:
            return
        # a fresh Event per collector/drainer pair: a pair detached by a
        # timed-out stop() keeps its own (set) event and exits on its own
        stop = threading.Event()
        self._stop = stop
        self._worker = threading.Thread(
            target=self._collector_loop, args=(self._queue, self._inflight, stop),
            daemon=True, name="engine-collector")
        self._drainer = threading.Thread(
            target=self._drain_loop, args=(self._inflight,), daemon=True,
            name="engine-drainer")
        self._worker.start()
        self._drainer.start()

    def stop(self) -> None:
        """The collector exits first and sends the drainer its sentinel after
        its last batch; queued requests that were never batched fail."""
        with self._lifecycle:
            if self._worker is None:
                return
            self._stop.set()
            self._worker.join(timeout=10)
            self._drainer.join(timeout=10)
            detached = self._worker.is_alive() or self._drainer.is_alive()
            self._worker = None
            self._drainer = None
            if detached:
                self._queue = queue.Queue()
                self._inflight = queue.Queue(maxsize=self.pipeline_depth)

    def submit(self, img_u8: np.ndarray) -> Future:
        """Enqueue one uint8 (S,S) frame; resolves to uint8 (S,S)."""
        s = self.image_size
        if img_u8.shape == (s, s, 1):
            img_u8 = img_u8[..., 0]
        elif img_u8.shape != (s, s):
            # a wrong-shape frame would break np.stack for its whole batch
            raise ValueError(f"submit expects a ({s}, {s}) frame, got {img_u8.shape}")
        if img_u8.dtype != np.uint8:
            # a float frame would upcast and double-normalize its whole batch
            raise ValueError(f"submit expects a uint8 frame, got dtype {img_u8.dtype}")
        fut: Future = Future()
        with self._lifecycle:
            if self._worker is None:
                self._start_locked()
            self._queue.put((img_u8, fut, time.monotonic()))
        return fut

    def _collector_loop(self, req_queue: queue.Queue, inflight: queue.Queue,
                        stop: threading.Event) -> None:
        """Drains the request queue into bucketed batches and launches them
        without waiting for results; up to pipeline_depth ride at once."""
        try:
            while not stop.is_set():
                try:
                    first = req_queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                batch = [first]
                seq = next(self._batch_ids)
                try:
                    with span("engine.form", batch=seq) as sp:
                        deadline = time.monotonic() + self.batch_timeout_s
                        while len(batch) < self.max_batch_size:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            try:
                                batch.append(req_queue.get(timeout=remaining))
                            except queue.Empty:
                                break
                        imgs = np.stack([r[0] for r in batch])[..., None]
                        b = imgs.shape[0]
                        bucket = self._bucket_for(b)
                        if bucket > b:
                            pad = np.zeros((bucket - b,) + imgs.shape[1:], np.uint8)
                            imgs = np.concatenate([imgs, pad])
                        if sp:
                            now = time.monotonic()
                            waits = [now - t_enq for _i, _f, t_enq in batch]
                            sp.set(rows=b, bucket=bucket, wait_ms_sum=1e3 * sum(waits),
                                   wait_ms_max=1e3 * max(waits))
                    with span("engine.step", batch=seq) as sp:
                        y = self._step(imgs)
                        done = _done_events(r.device for r in self._replicas) if sp else ()
                    with span("engine.backpressure", batch=seq):
                        inflight.put((batch, y, b, seq, done))  # blocks at pipeline_depth
                except Exception as e:  # the loop must outlive one bad batch
                    for _, fut, _t in batch:
                        if not fut.done():
                            fut.set_exception(e)
        finally:
            while True:
                try:
                    _img, fut, _t = req_queue.get_nowait()
                except queue.Empty:
                    break
                if not fut.done():
                    fut.set_exception(RuntimeError("engine stopped"))
            inflight.put(None)

    def _drain_loop(self, inflight: queue.Queue) -> None:
        """Copies finished batches to the host and resolves their futures."""
        while True:
            item = inflight.get()
            if item is None:
                return
            batch, y, b, seq, done = item
            try:
                with span("engine.fetch.wait", batch=seq):
                    for event in done:
                        event.synchronize()
                with span("engine.fetch.copy", batch=seq):
                    outs = self._fetch(y)[:b, ..., 0]
                with span("engine.resolve", batch=seq):
                    done = time.monotonic()
                    for (_, fut, _t), out in zip(batch, outs):
                        fut.set_result(out)
                    with self._stats_lock:
                        for _, _f, t_enq in batch:
                            self._latencies.append(done - t_enq)
                        self._batch_fill.append(len(batch))
                        self._served += len(batch)
            except Exception as e:  # the loop must outlive one bad batch
                for _, fut, _t in batch:
                    if not fut.done():
                        fut.set_exception(e)
