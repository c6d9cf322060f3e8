"""Batched inference engine on one CUDA device.

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

The uint8 output truncates (floor of x*255), as the reference does.

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

import copy
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from .._device import resolve_device
from ..modelio.params_import import load_jax_params
from ..models.model_utils import dequantize_params_int8, quantize_params_int8
from ..utils.pytree import flatten_tree


def _bucket_sizes(max_batch: int) -> list[int]:
    sizes = [1]
    while sizes[-1] < max_batch:
        sizes.append(min(sizes[-1] * 2, max_batch))
    return sizes


def _int8_weights(model: torch.nn.Module) -> tuple:
    """(model, int8 tree, scales tree): the model's parameters as the JAX
    package's nested tree ({"enc1": {"conv1": ...}}), quantized per output
    channel."""
    tree: dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach()
    return (model, *quantize_params_int8(tree, per_channel=True))


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, *, image_size: int = 512,
                 max_batch_size: int = 8, batch_timeout_ms: float = 3.0,
                 compute_dtype: torch.dtype = torch.bfloat16, warmup: bool = True,
                 mesh=None, quantize: str | None = None, pipeline_depth: int = 4,
                 device="cuda"):
        """``model`` maps NHWC float (B, S, S, 1) to (B, S, S, 1); it is moved
        to ``device`` and put in eval mode. ``device`` defaults to CUDA and
        raises without a card unless "cpu" is passed. ``quantize``: None or
        "int8" (see the module docstring). ``mesh`` (multi-GPU serving) is a
        later part of the port (ROADMAP.md Queue 1 item 13)."""
        if mesh is not None:
            raise NotImplementedError(
                "multi-device serving (mesh=) is not ported yet (ROADMAP.md Queue 1 item 13)")
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        self.device = resolve_device(device)
        self.quantize = quantize
        self._model = model.to(self.device).eval()
        # (model, int8 tree, scales tree), swapped whole by reload_params
        self._int8 = _int8_weights(self._model) if quantize else None
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
        if warmup:
            self.warmup()

    def reload_params(self, params) -> None:
        """Weight swap from the JAX package's parameter tree (float32 numpy
        arrays of the running model's shapes). The new weights go into a
        copy of the model that replaces the old one in one attribute
        rebind: batches launched before it finish on the old weights. An
        int8 engine quantizes the new weights again."""
        new = copy.deepcopy(self._model)
        load_jax_params(new, params)
        if self.quantize:
            self._int8 = _int8_weights(new)
        self._model = new

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
        for s in _bucket_sizes(self.max_batch_size):
            if s >= b:
                return s
        return b

    # ---------------------------------------------------------------- device
    def _step(self, batch_u8: np.ndarray) -> torch.Tensor:
        """uint8 (B, S, S, 1) -> uint8 (B, S, S, 1) on the device, launched
        asynchronously; the caller's copy to the host waits for it."""
        # read once: a concurrent reload swaps it whole
        int8 = self._int8
        model = self._model if int8 is None else int8[0]
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device, non_blocking=True)
        with torch.inference_mode():
            x = x.to(self.compute_dtype) / 255.0
            if int8 is None:
                out = model(x).float()
            else:
                weights = {name.replace("/", "."): w for name, w in
                           flatten_tree(dequantize_params_int8(int8[1], int8[2])).items()}
                out = torch.func.functional_call(model, weights, (x,)).float()
            y = torch.floor(out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        with self._stats_lock:
            self._batches += 1
        return y

    def warmup(self) -> None:
        """Run every batch bucket once, so that the kernels are built and the
        allocator holds the buffers before the first request."""
        s = self.image_size
        for b in sorted({self._bucket_for(b) for b in _bucket_sizes(self.max_batch_size)}):
            self._step(np.zeros((b, s, s, 1), np.uint8)).cpu()

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
        out = self._step(batch_u8).cpu().numpy()[:b]
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
                deadline = time.monotonic() + self.batch_timeout_s
                while len(batch) < self.max_batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(req_queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                try:
                    imgs = np.stack([r[0] for r in batch])[..., None]
                    b = imgs.shape[0]
                    bucket = self._bucket_for(b)
                    if bucket > b:
                        pad = np.zeros((bucket - b,) + imgs.shape[1:], np.uint8)
                        imgs = np.concatenate([imgs, pad])
                    y = self._step(imgs)
                    inflight.put((batch, y, b))  # blocks at pipeline_depth
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
            batch, y, b = item
            try:
                outs = y.cpu().numpy()[:b, ..., 0]
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
