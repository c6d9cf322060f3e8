"""Training from a dataset held in device memory.

Counterpart of ``image_enhancement_deglaring_tpu.train.resident``. The
decoded set goes to the device once; each epoch then draws its batch plan
(a permutation) on the device, gathers every batch from the resident
tensors with ``index_select``, optionally augments it there, and runs the
same step body as the per-step path (``loop.make_step_body``). The host's
work per epoch is the launches and one stacked loss fetch per segment:
nothing waits for the device inside a segment.

Where the JAX package compiles a ``lax.scan`` over the plan, the port
runs an eager loop over the plan's rows; the steps and their order are the
same, so the resident path equals the per-step path on the same batch
sequence and generator stream.

Capacity: SD1 at full scale (1,536 pairs at 512^2, bf16 inputs and f32
targets) is 1,536 * 512^2 * 6 B = 2.25 GiB, about 3 % of an 80 GB card.
``cache_on_device`` refuses a cache above half of the device's memory.

Over several ranks (``mesh=``) every rank holds the whole cache, decoded
from the global loader: 2.25 GiB per device at SD1 scale, where JAX's
sharded cache holds 1/D of it per chip. Every rank draws the same plan
from (seed, epoch) and takes its rows ``[r * per, (r + 1) * per)`` of each
planned batch, the rows JAX's sharded batch puts on its devices, so the
global batches are JAX's and no rank gathers from another.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..utils.profiling import span
from .loop import make_step_body, make_val_body, val_row


class ResidentData(NamedTuple):
    """A dataset in device memory: ``x``/``y`` (N, H, W, C) tensors and
    ``n`` = N real samples."""

    x: torch.Tensor
    y: torch.Tensor
    n: int


def device_memory_bytes(device) -> int:
    """The memory of a CUDA device (``total_memory``). A CPU has no device
    memory of its own: callers pass its budget explicitly."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no device memory to read on {dev}: pass device_bytes explicitly")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def fits_on_device_bytes(n_bytes: int, *, device_bytes: int, fraction: float = 0.5) -> bool:
    """Whether ``n_bytes`` of cache fit in ``fraction`` of ``device_bytes``."""
    return n_bytes <= fraction * device_bytes


def fits_on_device(n: int, image_size: int, channels: int = 1, *,
                   dtype: torch.dtype = torch.bfloat16, device_bytes: int,
                   fraction: float = 0.5) -> bool:
    """Whether an (input, target) cache of ``n`` samples, both in ``dtype``,
    fits in ``fraction`` of ``device_bytes``."""
    per = torch.empty((), dtype=dtype).element_size()
    need = 2 * n * image_size * image_size * channels * per
    return fits_on_device_bytes(need, device_bytes=device_bytes, fraction=fraction)


def _iterate_all(source) -> tuple[np.ndarray, np.ndarray]:
    """Drain a batch loader once into stacked host arrays."""
    xs, ys = [], []
    for bx, by in source:
        xs.append(np.asarray(bx))
        ys.append(np.asarray(by))
    if not xs:
        raise ValueError("cache_on_device: empty data source")
    return np.concatenate(xs), np.concatenate(ys)


def cache_on_device(source, *, dtype: torch.dtype | None = None, sharding=None,
                    num_workers: int = 8, device="cuda",
                    device_bytes: int | None = None) -> ResidentData:
    """Decode a dataset on the host once and copy it to ``device``.

    ``source``: an indexable dataset (``__len__``/``__getitem__`` -> (x, y)
    HWC float arrays), decoded by ``num_workers`` threads, or a batch loader,
    iterated once. A source that augments on the host is refused: the cache
    would freeze one draw; build it with ``augment="none"`` and augment on
    the device. ``dtype`` casts the input cache only (bf16 when the model's
    first op is that cast); targets stay float32. The cache must fit in half
    of ``device_bytes``, by default the CUDA device's own memory (a CPU
    device needs the argument). Over several ranks ``source`` is the global
    loader and each rank caches all of it (the module docstring), so the
    check counts the whole cache on every device; ``sharding=`` (JAX's
    sharded cache) raises."""
    if sharding is not None:
        raise ValueError("cache_on_device(sharding=): every rank of the port caches the whole "
                         "set on its own device (train_model(mesh=)); pass no sharding")
    dev = resolve_device(device)
    ds = getattr(source, "dataset", source)
    if getattr(ds, "augment", "none") != "none":
        raise ValueError(f"cache_on_device: the data source applies host augmentations "
                         f"({ds.augment!r}); caching would freeze one random draw. Build it "
                         "with augment='none' and use device augmentation.")
    if hasattr(ds, "__getitem__") and hasattr(ds, "__len__"):
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
            samples = list(pool.map(ds.__getitem__, range(len(ds))))
        if not samples:
            raise ValueError("cache_on_device: empty data source")
        x = np.stack([s[0] for s in samples])
        y = np.stack([s[1] for s in samples])
    else:
        x, y = _iterate_all(source)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    yt = torch.from_numpy(np.ascontiguousarray(y, np.float32))
    if dtype is not None:
        xt = xt.to(dtype)
    need = xt.numel() * xt.element_size() + yt.numel() * yt.element_size()
    budget = device_bytes if device_bytes is not None else device_memory_bytes(dev)
    if not fits_on_device_bytes(need, device_bytes=budget):
        raise ValueError(f"cache_on_device: the resident cache needs {need / 2**30:.2f} GiB, "
                         f"more than half of the device's {budget / 2**30:.2f} GiB. Use the "
                         "streaming loader path (drop --resident_data).")
    return ResidentData(xt.to(dev), yt.to(dev), int(xt.shape[0]))


def _plan_seed(seed: int, epoch: int) -> int:
    """One 63-bit generator seed from (seed, epoch)."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0] >> 1)


def epoch_batch_plan(seed: int, epoch: int, n_real: int, batch_size: int, *,
                     shuffle: bool = True, device="cuda") -> torch.Tensor:
    """The epoch's batches as a (steps, bs) index tensor on ``device``: a
    permutation of ``[0, n_real)`` drawn from a device generator seeded from
    (seed, epoch) alone, cut into ``n_real // bs`` rows, where ``bs`` is
    ``batch_size`` clamped to the set (a tiny set trains one short step
    instead of none). ``shuffle=False`` takes the samples in order."""
    dev = torch.device(device)
    bs = min(batch_size, n_real)
    steps = n_real // bs
    if shuffle:
        gen = torch.Generator(device=dev).manual_seed(_plan_seed(seed, epoch))
        perm = torch.randperm(n_real, generator=gen, device=dev)
    else:
        perm = torch.arange(n_real, device=dev)
    return perm[: steps * bs].reshape(steps, bs)


def _rank_columns(a: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of axis 1 (the batch axis of a plan or of batched
    val tensors): ``[r * per, (r + 1) * per)``."""
    if mesh is None or mesh.world == 1:
        return a
    per = a.shape[1] // mesh.world
    return a[:, mesh.rank * per:(mesh.rank + 1) * per]


def _make_segment_fn(body, mesh=None):
    """The one gather-and-step loop both epoch shapes share: each row of
    ``idx`` gathers its batch (under ``mesh``, this rank's part of it) from
    the resident tensors and runs ``body``; the losses stay on the device,
    stacked. Each gather is a ``train.gather`` span while a profiler
    session runs."""

    def segment(state, x, y, idx):
        losses = []
        for row in _rank_columns(idx, mesh):  # a device tensor's rows: no host sync
            with span("train.gather"):
                xb, yb = x.index_select(0, row), y.index_select(0, row)
            state, loss = body(state, xb, yb)
            losses.append(loss)
        return state, torch.stack(losses)

    return segment


def make_train_epoch(*, batch_size: int, stateful: bool = False, augment_fn=None,
                     shuffle: bool = True, mesh=None):
    """``train_epoch(state, x, y, seed, epoch, n_real) -> (state, losses)``:
    one epoch over the resident tensors, ``losses`` shaped (steps,) on the
    device (under ``mesh``, this rank's). ``shuffle=False`` runs the samples
    in order (the parity checks against the per-step loop)."""
    segment = _make_segment_fn(make_step_body(stateful=stateful, augment_fn=augment_fn,
                                              mesh=mesh), mesh)

    def train_epoch(state, x, y, seed: int, epoch: int, n_real: int):
        idx = epoch_batch_plan(seed, epoch, n_real, batch_size, shuffle=shuffle,
                               device=x.device)
        return segment(state, x, y, idx)

    return train_epoch


def make_train_epoch_segmented(*, batch_size: int, stateful: bool = False, augment_fn=None,
                               shuffle: bool = True, mesh=None):
    """``(plan, segment)``: ``plan(seed, epoch, n_real, device)`` is the
    epoch's batch plan (:func:`epoch_batch_plan`) and ``segment(state, x,
    y, idx_block) -> (state, losses)`` trains the rows of a slice of it.
    Segments run back to back take the steps of one whole epoch, so the
    caller can check for preemption between them; a mid-epoch checkpoint at
    a segment boundary resumes by slicing the same plan from there. Under
    ``mesh`` each rank trains its rows of every planned batch."""
    segment = _make_segment_fn(make_step_body(stateful=stateful, augment_fn=augment_fn,
                                              mesh=mesh), mesh)

    def plan(seed: int, epoch: int, n_real: int, device="cuda"):
        return epoch_batch_plan(seed, epoch, n_real, batch_size, shuffle=shuffle,
                                device=device)

    return plan, segment


def batch_val_cache(data: ResidentData, batch_size: int, mesh=None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A resident validation cache as (xb, yb, masks): (VB, batch_size, H,
    W, C) batches padded with zero rows, and (VB, batch_size) masks that
    are 1.0 on the real samples, the resident form of the padded loader.
    Under ``mesh`` each is this rank's block of the batch axis."""
    n = data.n
    vb = max(1, -(-n // batch_size))
    total = vb * batch_size

    def rebatch(a):
        if total > a.shape[0]:
            a = torch.cat([a, a.new_zeros((total - a.shape[0],) + tuple(a.shape[1:]))])
        return a[:total].reshape((vb, batch_size) + tuple(a.shape[1:]))

    mask = (torch.arange(total, device=data.x.device) < n).float().reshape(vb, batch_size)
    return tuple(_rank_columns(a, mesh) for a in (rebatch(data.x), rebatch(data.y), mask))


def make_val_epoch(metric_subset: int = 4, *, with_metrics: bool = True, mesh=None):
    """``val_epoch(model, xb, yb, masks) -> (VB, 4)``: the validation body
    over every batch of :func:`batch_val_cache`, rows of [masked L1, subset
    PSNR, subset SSIM, real-sample count] stacked on the device for one
    fetch; under ``mesh`` (VB, 5) rows of this rank's (``loop.val_row``,
    for ``loop.global_val_rows``)."""
    body = make_val_body(metric_subset, with_metrics=with_metrics, mesh=mesh)

    def val_epoch(model, xb, yb, masks):
        rows = []
        for x, y, m in zip(xb, yb, masks):
            loss, psnr, ssim, _ = body(model, x, y, m)
            rows.append(val_row(loss, psnr, ssim, m, metric_subset, mesh))
        return torch.stack(rows)

    return val_epoch
