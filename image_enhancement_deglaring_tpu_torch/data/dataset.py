"""Dataset, loaders and the device prefetcher.

Counterpart of ``image_enhancement_deglaring_tpu.data.dataset``: host
threads decode and augment (optional RAM cache), batches are NHWC numpy
arrays with a per-epoch seeded order and per-index augmentation seeds, so
both packages yield the same batches; ``DevicePrefetcher`` decodes ahead
on a background thread and copies each batch to the device on a side
stream while the current step computes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .augment import heavy_augment, optimized_augment
from .pipeline import decode_triptych, list_image_paths, seeded_split


class GlareRemovalDataset:
    """SD1 triptych dataset with optional in-memory cache and deterministic
    per-index augmentation."""

    def __init__(self, image_paths: list[str], *, image_size: int = 512,
                 seed: int | None = None, augment: str = "none",
                 cache_images: bool = False, num_workers: int = 8):
        if augment not in ("none", "optimized", "heavy"):
            raise ValueError(f"augment must be 'none', 'optimized' or 'heavy', got {augment!r}")
        self.image_paths = sorted(image_paths)
        self.image_size = image_size
        self.seed = seed
        self.augment = augment
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if cache_images:
            with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
                for i, pair in enumerate(
                    pool.map(lambda p: decode_triptych(p, image_size), self.image_paths)
                ):
                    self._cache[i] = pair

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (glared, ground_truth) as (H, W, 1) float32 arrays."""
        if index in self._cache:
            glared, gt = self._cache[index]
        else:
            glared, gt = decode_triptych(self.image_paths[index], self.image_size)
        if self.augment != "none":
            rng = np.random.default_rng(self.seed + index if self.seed is not None else None)
            fn = optimized_augment if self.augment == "optimized" else heavy_augment
            glared, gt = fn(glared, gt, rng)
        return glared[..., None], gt[..., None]


def sliced_batch_count(num_samples: int, batch_size: int, world: int,
                       drop_last: bool) -> int:
    """Number of batches a ``world``-way sliced iteration yields: a batch
    with fewer rows than ``world`` is skipped, and a ragged tail survives
    only with >= ``world`` rows. ``_Loader.set_batch_slice`` and
    ``parallel.distributed.LocalSliceLoader`` both count by it."""
    nb_full, tail = divmod(num_samples, batch_size)
    count = nb_full if batch_size >= world else 0
    if not drop_last and tail >= world:
        count += 1
    return count


class _Loader:
    """Epoch iterator yielding NHWC numpy batches (x, y)."""

    def __init__(self, dataset: GlareRemovalDataset, batch_size: int, *,
                 shuffle: bool, drop_last: bool, seed: int | None,
                 num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self._epoch = 0
        self._batch_slice: tuple[int, int] | None = None
        self._skip_batches = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self._batch_slice is not None:
            # mirrors _iter_batches' skip of sub-world batches
            count = sliced_batch_count(n, self.batch_size, self._batch_slice[1], self.drop_last)
        else:
            nb_full, tail = divmod(n, self.batch_size)
            count = nb_full if self.drop_last else nb_full + (1 if tail else 0)
        return max(0, count - self._skip_batches)

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def set_skip_batches(self, k: int) -> None:
        """Skip the first ``k`` batches of the next iterations without
        decoding them (mid-epoch resume). The order is per-epoch seeded and
        the augmentation seeds per index, so this yields what
        iterate-and-discard would. ``__len__`` returns the reduced count;
        ``__iter__`` walks the full plan and drops the first ``k`` yields.
        Persists until ``set_skip_batches(0)``."""
        if k < 0:
            raise ValueError(f"skip_batches must be >= 0, got {k}")
        self._skip_batches = k

    def set_batch_slice(self, rank: int, world: int) -> None:
        """Decode only rows ``[rank * per, (rank + 1) * per)`` of every batch,
        ``per = len(batch) // world`` (``parallel.distributed.
        LocalSliceLoader``). The rows equal those of the decoded global batch
        sliced, since the order is seeded per epoch and the augmentation per
        index; a ragged final batch is cut to a multiple of ``world`` first,
        and a batch of fewer than ``world`` rows is skipped."""
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside world {world}")
        self._batch_slice = (rank, world)

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(None if self.seed is None else self.seed + self._epoch)
            rng.shuffle(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        order = order[:limit]
        # num_workers=0: decode synchronously in this thread
        if self.num_workers > 0:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                yield from self._iter_batches(order, pool.map)
        else:
            yield from self._iter_batches(order, map)

    def _iter_batches(self, order, mapper):
        skip = self._skip_batches
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self._batch_slice is not None:
                rank, world = self._batch_slice
                per = len(idx) // world
                if per == 0:
                    continue
                idx = idx[rank * per : (rank + 1) * per]
            if skip > 0:  # counted in yielded batches, after the slice's skips
                skip -= 1
                continue
            samples = list(mapper(self.dataset.__getitem__, idx))
            yield np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples])


class DevicePrefetcher:
    """Wraps a loader of numpy tuples: a background thread decodes ahead and
    yields each batch as tensors on ``device``.

    On a CUDA device each batch goes into pinned host memory and is copied
    with ``non_blocking`` copies on a side stream; the consumer's current
    stream waits for that copy before it uses the batch, so step N+1's
    copy overlaps step N. ``input_dtype`` casts the input (the first
    element) on the host, bf16 halving its bytes; the other elements stay
    as they are (the target stays float32)."""

    _clamp_noted = False  # class-level: the train loop builds one per epoch

    def __init__(self, loader, *, device, prefetch: int = 2,
                 input_dtype: torch.dtype | None = None):
        self.loader = loader
        self.device = torch.device(device)
        if prefetch < 1 and not DevicePrefetcher._clamp_noted:
            DevicePrefetcher._clamp_noted = True
            print(f"DevicePrefetcher: prefetch={prefetch} clamped to 1 (depth 1 is the "
                  "minimum pipeline)")
        self.prefetch = max(1, prefetch)
        self.input_dtype = input_dtype

    def __len__(self):
        return len(self.loader)

    def _host(self, batch) -> list[torch.Tensor]:
        out = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
        if self.input_dtype is not None:
            out[0] = out[0].to(self.input_dtype)
        return out

    def __iter__(self):
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: list[BaseException] = []

        def worker():
            try:
                for batch in self.loader:
                    host = self._host(batch)
                    if cuda:
                        with torch.cuda.device(self.device), torch.cuda.stream(side):
                            dev = [t.pin_memory().to(self.device, non_blocking=True)
                                   for t in host]
                            ready = torch.cuda.Event()
                            ready.record(side)
                        item = (dev, ready)
                    else:
                        item = (host, None)
                    # bounded put with a stop check: a consumer that abandons
                    # the iteration must not leave this thread blocked
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                while True:
                    try:
                        q.put(sentinel, timeout=0.2)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                tensors, ready = item
                if ready is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(ready)
                    for x in tensors:  # allocated on the side stream, used on this one
                        x.record_stream(compute)
                yield tuple(tensors)
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
        if error:
            raise error[0]


def make_dataloaders(data_dir: str, *, batch_size: int = 32, val_split: float = 0.2,
                     seed: int | None = 42, image_size: int = 512,
                     cache_images: bool = False, num_workers: int = 8,
                     augment: str = "optimized"):
    """Train/val loaders with the reference's split semantics: the train
    loader shuffles per epoch and drops the last partial batch, the val
    loader keeps order and its ragged tail."""
    paths = list_image_paths(data_dir)
    if not paths:
        raise ValueError(f"No images found in {data_dir}")
    train_paths, val_paths = seeded_split(paths, val_split, seed)
    train_ds = GlareRemovalDataset(train_paths, image_size=image_size, seed=seed,
                                   augment=augment, cache_images=cache_images,
                                   num_workers=num_workers)
    val_ds = GlareRemovalDataset(val_paths, image_size=image_size, seed=seed, augment="none",
                                 cache_images=cache_images, num_workers=num_workers)
    if len(train_ds) < batch_size:
        # drop_last would give zero training steps per epoch
        raise ValueError(
            f"train split has {len(train_ds)} images but batch_size is "
            f"{batch_size}; drop_last training would run zero steps per "
            "epoch. Lower --batch_size or provide more data.")
    train_loader = _Loader(train_ds, batch_size, shuffle=True, drop_last=True, seed=seed,
                           num_workers=num_workers)
    val_loader = _Loader(val_ds, batch_size, shuffle=False, drop_last=False, seed=seed,
                         num_workers=max(2, num_workers // 2) if num_workers > 0 else 0)
    return train_loader, val_loader


def make_eval_loader(data_dir: str, *, batch_size: int = 16, image_size: int = 512,
                     seed: int | None = 42, num_workers: int = 8, cache_images: bool = False):
    """Evaluation-only loader over EVERY image under ``data_dir``: no split,
    no shuffle, no augmentation, the ragged final batch kept."""
    paths = list_image_paths(data_dir)
    if not paths:
        raise ValueError(f"No images found in {data_dir}")
    ds = GlareRemovalDataset(paths, image_size=image_size, seed=seed, augment="none",
                             cache_images=cache_images, num_workers=num_workers)
    return _Loader(ds, batch_size, shuffle=False, drop_last=False, seed=seed,
                   num_workers=num_workers)
