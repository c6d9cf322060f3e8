"""The multi-process runtime: ``torch.distributed``, one process per device.

Counterpart of ``image_enhancement_deglaring_tpu.parallel.distributed``.
Where JAX runs ``jax.distributed.initialize`` once per host and one
program over every chip, the port runs one process per GPU in a process
group: NCCL between CUDA devices, Gloo between CPU processes (the tests).

On each process of a run::

    from image_enhancement_deglaring_tpu_torch.parallel import distributed
    distributed.initialize("10.0.0.1:29500", num_processes=8, process_id=i)
    mesh = distributed.global_mesh()      # DataMesh over every rank

or under ``torchrun`` (which sets RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT) ``distributed.initialize()`` alone. Each process feeds its
slice of every batch (:class:`LocalSliceLoader`); rank 0 writes logs,
metrics and checkpoints. :func:`launch_local` starts N ranks on this
machine from one command (``cli.train`` / ``cli.evaluate --n_devices N``).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from .mesh import local_device, make_mesh

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    """NCCL for a CUDA device, Gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device="cuda") -> None:
    """Join the process group (a no-op for a single process).

    Explicit arguments (``host:port`` of rank 0, the world size, this
    rank) take all three, and any failure raises: a typo'd address must not
    leave N independent runs writing one output directory. Without them,
    torchrun's environment variables are read when present; otherwise the
    process stays alone. ``backend`` defaults to :func:`backend_for`
    ``device`` ("cuda" unless the caller asks for the CPU); nothing falls
    back to another backend. Under NCCL the rank's CUDA device becomes the
    current one first. After the group forms, one collective runs while
    every rank is in lock step."""
    explicit = [a is not None for a in (coordinator_address, num_processes, process_id)]
    if any(explicit) and not all(explicit):
        raise ValueError("initialize: pass coordinator_address, num_processes and process_id "
                         "together (or none of them, under torchrun)")
    if all(explicit):
        if dist.is_initialized():
            raise RuntimeError("initialize: the process group is already initialized")
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                    rank=int(process_id))
        rank = int(process_id)
    elif all(v in os.environ for v in _TORCHRUN_VARS):
        if dist.is_initialized():
            return
        init = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    else:
        return
    backend = backend or backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: NCCL needs a CUDA device and torch.cuda.is_available() "
                               "is False; pass device='cpu' (Gloo) to run on the CPU")
        torch.cuda.set_device(local_device(rank, device))
    dist.init_process_group(backend=backend, **init)
    # the first collective sets up the communicators: run it now, while the
    # ranks are in lock step, not later behind rank-skewed work
    warm = torch.zeros(1, device=local_device(rank, device) if backend == "nccl" else "cpu")
    dist.all_reduce(warm)


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def global_mesh(*, device=None):
    """The 1-D mesh over every rank of the group (``make_mesh``)."""
    return make_mesh(device=device)


def local_device_count(device, requested: int) -> int:
    """The devices a command may take on this machine (``--n_devices``,
    ``--data_parallel``): the cards, or on the CPU as many processes or
    replicas as ``requested``."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return max(requested, 1)


def process_batch_slice(global_batch: int) -> tuple[int, int]:
    """[start, end) of this rank's slice of a global batch."""
    n_proc = process_count()
    if global_batch % n_proc != 0:
        raise ValueError(f"process count {n_proc} must divide global batch {global_batch}")
    per = global_batch // n_proc
    i = process_index()
    return i * per, (i + 1) * per


class LocalSliceLoader:
    """Wraps a deterministic GLOBAL-batch loader; yields this rank's slice
    of every batch.

    Every rank must build an identical loader (same data directory, seed,
    batch size, split): the seeded pipeline then gives the same global
    batch order everywhere, so the slices are disjoint and cover each
    batch. A ragged final batch is cut to a multiple of the process count
    (up to ``process_count - 1`` samples); a batch with fewer rows than
    ranks is skipped.

    When the loader has ``set_batch_slice(rank, world)`` (the port's
    ``_Loader`` does) the slice is taken before decode: each rank decodes
    only its rows, and the batches are the same because the order is
    seeded per epoch and the augmentation per index. Other loaders are
    decoded in full and sliced."""

    def __init__(self, loader):
        self.loader = loader
        self._n = process_count()
        self._i = process_index()
        self._pre_sliced = hasattr(loader, "set_batch_slice")
        if self._pre_sliced:
            loader.set_batch_slice(self._i, self._n)

    def __len__(self):
        if self._pre_sliced or self._n == 1:
            return len(self.loader)
        g = int(getattr(self.loader, "batch_size", 0) or 0)
        ns = int(getattr(self.loader, "num_samples", 0) or 0)
        if not (g and ns):
            return len(self.loader)
        from ..data.dataset import sliced_batch_count

        # drop_last is inferred: a loader without the ragged tail reports
        # len == num_samples // batch_size
        return sliced_batch_count(ns, g, self._n, drop_last=len(self.loader) <= ns // g)

    @property
    def batch_size(self):
        g = int(getattr(self.loader, "batch_size", 0) or 0)
        return g // self._n if g else 0

    @property
    def num_samples(self):
        """This rank's usable sample count (global // world)."""
        g = int(getattr(self.loader, "num_samples", 0) or 0)
        return g // self._n

    @property
    def num_workers(self):
        return getattr(self.loader, "num_workers", 0)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self):
        if self._pre_sliced:
            yield from self.loader
            return
        for batch in self.loader:
            b = batch[0].shape[0]
            usable = (b // self._n) * self._n
            if usable == 0:
                continue
            per = usable // self._n
            s = self._i * per
            yield tuple(x[s:s + per] for x in batch)


def free_port() -> int:
    """A TCP port free on 127.0.0.1 at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, port: int, device: str, backend: str | None,
               args: tuple) -> None:
    initialize(f"127.0.0.1:{port}", world, rank, backend=backend, device=device)
    try:
        fn(*args)
    finally:
        shutdown()


def launch_local(fn, world: int, *args, device="cuda", backend: str | None = None) -> None:
    """Run ``fn(*args)`` in ``world`` new processes on this machine, rank
    ``r`` on ``cuda:r`` (or the CPU), joined in one process group over a
    free local port; returns when every rank has finished and raises if one
    failed. ``fn`` must be importable by name (``torch.multiprocessing``
    spawns fresh interpreters)."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(fn, world, free_port(), str(device), backend, args),
             nprocs=world, join=True)
