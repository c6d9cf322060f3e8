"""The data-parallel mesh: one process per device in a ``torch.distributed``
process group.

Counterpart of ``image_enhancement_deglaring_tpu.parallel.mesh``. JAX's
1-D ``data`` mesh spans every chip, with parameters replicated and each
batch sharded on its leading axis; XLA inserts the gradient all-reduce.
Here each rank is a process driving one device, and a :class:`DataMesh`
names the group, this rank and its device:

- rank ``r`` of ``world`` owns rows ``[r * per, (r + 1) * per)`` of each
  global batch of ``world * per`` rows, as JAX's mesh orders devices by
  process (``parallel.distributed.process_batch_slice``);
- parameters are replicated: :func:`replicate` broadcasts rank 0's;
- the collectives the train loop, the checkpoint restore and evaluation
  need are here: sums over ranks (:func:`all_reduce_sum`, differentiable
  in :func:`all_reduce_sum_autograd`), gathers (:func:`all_gather_array`,
  :func:`fetch_replicated`) and broadcasts from rank 0
  (:func:`broadcast_bytes`, :func:`broadcast_arrays`).

NCCL moves device tensors only and Gloo gathers host tensors only, so
every gather and broadcast goes through :func:`comm_device`: the rank's
CUDA device under NCCL, the host under Gloo. Sums run on the tensor's own
device (Gloo reduces CUDA tensors through the host itself).

A ``mesh=None`` call anywhere in the port is one process on one device,
exactly as before.

Serving takes another mesh, :class:`LocalMesh`: the devices of this one
process, one model replica on each, no process group and no collective.
JAX's serving mesh spans the local chips of one process too (``cli.serve
--data_parallel`` clamps to the local device count). PyTorch launches are
asynchronous, so the engine's one collector thread feeds every card; ranks
splitting each request batch would need follower ranks in lock step and
collectives issued from the engine's and the tiler's threads at once,
which NCCL does not order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh over the default process group's ``world`` processes:
    this process is ``rank`` and drives ``device``."""

    world: int
    rank: int
    device: torch.device

    @property
    def in_group(self) -> bool:
        """Whether this process is in a process group (possibly of one)."""
        return dist.is_available() and dist.is_initialized()

    @property
    def backend(self) -> str:
        return dist.get_backend() if self.in_group else "none"


class Sharding(NamedTuple):
    """JAX's name for how an array lies on a mesh: here, its leading (batch)
    axis split over the ranks."""

    mesh: DataMesh


def local_device(rank: int, device=None) -> torch.device:
    """The device a rank drives: ``device`` if it names an index or is the
    CPU, else ``cuda:LOCAL_RANK`` (torchrun's variable), else
    ``cuda:rank % device_count``. Ranks beyond the card count share cards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def make_mesh(n_devices: int | None = None, *, device=None) -> DataMesh:
    """The 1-D mesh over every rank of the process group (after
    ``parallel.distributed.initialize``), or over this process alone.
    ``n_devices`` must be None or the group's size: a rank drives one
    device, so a mesh over fewer ranks would need a subgroup. ``device``:
    this rank's device, through :func:`local_device`; by default CUDA,
    or the CPU in a Gloo group (pass ``device="cuda"`` for Gloo ranks on
    cards)."""
    in_group = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if in_group else 1
    rank = dist.get_rank() if in_group else 0
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the port's mesh spans the process group, "
                         f"here {world} process(es), one device each")
    if device is None:
        device = "cpu" if in_group and dist.get_backend() == "gloo" else "cuda"
    return DataMesh(world, rank, local_device(rank, device))


def run_device(device, mesh: DataMesh | None) -> torch.device:
    """The device an entry point runs on: ``device`` (default CUDA, which
    raises without a card) alone, or ``mesh``'s, which owns the choice: a
    ``device`` that names another one raises."""
    from .._device import resolve_device

    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
            raise ValueError(f"device={want} disagrees with the mesh's device {mesh.device}; "
                             "the mesh owns the device: pass one or the other")
    return resolve_device(mesh.device)


@dataclass(frozen=True)
class LocalMesh:
    """Devices of this process that serving splits each batch over, in
    order: slice ``i`` of a batch runs on ``devices[i]``. A device may
    repeat (two replicas on one card: the split's cost, without the
    scaling). Not a process group: nothing here is a collective, unlike
    :class:`DataMesh` (see the module docstring for why)."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs or len({d.type for d in devs}) != 1:
            raise ValueError(f"LocalMesh needs one or more devices of one type, got {devs}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_local_mesh(n: int, *, device="cuda") -> LocalMesh:
    """``cuda:0 ... cuda:n-1`` (raises when ``n`` exceeds the card count),
    or with ``device="cpu"`` ``n`` replicas on the CPU."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"make_local_mesh({n}): need at least one device")
    if dev.type == "cpu":
        return LocalMesh((dev,) * n)
    have = torch.cuda.device_count()
    if dev.type != "cuda" or n > have:
        raise ValueError(f"make_local_mesh({n}, device={device!r}): {have} CUDA device(s) here")
    return LocalMesh(tuple(torch.device("cuda", i) for i in range(n)))


def replica_devices(device, mesh: LocalMesh | None) -> tuple[torch.device, ...]:
    """The devices a serving entry point runs its replicas on: ``device``
    alone (default CUDA, which raises without a card), or ``mesh``'s, which
    own the choice: a ``device`` of another type, or naming a device the
    mesh lacks, raises."""
    from .._device import resolve_device

    if mesh is None:
        return (resolve_device("cuda" if device is None else device),)
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.devices[0].type or (want.index is not None
                                                  and want not in mesh.devices):
            raise ValueError(f"device={want} disagrees with the mesh's devices {mesh.devices}; "
                             "the mesh owns the devices: pass one or the other")
    return tuple(resolve_device(d) for d in mesh.devices)


def batch_sharding(mesh: DataMesh) -> Sharding:
    """The leading (batch) axis split over the ranks."""
    return Sharding(mesh)


def comm_device(mesh: DataMesh) -> torch.device:
    """Where gathers and broadcasts run: the rank's device under NCCL, the
    host otherwise."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks, in place, on every rank
    alike; a collective whenever the process is in a group, one rank
    included."""
    if mesh.in_group:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward sums the gradients over the
    ranks: each rank's loss depends on every rank's input through it."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(t.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(), ctx.mesh), None


def all_reduce_sum_autograd(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """:func:`all_reduce_sum` out of place, differentiable (BatchNorm's
    statistics over the global batch)."""
    return _AllReduceSum.apply(t, mesh) if mesh.world > 1 else t


def all_reduce_max(flag: float, mesh: DataMesh) -> float:
    """The largest of one number per rank, on every rank."""
    if mesh.world == 1:
        return float(flag)
    t = torch.tensor([float(flag)], dtype=torch.float64, device=comm_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def all_gather_array(a: np.ndarray, mesh: DataMesh) -> np.ndarray:
    """(world, *a.shape): every rank's ``a`` (same shape and dtype on each),
    stacked in rank order, on every rank."""
    a = np.ascontiguousarray(a)
    if mesh.world == 1:
        return a[None]
    t = torch.from_numpy(a).to(comm_device(mesh))
    out = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def all_gather_rows(t: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """Every rank's ``t`` (same shape and dtype on each) concatenated on the
    leading axis in rank order, on ``t``'s device, on every rank. One
    process: ``t``."""
    if mesh is None or mesh.world == 1:
        return t
    src = t.detach().to(comm_device(mesh)).contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(out, src)
    return torch.cat(out).to(t.device)


def broadcast_from(t: torch.Tensor, src: int, mesh: DataMesh) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, on ``t``'s device; the others pass
    a tensor of its shape and dtype, which is left as it was."""
    if mesh.world == 1:
        return t
    buf = t.detach().to(comm_device(mesh)).clone().contiguous()
    dist.broadcast(buf, src=src)
    return buf.to(t.device)


def broadcast_bytes(payload: bytes | None, mesh: DataMesh) -> bytes:
    """Rank 0's ``payload`` on every rank (the others pass None): its
    length first, so every rank sizes the same buffer."""
    if mesh.world == 1:
        return payload or b""
    dev = comm_device(mesh)
    n = torch.tensor([len(payload) if mesh.rank == 0 else 0], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=0)
    buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
           if mesh.rank == 0 and int(n.item()) else
           torch.zeros(int(n.item()), dtype=torch.uint8, device=dev))
    if buf.numel():
        dist.broadcast(buf, src=0)
    return bytes(buf.cpu().numpy())


def broadcast_arrays(arrays: list | None, templates: list, mesh: DataMesh) -> list[np.ndarray]:
    """Rank 0's ``arrays`` on every rank, leaf by leaf, each cast to its
    template's dtype and shape (the others pass None and receive into the
    templates' shapes)."""
    out = []
    for i, tmpl in enumerate(templates):
        tmpl = np.asarray(tmpl)
        src = np.asarray(arrays[i]).astype(tmpl.dtype) if mesh.rank == 0 else np.zeros_like(tmpl)
        if mesh.world > 1:
            t = torch.from_numpy(np.ascontiguousarray(src)).to(comm_device(mesh))
            dist.broadcast(t, src=0)
            src = t.cpu().numpy()
        out.append(src)
    return out


def replicate(module_or_tree, mesh: DataMesh):
    """Rank 0's values on every rank: a module's parameters and buffers are
    overwritten in place, a tree of tensors or arrays is returned anew."""
    if isinstance(module_or_tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(module_or_tree.parameters()) + list(module_or_tree.buffers()):
                t.copy_(torch.from_numpy(broadcast_arrays(
                    [t.detach().cpu().numpy()], [t.detach().cpu().numpy()], mesh)[0]))
        return module_or_tree
    if isinstance(module_or_tree, dict):
        return {k: replicate(v, mesh) for k, v in module_or_tree.items()}
    a = np.asarray(module_or_tree.cpu() if isinstance(module_or_tree, torch.Tensor)
                   else module_or_tree)
    return broadcast_arrays([a], [a], mesh)[0]


def put_from_full(x, sharding: Sharding) -> torch.Tensor:
    """An array every rank holds in full, placed on the mesh: this rank's
    rows, on its device."""
    mesh = sharding.mesh
    x = torch.as_tensor(np.ascontiguousarray(x))
    if mesh.world > 1:
        if x.shape[0] % mesh.world:
            raise ValueError(f"leading axis {x.shape[0]} not divisible by {mesh.world} ranks")
        per = x.shape[0] // mesh.world
        x = x[mesh.rank * per:(mesh.rank + 1) * per]
    return x.to(mesh.device)


def fetch_replicated(t, mesh: DataMesh | None = None) -> np.ndarray:
    """The whole batch-sharded array as numpy on every rank: each rank's
    rows gathered in rank order (one all-gather). One process: a fetch."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if mesh is None or mesh.world == 1:
        return a
    g = all_gather_array(a, mesh)
    return g.reshape((-1,) + g.shape[2:])
