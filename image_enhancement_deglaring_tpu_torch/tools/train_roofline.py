"""Training-step roofline: ms per bf16 step of the production U-Net at
several batch sizes, split into floors.

    python -m image_enhancement_deglaring_tpu_torch.tools.train_roofline \
        [--batches 8,32,128] [--size 512] [--device cuda]

Counterpart of the JAX package's ``scripts/train_roofline.py``. The batch
is generated on the device, so the time is the step's, not a host copy's.
For each batch size it prints the mean ms per step (host wall clock over
``--iters`` steps, one synchronize at the end) and:

- the compute floor: the step's FLOPs (``torch.utils.flop_counter``'s
  ``FlopCounterMode`` over one step: convolutions and matrix products,
  forward and backward) over the H100's dense bf16 peak;
- the bandwidth floor: bytes over the H100's HBM rate, the bytes taken
  as the sum of every aten op's input and output ``nbytes`` under a
  ``TorchDispatchMode``. That counts each intermediate once per op that
  reads or writes it, as XLA's "bytes accessed" does, so it is an upper
  estimate of what the step must move;
- after the last size, the fixed cost per step from a linear fit of ms
  over batch sizes, beside a trivial kernel's chained and round-trip
  dispatch times.

A suffix ``r`` on a batch (``256r``) runs the model with block remat.
Every line names the device; the floors are the H100 data sheet's (SXM,
dense: 989 TFLOP/s bf16, 3.35 TB/s HBM3), so they mean something only on
one. ``--device cpu`` runs the same code on the host at a toy size.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
LR = 0.002362532125818593
WD = 6.753784966611083e-05


class ByteCounter(TorchDispatchMode):
    """Sums the ``nbytes`` of every tensor each aten op reads or writes."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.nbytes += t.nbytes
        return out


def build(batch: int, size: int, device: torch.device, remat: bool = False):
    """The production model (seeded init) in bf16, its optimizer and step,
    and one batch made on the device: target uniform, input target plus
    noise, clipped; the input in bf16 as the loader ships it."""
    from ..models import LightweightUNet
    from ..train import TrainState, make_optimizer, make_train_step

    model = LightweightUNet(dtype=torch.bfloat16, remat=remat,
                            generator=torch.Generator().manual_seed(0)).to(device)
    state = TrainState(model=model, optimizer=make_optimizer(model, LR, WD))
    g = torch.Generator(device).manual_seed(1)
    y = torch.rand((batch, size, size, 1), generator=g, device=device)
    x = (y + 0.1 * torch.randn(y.shape, generator=g, device=device)).clamp(0, 1)
    return state, make_train_step(), x.to(torch.bfloat16), y


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_costs(state, step, x, y) -> tuple[float, float]:
    """(FLOPs, bytes) of one step, each counted on a step of its own."""
    with FlopCounterMode(display=False) as fc:
        step(state, x, y)
    with ByteCounter() as bc:
        step(state, x, y)
    return float(fc.get_total_flops()), float(bc.nbytes)


def timed_step(state, step, x, y, device, iters: int) -> float:
    """Seconds per step: two warm steps, then ``iters`` with one
    synchronize at the end."""
    for _ in range(2):
        state, loss = step(state, x, y)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, loss = step(state, x, y)
    sync(device)
    return (time.perf_counter() - t0) / iters


def measure(batch: int, size: int, device: torch.device, iters: int = 8,
            remat: bool = False) -> dict:
    """One batch size: seconds per step, FLOPs, bytes and the two floors."""
    state, step, x, y = build(batch, size, device, remat)
    flops, nbytes = step_costs(state, step, x, y)
    dt = timed_step(state, step, x, y, device, iters)
    return {"batch": batch, "remat": remat, "s_per_step": dt, "flops": flops,
            "bytes": nbytes, "compute_floor_s": flops / PEAK_BF16_FLOPS,
            "bandwidth_floor_s": nbytes / PEAK_HBM_BYTES}


def fixed_cost(rows: list[dict]) -> tuple[float, float]:
    """(fixed s per step, marginal s per image) of a linear fit over the
    rows without remat."""
    plain = [(r["batch"], r["s_per_step"]) for r in rows if not r["remat"]]
    bs, ts = (np.array(v, float) for v in zip(*plain))
    slope, fixed = np.polyfit(bs, ts, 1)
    return float(fixed), float(slope)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,32,128",
                    help="comma list; suffix r = remat (e.g. 256r)")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)

    from .._device import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    rows = []
    for tok in args.batches.split(","):
        r = measure(int(tok.rstrip("r")), args.size, device, args.iters, tok.endswith("r"))
        rows.append(r)
        dt, comp, bw = r["s_per_step"], r["compute_floor_s"], r["bandwidth_floor_s"]
        print(f"batch {r['batch']}{' (remat)' if r['remat'] else ''}: {dt * 1e3:.3f} ms/step "
              f"{r['batch'] / dt:.1f} img/s | GFLOP {r['flops'] / 1e9:.3f}, MB "
              f"{r['bytes'] / 1e6:.1f} (upper estimate) | H100 floors: compute "
              f"{comp * 1e3:.4f} ms, bandwidth {bw * 1e3:.4f} ms; step / larger floor "
              f"{dt / max(comp, bw):.2f}x on {name}", flush=True)

    if sum(not r["remat"] for r in rows) >= 2:
        fixed, slope = fixed_cost(rows)
        print(f"linear fit over b={sorted(r['batch'] for r in rows if not r['remat'])}: "
              f"fixed {fixed * 1e3:.3f} ms/step + {slope * 1e3:.4f} ms/img marginal on {name}",
              flush=True)

    # the fixed part against an (almost) empty launch through the same path
    a = torch.zeros((), device=device)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(16):
        a = a + 1.0
    sync(device)
    chained = (time.perf_counter() - t0) / 16
    t0 = time.perf_counter()
    for _ in range(8):
        float(torch.zeros((), device=device) + 1.0)
    rt = (time.perf_counter() - t0) / 8
    print(f"trivial launch (chained, amortized): {chained * 1e3:.4f} ms; launch + fetch "
          f"round trip: {rt * 1e3:.4f} ms on {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
