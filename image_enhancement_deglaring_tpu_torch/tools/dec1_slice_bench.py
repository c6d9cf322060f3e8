"""Time the dec1 tail kernel (K5) against the composition of the model's ops.

    python -m image_enhancement_deglaring_tpu_torch.tools.dec1_slice_bench \\
        [--batch 128] [--size 512] [--device cuda]

Counterpart of ``scripts/dec1_slice_bench.py``, with its defaults: batch
128, 8 channels, 512x512, bf16, seeded distinct up/skip inputs in [-1, 1)
(identical ones would hide an operand swap), seeded weights. Prints the
composition's time (``dec1_output_composition``, the production path), K5's
(``fused_dec1_output``), their ratio, and the max and mean |K5 -
composition|. On a CUDA device the times are CUDA-event means; with
``--device cpu`` they are host times of the plain version, for checking the
script only. The TPU script also timed NHWC -> NCHW input transposes; K5
takes NHWC, so there are none here.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ops.dec1 import dec1_output_composition, fused_dec1_output

CHANNELS = 8
DTYPE = torch.bfloat16
TILE_H = 64  # K5's row tile
SEED = 0
ITERS = 8    # timed calls per path


def _timed(fn, dev: torch.device) -> tuple[float, torch.Tensor]:
    """Mean ms of one call over ITERS calls after two warm ones."""
    out = fn()
    out = fn()
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / ITERS, out
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / ITERS, out


def run(batch: int = 128, size: int = 512, device="cuda") -> dict:
    """Build the inputs, time both paths and compare them; returns the numbers."""
    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)

    def f32(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(dev)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    shape = (batch, size, size, CHANNELS)
    # distinct draws from one generator: up and skip differ
    xu = (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(DTYPE)
    xs = (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(DTYPE)
    wa, wb, w2 = (f32(3, 3, CHANNELS, CHANNELS, s=0.2) for _ in range(3))
    g1s, g1b, g2s, g2b = (f32(CHANNELS) for _ in range(4))
    wo, bo = f32(1, 1, CHANNELS, 1, s=0.3), f32(1)
    args = (xu, xs, wa, wb, w2, g1s, g1b, g2s, g2b, wo, bo)

    with torch.inference_mode():
        t_comp, want = _timed(lambda: dec1_output_composition(*args), dev)
        t_k5, got = _timed(lambda: fused_dec1_output(*args, tile_h=TILE_H), dev)
        err = (got - want[..., 0]).abs()
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "batch": batch, "size": size, "dtype": str(DTYPE)[6:], "tile_h": TILE_H,
        "composition_ms": t_comp, "dec1_output_ms": t_k5, "ratio": t_comp / t_k5,
        "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
        "finite": bool(torch.isfinite(got).all()),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    r = run(a.batch, a.size, a.device)
    tag = f"b{r['batch']} {r['size']}x{r['size']} {r['dtype']} on {r['device']}"
    per_img = 1e3 / r["batch"]
    print(f"composition slice (NHWC, {tag}): {r['composition_ms']:.5f} ms "
          f"({r['composition_ms'] * per_img:.2f} us/img)")
    print("input transposes NHWC->NCHW: none, K5 takes NHWC")
    print(f"K5 fused slice (NHWC, {tag}, tile_h {r['tile_h']}): {r['dec1_output_ms']:.5f} ms "
          f"({r['dec1_output_ms'] * per_img:.2f} us/img)")
    print(f"K5 vs composition: {r['ratio']:.3f}x; max |K5 - composition| "
          f"{r['max_abs_err']:.5f}, mean {r['mean_abs_err']:.6f}")
    return 0 if r["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
