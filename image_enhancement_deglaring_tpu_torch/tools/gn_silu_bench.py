"""Device time per call of the GroupNorm+SiLU kernels (K1, K2) and of the
library call computing the same function.

    python3 image_enhancement_deglaring_tpu_torch/tools/gn_silu_bench.py [--root DIR]

Times ``gn_silu_flat`` at the four 512x512 serving shapes at batch 8 and
64, and ``gn_silu_nhwc`` at the 32x32 forward's shape, in bf16 on seeded
inputs, beside ``F.silu(F.group_norm(...))`` on the same inputs: the
durations of their device kernels in a torch.profiler trace of 20 calls,
per call, and the bound, one read and one write of the activation at
the H100's 3.35 TB/s. ``--root`` names the checkout whose package is
timed (default: the one holding this file), so that one copy of the
script times another commit's kernels; run the script by path for that.
Prints one line per shape; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

SHAPES = [("gn_silu_flat", (b, s, s, c)) for b in (8, 64)
          for s, c in ((512, 8), (256, 16), (128, 32), (64, 64))]
SHAPES.insert(4, ("gn_silu_nhwc", (8, 4, 4, 64)))
GROUPS = 8
HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet
REPS = 20
SEED = 0


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: for each kernel of a profiler trace of
    ``reps`` calls, its mean duration times its runs per call (count /
    reps, rounded, as a trace may miss an event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total / e.count * round(e.count / reps)
               for e in prof.key_averages() if e.count) / 1e3


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose package is timed")
    root = os.path.abspath(ap.parse_args(argv).root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    if not os.path.abspath(fk.__file__).startswith(root + os.sep):
        print(f"gn_silu_bench: the package came from {fk.__file__}, not {root}: run the "
              f"script by path", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("gn_silu_bench: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, shape in SHAPES:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        g = torch.randn(c, generator=gen, device="cuda")
        b = torch.randn(c, generator=gen, device="cuda")
        kernel = functools.partial(getattr(fk, name), x, g, b, num_groups=GROUPS)
        lib = functools.partial(F.group_norm, x.permute(0, 3, 1, 2), GROUPS, g.bfloat16(),
                                b.bfloat16(), 1e-5)
        ms = device_ms(kernel)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_S * 1e3
        print(f"{root} {name}{shape} bf16: kernel {ms:.5f} library "
              f"{device_ms(lambda: F.silu(lib())):.5f} ms (device, per call); bound {bound:.5f} "
              f"ms (bytes), kernel {ms / bound:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
