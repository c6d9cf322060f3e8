"""Device time per call of the dec1 tail kernel (K5), split by launch.

    python3 image_enhancement_deglaring_tpu_torch/tools/dec1_output_bench.py [--root DIR]

Times ``fused_dec1_output`` at the model's dec1 shapes of a batch of 8
(8x512x512x8 and 8x32x32x8, tile_h 64) in bf16 and float32 on seeded
inputs: the durations of the device kernels in a torch.profiler trace of
20 calls, per call and by kernel name (the wrapper's own PyTorch kernels,
if it launches any, included), the CUDA-event mean of 20 back-to-back
calls, and the bound: each input read once and the output written once at
the H100's 3.35 TB/s, or the operations at its data-sheet peak, whichever
is larger. Prints nvcc's register and spill report of each K5 instance
first. ``--root`` names the checkout whose package is timed (default: the
one holding this file), so that one copy of the script times another
commit's kernel; run the script by path for that. Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

SHAPES = [(8, 512, 512, 8), (8, 32, 32, 8)]
TILE_H = 64
HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FLOPS_PER_PIXEL = 3 * 9 * 8 * 8 * 2 + 8 * 2  # three 3x3 convs 8->8 and the 1x1
REPS = 20
SEED = 0


def kernel_split(fn, reps: int = REPS) -> dict:
    """Device ms per call of each kernel name in a profiler trace of
    ``reps`` calls: its mean duration times its runs per call (count /
    reps, rounded, as a trace may miss an event), and those runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.device_time_total / e.count * round(e.count / reps) / 1e3,
                    round(e.count / reps))
            for e in prof.key_averages() if e.count and e.device_time_total > 0}


def event_ms(fn, reps: int = REPS) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose package is timed")
    root = os.path.abspath(ap.parse_args(argv).root)
    sys.path.insert(0, root)
    import torch

    from image_enhancement_deglaring_tpu_torch.ops import _build, dec1

    if not os.path.abspath(dec1.__file__).startswith(root + os.sep):
        print(f"dec1_output_bench: the package came from {dec1.__file__}, not {root}: run the "
              f"script by path", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("dec1_output_bench: no CUDA device", file=sys.stderr)
        return 1
    _build.load("dec1_output")
    for line in _build.build_log.get("dec1_output", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"{root} ptxas: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        for shape in SHAPES:
            c = shape[-1]
            xu, xs = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            args = (xu, xs, randn(3, 3, c, c, scale=0.2), randn(3, 3, c, c, scale=0.2),
                    randn(3, 3, c, c, scale=0.2), randn(c), randn(c), randn(c), randn(c),
                    randn(1, 1, c, 1, scale=0.3), randn(1))

            def fn():
                return dec1.fused_dec1_output(*args, tile_h=TILE_H)

            split = kernel_split(fn)
            ms = sum(v[0] for v in split.values())
            pixels = shape[0] * shape[1] * shape[2]
            nbytes = 2 * xu.numel() * xu.element_size() + 4 * pixels + 4 * (3 * 576 + 41)
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_ops = FLOPS_PER_PIXEL * pixels / PEAK_FLOPS[str(dtype)[6:]] * 1e3
            b, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            print(f"{root} dec1_output{shape} {str(dtype)[6:]} tile_h {TILE_H}: device {ms:.5f} "
                  f"ms per call in {sum(v[1] for v in split.values())} kernels; events "
                  f"{event_ms(fn):.5f} ms; bound {b:.5f} ms ({by}), device {ms / b:.2f}x",
                  flush=True)
            for name, (t, runs) in sorted(split.items(), key=lambda kv: -kv[1][0]):
                print(f"    {t:.5f} ms  x{runs}  {name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
