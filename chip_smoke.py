#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``image_enhancement_deglaring_tpu_torch/csrc``;
3. hold every kernel against its plain PyTorch version at the main path's
   shapes, in bfloat16 and float32 (TF32 off), and time the kernel, the
   plain version and one PyTorch library call computing the same function;
4. serve 16 seeded 512x512 frames through ``InferenceEngine.submit`` on the
   bf16 LightweightUNet with ``pallas_gn=True, fused_blocks="auto"`` and the
   production weights (``deploy/models/best_model.onnx``); check the launch
   counters, compare with the same engine without the kernels (bf16 and f32);
   drive a 32x32 forward, which reaches the NHWC GroupNorm kernel and runs
   the conv kernel on images smaller than its 8x8 tile, and compare it the
   same way, beside the bf16 readings of its plain versions on the CPU;
5. time serving throughput (``infer_batch``) at buckets 8 and 64, with and
   without the kernels, and profile one batch of each: device time by
   kernel and the device's busy share.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s; bf16 tensor-core and
# float32 (non-tensor) FLOP/s. The GroupNorm arithmetic runs in float32.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
GN_OPS_PER_ELEMENT = 8  # 2 statistics + 2 affine + 4 SiLU

# |kernel - plain| <= atol + rtol * |plain|. bf16: two output ulps (2^-6
# relative), the two sides round once each from float32 sums taken in a
# different order. f32: summation order only; K3's is the JAX test's bound.
TOL = {
    ("gn", torch.float32): (1e-4, 1e-4),
    ("gn", torch.bfloat16): (1e-2, 1.6e-2),
    ("conv", torch.float32): (2e-4, 2e-4),
    ("conv", torch.bfloat16): (1e-2, 1.6e-2),
}

# (shape, path): the forward that gives a kernel this shape, "512" or "32"
# for the batch-8 512x512 and 32x32 forwards that serve_slice drives, None
# for a shape checked but on neither. Only path shapes reach the JSON line.
K1_SHAPES = [((8, 512, 512, 8), "512"), ((8, 256, 256, 16), "512"),
             ((8, 128, 128, 32), "512"), ((8, 64, 64, 64), "512"),
             ((8, 32, 32, 128), None),  # the 512x512 bottleneck level, which K3 takes
             ((8, 32, 32, 8), "32"), ((8, 16, 16, 16), "32"), ((8, 8, 8, 32), "32")]
K2_SHAPES = [((8, 4, 4, 64), "32"),  # dec4 of a 32x32 image
             ((8, 4, 4, 128), None), ((8, 6, 6, 64), None)]
# (input shape, Cout): enc4 and bottleneck; at 32x32 the images are smaller
# than the conv's 8x8 output tile
K3_SHAPES = [(((8, 64, 64, 32), 64), "512"), (((8, 64, 64, 64), 64), "512"),
             (((8, 32, 32, 64), 128), "512"), (((8, 32, 32, 128), 128), "512"),
             (((8, 4, 4, 32), 64), "32"), (((8, 4, 4, 64), 64), "32"),
             (((8, 2, 2, 64), 128), "32"), (((8, 2, 2, 128), 128), "32")]
GROUPS = 8


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, kind: str) -> float:
    atol, rtol = TOL[(kind, got.dtype)]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    worst = float(err.max())
    if not bool((err <= atol + rtol * w.abs()).all()):
        raise AssertionError(f"{name}: max |kernel - plain| {worst:.3g} exceeds "
                             f"atol {atol} + rtol {rtol} * |plain|")
    return worst


def check_kernels() -> list[dict]:
    """Phase 3: every kernel against its plain version; returns the JSON rows."""
    import torch.nn.functional as F

    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import highest_precision

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        t = torch.randn(shape, generator=gen, device="cuda") * scale + shift
        return t.to(dtype)

    rows = {}

    def record(key, on_path, err, ms, plain_ms, lib_ms, b):
        r = rows.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                  "bound_ms": 0.0, "library_ms": 0.0, "by": {}})
        if on_path:
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["library_ms"] += lib_ms
            r["bound_ms"] += b[0]
            r["by"][b[1]] = r["by"].get(b[1], 0.0) + b[0]

    gn_cases = [("gn_silu_flat", fk.gn_silu_flat, s, p) for s, p in K1_SHAPES]
    gn_cases += [("gn_silu_nhwc", fk.gn_silu_nhwc, s, p) for s, p in K2_SHAPES]
    for dtype in (torch.bfloat16, torch.float32):
        for name, fn, shape, path in gn_cases:
            c = shape[-1]
            x = randn(*shape, scale=2.0, shift=0.5, dtype=dtype)
            gamma, beta = randn(c), randn(c)
            with highest_precision():
                got = fn(x, gamma, beta, num_groups=GROUPS)
                want = fk.gn_silu_plain(x, gamma, beta, num_groups=GROUPS)
                torch.cuda.synchronize()
                err = check_close(f"{name}{shape} {dtype}", got, want, "gn")
                ms = time_ms(lambda: fn(x, gamma, beta, num_groups=GROUPS))
                plain_ms = time_ms(lambda: fk.gn_silu_plain(x, gamma, beta, num_groups=GROUPS))
                xl, gl, bl = x.permute(0, 3, 1, 2), gamma.to(dtype), beta.to(dtype)
                lib_ms = time_ms(lambda: F.silu(F.group_norm(xl, GROUPS, gl, bl, 1e-5)))
            b = bound(2 * x.numel() * x.element_size() + 8 * c,
                      GN_OPS_PER_ELEMENT * x.numel(), torch.float32)
            print(f"{name} {shape} {str(dtype)[6:]} path {path}: max_abs_err {err:.3g} "
                  f"(atol {TOL[('gn', dtype)][0]}, rtol {TOL[('gn', dtype)][1]}) "
                  f"ms {ms:.5f} plain_ms {plain_ms:.5f} library_ms {lib_ms:.5f} "
                  f"bound_ms {b[0]:.3g} ({b[1]})", flush=True)
            if dtype == torch.bfloat16:
                record(name, path is not None, err, ms, plain_ms, lib_ms, b)

    for dtype in (torch.bfloat16, torch.float32):
        for (shape, cout), path in K3_SHAPES:
            cin = shape[-1]
            x = randn(*shape, dtype=dtype)
            w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
            gamma, beta = randn(cout), randn(cout)
            with highest_precision():
                got = fk.conv3x3_gn_silu(x, w, gamma, beta, num_groups=GROUPS)
                want = fk.conv3x3_gn_silu_plain(x, w, gamma, beta, num_groups=GROUPS)
                torch.cuda.synchronize()
                err = check_close(f"conv3x3_gn_silu{shape}->{cout} {dtype}", got, want, "conv")
                ms = time_ms(lambda: fk.conv3x3_gn_silu(x, w, gamma, beta, num_groups=GROUPS))
                plain_ms = time_ms(lambda: fk.conv3x3_gn_silu_plain(
                    x, w, gamma, beta, num_groups=GROUPS))
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)
                gl, bl = gamma.to(dtype), beta.to(dtype)
                lib_ms = time_ms(lambda: F.silu(F.group_norm(
                    F.conv2d(xl, wl, padding=1), GROUPS, gl, bl, 1e-5)))
            n, h, wd, _ = shape
            out_elems = n * h * wd * cout
            nbytes = (x.numel() + 9 * cin * cout + out_elems) * x.element_size() + 8 * cout
            flops = 2 * 9 * cin * out_elems
            b = bound(nbytes, flops, dtype)
            print(f"conv3x3_gn_silu {shape}->{cout} {str(dtype)[6:]} path {path}: "
                  f"max_abs_err {err:.3g} "
                  f"(atol {TOL[('conv', dtype)][0]}, rtol {TOL[('conv', dtype)][1]}) "
                  f"ms {ms:.5f} plain_ms {plain_ms:.5f} library_ms {lib_ms:.5f} "
                  f"bound_ms {b[0]:.3g} ({b[1]})", flush=True)
            if dtype == torch.bfloat16:
                record("conv3x3_gn_silu", path is not None, err, ms, plain_ms, lib_ms, b)
    return rows


def make_frames(n: int, s: int, seed: int) -> np.ndarray:
    """Seeded grayscale pages: a smooth background, a bright glare spot,
    sensor noise; uint8 (n, s, s)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:s, 0:s] / s
    out = np.empty((n, s, s), np.uint8)
    for i in range(n):
        fx, fy, cx, cy = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.random(), rng.random()
        page = 0.55 + 0.25 * np.sin(2 * np.pi * (fx * xx + fy * yy))
        glare = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.03)
        img = page + 0.45 * glare + 0.04 * rng.standard_normal((s, s))
        out[i] = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    return out


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def serve_slice() -> dict:
    """Phase 4: the main path. Returns the launch counts of its bf16 512x512
    and 32x32 runs, added up."""
    from image_enhancement_deglaring_tpu_torch.modelio import load_lightweight_unet
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.serve import InferenceEngine

    def engine(dtype, kernels, size, device="cuda", **kw):
        model = load_lightweight_unet(ONNX, dtype=dtype, device=device,
                                      pallas_gn=kernels, fused_blocks="auto" if kernels else False)
        return InferenceEngine(model, image_size=size, compute_dtype=dtype, device=device, **kw)

    frames = make_frames(16, 512, seed=1)
    eng = engine(torch.bfloat16, True, 512, max_batch_size=8)  # warmup builds every bucket
    futures: list = [None] * len(frames)

    def client(k):
        for i in range(k, len(frames), 4):
            futures[i] = eng.submit(frames[i])

    batches0 = eng.stats()["batches_dispatched"]
    fk.reset_launch_counts()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    outs = np.stack([f.result(timeout=300) for f in futures])
    torch.cuda.synchronize()
    counts = dict(fk.LAUNCHES)
    forwards = eng.stats()["batches_dispatched"] - batches0
    eng.stop()
    print(f"served {len(frames)} frames in {forwards} device batches; launches {counts}",
          flush=True)
    if counts != {"gn_silu_flat": 14 * forwards, "gn_silu_nhwc": 0,
                  "conv3x3_gn_silu": 4 * forwards}:
        raise AssertionError(f"want 14 gn_silu_flat and 4 conv3x3_gn_silu launches per "
                             f"forward over {forwards} forwards, got {counts}")
    if outs.shape != (16, 512, 512) or outs.dtype != np.uint8:
        raise AssertionError(f"bad output {outs.shape} {outs.dtype}")

    ref = engine(torch.bfloat16, False, 512, max_batch_size=16, warmup=False).infer_batch(frames)
    d = int(np.abs(outs.astype(np.int16) - ref.astype(np.int16)).max())
    p = psnr_u8(outs, ref)
    print(f"bf16 kernels vs bf16 composition: max |delta| {d} uint8, PSNR {p:.2f} dB "
          f"(need >= 45)", flush=True)
    if p < 45.0:
        raise AssertionError(f"bf16 PSNR {p:.2f} dB < 45 dB")

    got32 = engine(torch.float32, True, 512, max_batch_size=8, warmup=False).infer_batch(frames[:8])
    ref32 = engine(torch.float32, False, 512, max_batch_size=8, warmup=False).infer_batch(frames[:8])
    d32 = int(np.abs(got32.astype(np.int16) - ref32.astype(np.int16)).max())
    print(f"f32 kernels vs f32 composition: max |delta| {d32} uint8 (need <= 1)", flush=True)
    if d32 > 1:
        raise AssertionError(f"f32 engines differ by {d32} uint8 levels")

    small = make_frames(8, 32, seed=2)
    eng32 = engine(torch.bfloat16, True, 32, max_batch_size=8, warmup=False)
    fk.reset_launch_counts()
    out_small = eng32.infer_batch(small)
    torch.cuda.synchronize()
    counts32 = dict(fk.LAUNCHES)
    print(f"32x32 forward: launches {counts32}", flush=True)
    want32 = {"gn_silu_flat": 12, "gn_silu_nhwc": 2, "conv3x3_gn_silu": 4}
    if counts32 != want32:
        raise AssertionError(f"32x32 forward: want 12/2/4 launches, got {counts32}")

    # the same dispatch in float32 tells kernel faults from bf16 rounding
    fk.reset_launch_counts()
    got_small32 = engine(torch.float32, True, 32, max_batch_size=8, warmup=False).infer_batch(small)
    if dict(fk.LAUNCHES) != want32:
        raise AssertionError(f"32x32 f32 forward: want 12/2/4 launches, got {fk.LAUNCHES}")
    ref_small = engine(torch.float32, False, 32, max_batch_size=8, warmup=False).infer_batch(small)
    d_small = int(np.abs(got_small32.astype(np.int16) - ref_small.astype(np.int16)).max())
    print(f"32x32 f32 kernels vs f32 composition: max |delta| {d_small} uint8 (need <= 1)",
          flush=True)
    if d_small > 1:
        raise AssertionError(f"32x32 f32 engines differ by {d_small} uint8 levels")

    # small images have few pixels per group, so bf16 rounding weighs more:
    # hold both bf16 paths against the f32 composition instead of each other,
    # and read the same two bf16 paths on the CPU, where the kernel path runs
    # the kernels' plain versions
    comp_small = engine(torch.bfloat16, False, 32, max_batch_size=8, warmup=False).infer_batch(small)
    cpu = {k: engine(torch.bfloat16, k, 32, device="cpu", max_batch_size=8,
                     warmup=False).infer_batch(small) for k in (True, False)}
    p_k, p_c = psnr_u8(out_small, ref_small), psnr_u8(comp_small, ref_small)
    print(f"32x32 vs f32 composition: bf16 kernels {p_k:.2f} dB, bf16 composition "
          f"{p_c:.2f} dB (kernels need >= composition - 3 dB); on the CPU: bf16 plain "
          f"versions {psnr_u8(cpu[True], ref_small):.2f} dB, bf16 composition "
          f"{psnr_u8(cpu[False], ref_small):.2f} dB; card vs CPU: kernel path "
          f"{psnr_u8(out_small, cpu[True]):.2f} dB, composition "
          f"{psnr_u8(comp_small, cpu[False]):.2f} dB", flush=True)
    if p_k < p_c - 3.0:
        raise AssertionError(f"32x32 bf16 kernels {p_k:.2f} dB vs composition {p_c:.2f} dB")
    # launches of the two bf16 path runs (the f32 run is a comparison)
    return {k: counts[k] + counts32[k] for k in counts}


def throughput(card: str) -> None:
    """Phase 5: images/s of infer_batch at buckets 8 and 64, bf16, 512x512,
    with and without the kernels."""
    from image_enhancement_deglaring_tpu_torch.modelio import load_lightweight_unet
    from image_enhancement_deglaring_tpu_torch.serve import InferenceEngine

    frames = make_frames(64, 512, seed=3)
    for kernels in (True, False):
        model = load_lightweight_unet(ONNX, dtype=torch.bfloat16, device="cuda",
                                      pallas_gn=kernels, fused_blocks="auto" if kernels else False)
        eng = InferenceEngine(model, image_size=512, max_batch_size=64)
        for b, iters in ((8, 30), (64, 8)):
            eng.infer_batch(frames[:b])
            t0 = time.perf_counter()
            for _ in range(iters):
                eng.infer_batch(frames[:b])
            dt = time.perf_counter() - t0
            print(f"throughput bf16 512x512 bucket {b} kernels={kernels}: "
                  f"{b * iters / dt:.1f} img/s on {card}", flush=True)
            profile_batches(eng, frames[:b], f"bucket {b} kernels={kernels}")
        eng.stop()


def _kernel_kind(name: str) -> str:
    low = name.lower()
    if "gnk::" in name or "conv3x3_partials" in name:
        return "port CUDA kernels"
    if "conv" in low or "xmma" in low or "implicit" in low or "cudnn" in low:
        return "cuDNN convolution"
    if "gemm" in low or "cutlass" in low:
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other PyTorch kernels"


def profile_batches(eng, frames: np.ndarray, label: str, reps: int = 3) -> None:
    """Where the device time of ``infer_batch`` goes: kernel time by kind and
    by name from a torch.profiler trace, and the device's busy share of the
    host wall time over ``reps`` synchronous batches."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                eng.infer_batch(frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        print(f"profile {label}: no device events in the trace (device time not measured)")
        return
    by_name: dict[str, float] = {}
    by_kind: dict[str, float] = {}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
        kind = _kernel_kind(e["name"]) if e["cat"] == "kernel" else "copies"
        by_kind[kind] = by_kind.get(kind, 0.0) + float(e["dur"])
    busy, end = 0.0, -math.inf
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    per_batch_ms = busy / 1e3 / reps
    print(f"profile {label}: device busy {per_batch_ms:.3f} ms per batch, "
          f"{len(dev) // reps} device ops per batch, busy share {busy / 1e6 / wall:.3f} "
          f"of {wall * 1e3 / reps:.3f} ms host wall per batch (profiler on)")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {us / 1e3 / reps:.3f} ms per batch ({us / busy:.1%})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3 / reps:.3f} ms  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from image_enhancement_deglaring_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    secs = _build.build()
    print(f"kernels built in {secs:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows = check_kernels()
    launches = serve_slice()
    throughput(card)

    meta = {
        "gn_silu_flat": ("image_enhancement_deglaring_tpu_torch/csrc/gn_silu.cu",
                         "image_enhancement_deglaring_tpu/ops/pallas_kernels.py:251"),
        "gn_silu_nhwc": ("image_enhancement_deglaring_tpu_torch/csrc/gn_silu.cu",
                         "image_enhancement_deglaring_tpu/ops/pallas_kernels.py:92"),
        "conv3x3_gn_silu": ("image_enhancement_deglaring_tpu_torch/csrc/conv_gn_silu.cu",
                            "image_enhancement_deglaring_tpu/ops/pallas_kernels.py:339"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["by"], key=r["by"].get), "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
