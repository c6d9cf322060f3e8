#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``image_enhancement_deglaring_tpu_torch/csrc``;
3. hold every kernel against its plain PyTorch version at the main path's
   shapes, in bfloat16 and float32 (TF32 off), and time the kernel, the
   plain version and one PyTorch library call computing the same function
   (for the dec1 tail, which no one call computes, the composition of ops),
   each the median of 5 rounds of 20 calls (9 of 40 for the conv kernel),
   the rounds of a shape's functions taking turns in a seeded order; the
   conv kernel with weights in the activation dtype, as the model holds
   them, and with float32 weights cast in every call, and for the bf16 conv
   at 512x512 also the device time of K3, K4 and the library call and K3's
   split by kernel;
   K4 also against K3, bit for bit, and its batch check; the conv kernel
   also at ragged channel counts and image sizes and on an output whose
   group means are >= 30x their standard deviations; K5 also twice, bit
   for bit, in bf16 with its largest error traced to its source and two
   rounding faults that its gate must reject, and at the 512x512 and
   32x32 path shapes as three launches per call, with its device time
   split by launch; K1/K2 also twice, bit for bit, with their launch plan
   and bytes read, at 512x512 as one device kernel per call with device
   times beside the library call's, on slabs larger than one wave, at
   C % 8 != 0, on an unaligned input, on a side stream while the current
   stream runs long matrix products, and as two calls at once on two
   streams, each equal to its single-stream result bit for bit;
4. serve 16 seeded 512x512 frames through ``InferenceEngine.submit`` on the
   bf16 LightweightUNet with ``pallas_gn=True, fused_blocks="auto"`` and the
   production weights (``deploy/models/best_model.onnx``); check the launch
   counters, compare with the same engine without the kernels (bf16 and f32);
   drive a 32x32 forward, which reaches the NHWC GroupNorm kernel and runs
   the conv kernel on images smaller than its 8x8 tile, and compare it the
   same way, beside the bf16 readings of its plain versions on the CPU;
5. the kernels' own entry points on the production model's activations:
   8 frames at 512x512 and at 32x32 through the bf16 and float32 engines
   with the kernels on; the enc4 and bottleneck blocks rerun through
   ``fused_conv3x3_gn_silu(images_per_step=K)`` (K4, equal to the blocks'
   own K3 output bit for bit), dec1's inputs through ``fused_dec1_output``
   (K5) against its plain version and, as uint8 frames, against the model's
   own tail; at 512x512 K5's time beside the model's tail and the
   composition, each split by kernel; then the bench entry
   ``tools.dec1_slice_bench`` at its defaults (batch 128);
6. time serving throughput (``infer_batch``) at buckets 8 and 64, with and
   without the kernels, and profile one batch of each: device time by
   kernel and the device's busy share.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import functools
import json
import math
import os
import random
import subprocess
import sys
import threading
import time
from unittest import mock

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
# dec1 (K5, float32 output): bounds on the largest |kernel - plain|, on the
# mean, and on the share of outputs beyond a threshold. bf16: both sides
# store h1, a1 and h2 in bf16 from float32 sums taken in another order, so
# now and then a value on a rounding boundary lands one bf16 ulp away and
# moves the outputs it feeds (dec1_error_sources traces the largest error
# to one such a1 value). The flips are rare but move single outputs by up
# to 0.0227 on the H100 at 8x512x512, more than a rounding fault moves any
# one output at the other shapes: so the element bound, a third above that
# reading, only catches gross faults, and the mean and the share tell
# rounding faults from sound rounding (dec1_controls shows on the card that
# two such faults fail them; PERF.md has the readings). f32: the summation
# order of three convs and of the statistics only.
DEC1_GATE = {
    torch.float32: {"max": 1e-4, "mean": 1e-5, "beyond": (1e-3, 0.0)},
    torch.bfloat16: {"max": 0.03, "mean": 1e-4, "beyond": (1e-3, 0.01)},
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
# K1/K2 on no model path (wrapper, shape, groups, dtype, offset): slabs
# larger than one wave's shared memory, which read what it cannot hold
# twice; C % 8 != 0 (16-byte vectors span pixels); and a view whose slab
# starts 3300 bytes into its buffer, so neither it nor its rows are
# 16-byte aligned (one element at a time)
GN_CASES = [("gn_silu_flat", (1, 2048, 2048, 8), 8, torch.bfloat16, 0),
            ("gn_silu_flat", (2, 1024, 1024, 8), 8, torch.float32, 0),
            ("gn_silu_flat", (1, 8, 32, 4), 4, torch.bfloat16, 0),
            ("gn_silu_flat", (1, 8, 32, 4), 4, torch.float32, 0),
            ("gn_silu_nhwc", (2, 5, 5, 66), 2, torch.bfloat16, 1)]
# (input shape, Cout): enc4 and bottleneck; at 32x32 the images are smaller
# than the conv's 8x8 output tile
K3_SHAPES = [(((8, 64, 64, 32), 64), "512"), (((8, 64, 64, 64), 64), "512"),
             (((8, 32, 32, 64), 128), "512"), (((8, 32, 32, 128), 128), "512"),
             (((8, 4, 4, 32), 64), "32"), (((8, 4, 4, 64), 64), "32"),
             (((8, 2, 2, 64), 128), "32"), (((8, 2, 2, 128), 128), "32")]
# K4's images per step, at batch 8 (K = 8 at 8x32x32x128->128: a grid cut
# by K would have 16 tiles x 2 channel tiles = 32 blocks, fewer than the SMs)
K4_IMAGES = (2, 4, 8)
# conv cases on no model path, checked only: channel counts that are no
# multiple of 16 (or of 8, or of 64), image sizes that are no multiple of 8,
# and more input channels than one weight window holds (128)
CONV_RAGGED = [((2, h, w, cin), cout) for h, w in ((6, 6), (36, 20))
               for cin in (1, 8, 24) for cout in (8, 16, 96)] + [((2, 16, 16, 256), 64)]
# a conv output whose group means are >= 30x their standard deviations
CONV_OFFSET_SHAPE, CONV_OFFSET_MIN_RATIO = ((4, 32, 32, 64), 64), 30.0
# (shape, tile_h), path: the JAX tests' shapes and tilings, then the 512x512
# and 32x32 dec1 inputs of a batch of 8 (tile_h 64 falls back to one tile at 32)
DEC1_SHAPES = [(((2, 64, 128, 8), 16), None), (((1, 48, 128, 8), 48), None),
               (((1, 48, 128, 8), 7), None), (((1, 48, 128, 8), 16), None),
               (((8, 512, 512, 8), 64), "512"), (((8, 32, 32, 8), 64), "32")]
# dec1 tail FLOP per pixel: two 3x3 convs 8->8 into h1, one into h2, the 1x1
DEC1_FLOPS_PER_PIXEL = 3 * 9 * 8 * 8 * 2 + 8 * 2
GROUPS = 8
# bf16 frames of the model's tail vs K5 on its dec1 inputs: phase 4's gate
# for two bf16 paths of one model (written before the first run)
DEC1_PSNR_GATE_DB = 45.0


def time_many(fns: dict, iters: int = 20, warmup: int = 3, rounds: int = 5) -> dict:
    """Time of one call of each function: the median over ``rounds`` rounds
    (at least one per function) of the mean by CUDA events around ``iters``
    back-to-back calls, each round's calls after ``warmup`` untimed ones.
    The functions' rounds take turns, in a seeded order that changes from
    round to round: below ~0.1 ms a call is bound by its host cost, which
    the machine's other work makes vary, so a slow spell weighs on all of
    them alike and the median keeps it out, and no function always runs
    right after the same other one."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    keys = list(fns)
    means: dict = {k: [] for k in fns}
    for r in range(max(rounds, len(keys))):
        order = keys[:]
        random.Random(r).shuffle(order)
        for k in order:
            fn = fns[k]
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            means[k].append(start.elapsed_time(end) / iters)
    return {k: sorted(v)[len(v) // 2] for k, v in means.items()}


def time_ms(fn, iters: int = 20, warmup: int = 3, rounds: int = 5) -> float:
    """``time_many`` of one function."""
    return time_many({0: fn}, iters, warmup, rounds)[0]


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call: for each kernel or copy of a torch.profiler
    trace of ``reps`` calls, its mean duration times its runs per call
    (count / reps, rounded: a trace taken after an earlier profiler session
    can miss an event). The host's cost, which sets CUDA-event times below
    ~0.1 ms, does not enter."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total / e.count * round(e.count / reps)
               for e in prof.key_averages() if e.count) / 1e3


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, kind: str,
                dtype=None) -> float:
    """Max |got - want|; fails beyond TOL[(kind, dtype)], dtype the
    kernel's input dtype (got's by default)."""
    atol, rtol = TOL[(kind, dtype or got.dtype)]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    worst = float(err.max())
    if not bool((err <= atol + rtol * w.abs()).all()):
        raise AssertionError(f"{name}: max |kernel - plain| {worst:.3g} exceeds "
                             f"atol {atol} + rtol {rtol} * |plain|")
    return worst


def gn_plan_line(x: torch.Tensor) -> str:
    """The GroupNorm kernel's launch plan for ``x`` on this card, and the
    bytes of activation the call reads."""
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    n, h, w, c = x.shape
    p = fk._gn_plan(n, h, w, c, x.dtype, fk._sm_count(x.device), x.data_ptr() % 16 == 0)
    share = p.bytes_read / (x.numel() * x.element_size())
    return (f"plan: vec {p.vec}, {p.threads} threads, {p.chunks} chunks of {p.chunk_pix} px, "
            f"{p.images} images x {p.waves} waves, grid {p.grid}, smem {p.smem}, read twice "
            f"{p.reread_pix} px/chunk; reads {p.bytes_read} B ({share:.3f}x the input)")


def check_gn_case(name: str, fn, x, gamma, beta, groups: int) -> float:
    """K1/K2 against its plain version under TOL[("gn", dtype)], and a
    second call equal to the first bit for bit."""
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    got = fn(x, gamma, beta, num_groups=groups)
    again = fn(x, gamma, beta, num_groups=groups)
    want = fk.gn_silu_plain(x, gamma, beta, num_groups=groups)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        d = float((got.float() - again.float()).abs().max())
        raise AssertionError(f"{name}: two calls differ by up to {d:.3g}")
    return check_close(name, got, want, "gn")


def gn_library(xl, gamma, beta):
    """One PyTorch call computing K1/K2's function on NCHW ``xl``."""
    import torch.nn.functional as F

    return F.silu(F.group_norm(xl, GROUPS, gamma, beta, 1e-5))


def check_launches(fn, label: str, n: int = 1, reps: int = 5) -> None:
    """Fails unless each call of ``fn`` makes ``n`` kernel launches and no
    copy or memset (counted from the CUDA runtime calls in the trace, which
    a profiler session after an earlier one records in full where it may
    drop a device event), of ``n`` kernels."""
    fn()
    events, _ = trace_events(fn, reps)
    api = [e["name"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
           and any(k in e["name"] for k in ("Launch", "Memcpy", "Memset"))]
    kernels = {e["name"] for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    if len(api) != n * reps or any("Launch" not in a for a in api) or len(kernels) != n:
        raise AssertionError(f"{label}: want {n} kernel launches per call; {reps} calls made "
                             f"{api}, running {sorted(kernels)}")
    print(f"  {label}: {n} launches per call ({api[0]}: "
          + ", ".join(k[:60] for k in sorted(kernels)) + ")", flush=True)


def check_gn_cases(randn) -> None:
    """Phase 3, K1/K2 cases on no model path, each against its plain
    version and twice, bit for bit: slabs larger than one wave (the
    re-read route), channels that do not fill 16-byte vectors, an input
    that is not 16-byte aligned; then a K1 call on a side stream while the
    current stream runs long matrix products."""
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import highest_precision

    for name, shape, groups, dtype, offset in GN_CASES:
        fn = getattr(fk, name)
        c = shape[-1]
        x = randn(shape[0] + offset, *shape[1:], scale=2.0, shift=0.5, dtype=dtype)[offset:]
        gamma, beta = randn(c), randn(c)
        label = f"{name}{shape} groups {groups} {str(dtype)[6:]}" + (" unaligned" if offset else "")
        with highest_precision():
            err = check_gn_case(label, fn, x, gamma, beta, groups)
            ms = time_ms(lambda: fn(x, gamma, beta, num_groups=groups), iters=5, rounds=3)
        print(f"{label}: max_abs_err {err:.3g} within {TOL[('gn', dtype)]}, two calls equal bit "
              f"for bit; ms {ms:.5f}; {gn_plan_line(x)}", flush=True)

    # side stream: the current stream runs 8 chained 8192^3 bf16 products
    # (~10 ms of work on every SM); K1 at 8x512x512x8 (33 chunks per image,
    # a cooperative grid on every SM) goes to another stream meanwhile
    x = randn(8, 512, 512, 8, scale=2.0, shift=0.5, dtype=torch.bfloat16)
    gamma, beta = randn(8), randn(8)
    want = fk.gn_silu_plain(x, gamma, beta, num_groups=GROUPS)
    a = randn(8192, 8192, scale=0.01, dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    ev = {k: torch.cuda.Event(enable_timing=True) for k in ("start", "main", "side")}
    torch.cuda.synchronize()
    ev["start"].record()
    y = a
    for _ in range(8):
        y = y @ a
    ev["main"].record()
    with torch.cuda.stream(side):
        got = fk.gn_silu_flat(x, gamma, beta, num_groups=GROUPS)
        ev["side"].record()
    torch.cuda.synchronize()
    err = check_close("gn_silu_flat on a side stream", got, want, "gn")
    print(f"gn_silu_flat (8, 512, 512, 8) bf16 on a side stream beside 8 bf16 8192^3 products: "
          f"max_abs_err {err:.3g}; done {ev['start'].elapsed_time(ev['side']):.3f} ms after the "
          f"products began, which took {ev['start'].elapsed_time(ev['main']):.3f} ms", flush=True)
    del a, y
    check_gn_two_streams(randn)


def check_gn_two_streams(randn, shape=(64, 512, 512, 8), timeout_s: float = 30.0) -> None:
    """Two K1 calls at once on two streams, on different inputs, each a
    cooperative grid over every SM: both must finish (a wait in the kernel
    traps after 10 s; a host wait beyond ``timeout_s`` fails here too), each
    equal to its single-stream result bit for bit, each stream with its own
    workspace."""
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    xs = [randn(*shape, scale=2.0, shift=0.5 + k, dtype=torch.bfloat16) for k in range(2)]
    gamma, beta = randn(shape[-1]), randn(shape[-1])
    single = [fk.gn_silu_flat(x, gamma, beta, num_groups=GROUPS) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    for x, st in zip(xs, streams):  # each stream's workspace exists before the pair
        with torch.cuda.stream(st):
            fk.gn_silu_flat(x, gamma, beta, num_groups=GROUPS)
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in xs]
    torch.cuda.synchronize()
    got = []
    for x, st, (e0, e1) in zip(xs, streams, ev):
        with torch.cuda.stream(st):
            e0.record()
            got.append(fk.gn_silu_flat(x, gamma, beta, num_groups=GROUPS))
            e1.record()
    deadline = time.perf_counter() + timeout_s
    while not all(e1.query() for _, e1 in ev):
        if time.perf_counter() > deadline:
            raise AssertionError(f"two-stream K1: not done after {timeout_s} s (a hang)")
        time.sleep(0.001)
    torch.cuda.synchronize()
    for k in range(2):
        if not torch.equal(got[k], single[k]):
            d = float((got[k].float() - single[k].float()).abs().max())
            raise AssertionError(f"two-stream K1 call {k}: differs from its single-stream "
                                 f"result by up to {d:.3g}")
    work = [fk._GN_WORK.get((torch.cuda.current_device(), st.cuda_stream)) for st in streams]
    if None in work or work[0][0].data_ptr() == work[1][0].data_ptr():
        raise AssertionError("two-stream K1: the streams do not have workspaces of their own")
    spans = [(ev[0][0].elapsed_time(e0), ev[0][0].elapsed_time(e1)) for e0, e1 in ev]
    print(f"gn_silu_flat {shape} bf16 twice at once on two streams: both done, each equal to "
          f"its single-stream result bit for bit, a workspace per stream; spans "
          f"{spans[0][0]:.3f}-{spans[0][1]:.3f} and {spans[1][0]:.3f}-{spans[1][1]:.3f} ms "
          f"after the first began", flush=True)


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

    gn_device = []  # K1 at the 512x512 shapes, profiled at the end of the phase
    gn_cases = [("gn_silu_flat", fk.gn_silu_flat, s, p) for s, p in K1_SHAPES]
    gn_cases += [("gn_silu_nhwc", fk.gn_silu_nhwc, s, p) for s, p in K2_SHAPES]
    for dtype in (torch.bfloat16, torch.float32):
        for name, fn, shape, path in gn_cases:
            c = shape[-1]
            x = randn(*shape, scale=2.0, shift=0.5, dtype=dtype)
            gamma, beta = randn(c), randn(c)
            k1 = functools.partial(fn, x, gamma, beta, num_groups=GROUPS)
            plain = functools.partial(fk.gn_silu_plain, x, gamma, beta, num_groups=GROUPS)
            lib = functools.partial(gn_library, x.permute(0, 3, 1, 2), gamma.to(dtype),
                                    beta.to(dtype))
            with highest_precision():
                err = check_gn_case(f"{name}{shape} {dtype}", fn, x, gamma, beta, GROUPS)
                t = time_many({"k1": k1, "plain": plain, "library": lib})
            ms, plain_ms, lib_ms = t["k1"], t["plain"], t["library"]
            b = bound(2 * x.numel() * x.element_size() + 8 * c,
                      GN_OPS_PER_ELEMENT * x.numel(), torch.float32)
            print(f"{name} {shape} {str(dtype)[6:]} path {path}: max_abs_err {err:.3g} "
                  f"(atol {TOL[('gn', dtype)][0]}, rtol {TOL[('gn', dtype)][1]}), two calls "
                  f"equal bit for bit; ms {ms:.5f} plain_ms {plain_ms:.5f} library_ms "
                  f"{lib_ms:.5f} bound_ms {b[0]:.3g} ({b[1]}); {gn_plan_line(x)}", flush=True)
            if dtype == torch.bfloat16:
                record(name, path is not None, err, ms, plain_ms, lib_ms, b)
                if path == "512":
                    gn_device.append((f"{name}{shape}", k1, lib, b[0]))
    check_gn_cases(randn)

    for dtype in (torch.bfloat16, torch.float32):
        for (shape, cout), path in K3_SHAPES:
            cin = shape[-1]
            x = randn(*shape, dtype=dtype)
            w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
            gamma, beta = randn(cout), randn(cout)
            name = f"conv3x3_gn_silu{shape}->{cout} {dtype}"
            with highest_precision():
                got = fk.conv3x3_gn_silu(x, w, gamma, beta, num_groups=GROUPS)
                want = fk.conv3x3_gn_silu_plain(x, w, gamma, beta, num_groups=GROUPS)
                torch.cuda.synchronize()
                err = check_close(name, got, want, "conv")
                # K4: the same function, K images per step, equal to K3
                err4 = {}
                for k in K4_IMAGES:
                    got4 = fk.conv3x3_gn_silu_batched(x, w, gamma, beta, num_groups=GROUPS,
                                                      images=k)
                    torch.cuda.synchronize()
                    err4[k] = check_close(f"{name} images {k}", got4, want, "conv")
                    if not torch.equal(got4, got):
                        d = float((got4.float() - got.float()).abs().max())
                        raise AssertionError(f"{name} images {k}: differs from K3 by up to {d:.3g}")
                # timed with the weights in the activation dtype, as the model
                # holds them and the library call gets them; "cast" is the time
                # with float32 weights, which the wrapper casts in every call
                wx = w.to(dtype)
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)
                gl, bl = gamma.to(dtype), beta.to(dtype)
                fns = {
                    "k3": lambda: fk.conv3x3_gn_silu(x, wx, gamma, beta, num_groups=GROUPS),
                    "cast": lambda: fk.conv3x3_gn_silu(x, w, gamma, beta, num_groups=GROUPS),
                    "plain": lambda: fk.conv3x3_gn_silu_plain(x, w, gamma, beta,
                                                              num_groups=GROUPS),
                    "library": lambda: F.silu(F.group_norm(F.conv2d(xl, wl, padding=1), GROUPS,
                                                           gl, bl, 1e-5)),
                }
                for k in K4_IMAGES:
                    fns[k] = functools.partial(fk.conv3x3_gn_silu_batched, x, wx, gamma, beta,
                                               num_groups=GROUPS, images=k)
                t = time_many(fns, iters=40, rounds=9)
            ms, plain_ms, lib_ms = t["k3"], t["plain"], t["library"]
            n, h, wd, _ = shape
            out_elems = n * h * wd * cout
            nbytes = (x.numel() + 9 * cin * cout + out_elems) * x.element_size() + 8 * cout
            flops = 2 * 9 * cin * out_elems
            b = bound(nbytes, flops, dtype)
            tol = f"(atol {TOL[('conv', dtype)][0]}, rtol {TOL[('conv', dtype)][1]})"
            print(f"conv3x3_gn_silu {shape}->{cout} {str(dtype)[6:]} path {path}: "
                  f"max_abs_err {err:.3g} {tol} ms {ms:.5f} (cast {t['cast']:.5f}) plain_ms "
                  f"{plain_ms:.5f} library_ms {lib_ms:.5f} bound_ms {b[0]:.3g} ({b[1]})",
                  flush=True)
            if dtype == torch.bfloat16:
                record("conv3x3_gn_silu", path is not None, err, ms, plain_ms, lib_ms, b)
                if path == "512":  # device time by kernel: conv pass, finalize, apply pass
                    profile(fns["k3"], f"conv3x3_gn_silu {shape}->{cout} bf16", reps=10)
                    dev = {k: device_ms(fns[k]) for k in ("k3", *K4_IMAGES, "library")}
                    print(f"  device ms per call: K3 {dev['k3']:.5f}, " + ", ".join(
                        f"K4 K={k} {dev[k]:.5f} ({dev[k] / dev['k3']:.3f}x K3)"
                        for k in K4_IMAGES) + f", library {dev['library']:.5f}", flush=True)
            for k in K4_IMAGES:
                print(f"conv3x3_gn_silu_batched {shape}->{cout} images {k} {str(dtype)[6:]} "
                      f"path {path}: max_abs_err {err4[k]:.3g} {tol}, equal to K3 bit for bit; "
                      f"ms {t[k]:.5f} ({t[k] / ms:.3f}x K3) plain_ms {plain_ms:.5f} library_ms "
                      f"{lib_ms:.5f} bound_ms {b[0]:.3g} ({b[1]})", flush=True)
                if dtype == torch.bfloat16:
                    record("conv3x3_gn_silu_batched", path is not None, err4[k], t[k], plain_ms,
                           lib_ms, b)

    # a batch that K does not divide is refused on the card too, before a launch
    x6 = randn(6, 8, 8, 64, dtype=torch.bfloat16)
    w6 = randn(3, 3, 64, 64)
    ones, zeros = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    before = fk.LAUNCHES["conv3x3_gn_silu_batched"]
    for call in (lambda: fk.conv3x3_gn_silu_batched(x6, w6, ones, zeros, num_groups=GROUPS,
                                                    images=4),
                 lambda: fk.fused_conv3x3_gn_silu(x6, w6, ones, zeros, num_groups=GROUPS,
                                                  images_per_step=4)):
        try:
            call()
        except ValueError as e:
            print(f"batch 6, K=4 on the card: ValueError ({e})", flush=True)
        else:
            raise AssertionError("batch 6 with K=4 did not raise ValueError")
    if fk.LAUNCHES["conv3x3_gn_silu_batched"] != before:
        raise AssertionError("a refused K4 call launched the kernel")

    check_conv_cases(randn)
    dec1_device = []  # K5 at the path shapes, profiled at the end of the phase
    check_dec1(randn, record, dec1_device)
    # a profiler session slows the host-bound calls made after it (~1.4x at
    # 32x32 shapes on the H100): K1 and K5 are profiled after their event times
    for label, k5, b in dec1_device:
        check_launches(k5, label, n=3)
        print(f"  {label} device ms per call: {device_ms(k5):.5f}, bound {b:.5f}", flush=True)
        profile(k5, label, reps=10)
    for label, k1, lib, b in gn_device:
        check_launches(k1, label)
        dev = {"k1": device_ms(k1), "library": device_ms(lib)}
        print(f"  {label} bf16 device ms per call: {dev['k1']:.5f}, library {dev['library']:.5f} "
              f"({dev['k1'] / dev['library']:.3f}x), bound {b:.5f}", flush=True)
    profile(gn_device[0][1], f"{gn_device[0][0]} bf16", reps=10)
    return rows


def check_conv_case(name: str, x, w, gamma, beta) -> float:
    """K3 against its plain version under TOL[("conv", dtype)], and K4 at
    every K in (2, batch) that divides the batch equal to K3 bit for bit."""
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import highest_precision

    with highest_precision():
        got = fk.conv3x3_gn_silu(x, w, gamma, beta, num_groups=GROUPS)
        want = fk.conv3x3_gn_silu_plain(x, w, gamma, beta, num_groups=GROUPS)
        torch.cuda.synchronize()
        err = check_close(name, got, want, "conv")
        n = x.shape[0]
        for k in sorted({2, n}):
            if n % k == 0:
                got4 = fk.conv3x3_gn_silu_batched(x, w, gamma, beta, num_groups=GROUPS,
                                                  images=k)
                torch.cuda.synchronize()
                if not torch.equal(got4, got):
                    d = float((got4.float() - got.float()).abs().max())
                    raise AssertionError(f"{name}: K4 with images {k} differs from K3 by {d:.3g}")
    return err


def check_conv_cases(randn) -> None:
    """Phase 3, conv shapes on no model path: CONV_RAGGED, and a conv
    output with group means far above their standard deviations (the
    centred statistics must hold there), in bf16 and float32."""
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import conv2d, highest_precision

    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for shape, cout in CONV_RAGGED:
            cin = shape[-1]
            x = randn(*shape, dtype=dtype)
            w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
            worst = max(worst, check_conv_case(f"conv3x3_gn_silu{shape}->{cout} {dtype}", x, w,
                                               randn(cout), randn(cout)))
        print(f"conv3x3_gn_silu ragged {str(dtype)[6:]}: {len(CONV_RAGGED)} cases (Cin 1/8/24, "
              f"Cout 8/16/96, 6x6 and 36x20; 16x16x256->64) within {TOL[('conv', dtype)]}, "
              f"max_abs_err {worst:.3g}; K4 equal to K3 bit for bit", flush=True)

        # x near 1 in steps of 1/128, a centre tap of 1/Cin = 2^-6 and other
        # taps of 0 or +-2^-12: every output is near 1 and varies by about a
        # hundredth of that. Every product and partial sum is then a multiple
        # of 2^-19 below 2, exact in float32, so both sides have the same
        # pre-norm bits whatever their summation order, and only the
        # statistics can differ (a mean 100x the std would otherwise scale
        # the convs' f32 rounding by 100 as well)
        shape, cout = CONV_OFFSET_SHAPE
        cin = shape[-1]
        x = (1.0 + randn(*shape, scale=4.0).round().clamp(-8, 8) / 128).to(dtype)
        w = randn(3, 3, cin, cout, scale=0.6).round().clamp(-1, 1) * 2.0 ** -12
        w[1, 1] += 1.0 / cin
        with highest_precision():
            y = conv2d(x.float(), w.to(dtype).float(), padding=1)
        yg = y.reshape(shape[0], -1, GROUPS, cout // GROUPS).transpose(1, 2).reshape(
            shape[0], GROUPS, -1)
        mean, var = yg.mean(-1), yg.var(-1, unbiased=False)
        ratio = float((mean.abs() / var.sqrt()).min())
        single = float(((yg.square().mean(-1) - mean.square()) - var).abs().div(var).max())
        if ratio < CONV_OFFSET_MIN_RATIO:
            raise AssertionError(f"offset case: group mean / std {ratio:.3g} < "
                                 f"{CONV_OFFSET_MIN_RATIO}")
        err = check_conv_case(f"conv3x3_gn_silu offset {shape}->{cout} {dtype}", x, w,
                              randn(cout), randn(cout))
        print(f"conv3x3_gn_silu offset {shape}->{cout} {str(dtype)[6:]}: group mean / std >= "
              f"{ratio:.4g} (need >= {CONV_OFFSET_MIN_RATIO}; a single-pass float32 variance "
              f"there is off by up to {single:.3g} of the variance); max_abs_err {err:.3g} "
              f"within {TOL[('conv', dtype)]}; K4 equal to K3 bit for bit", flush=True)


def dec1_weights(randn) -> tuple:
    """Seeded dec1 weights, scaled as the JAX tests scale them."""
    c = 8
    return (randn(3, 3, c, c, scale=0.2), randn(3, 3, c, c, scale=0.2),
            randn(3, 3, c, c, scale=0.2), randn(c), randn(c), randn(c), randn(c),
            randn(1, 1, c, 1, scale=0.3), randn(1))


def dec1_gate(got: torch.Tensor, want: torch.Tensor, dtype) -> tuple[dict, str | None]:
    """K5's output against its plain version under DEC1_GATE[dtype]: the
    readings, and the first bound they break (None if none)."""
    g = DEC1_GATE[dtype]
    err = (got.float() - want.float()).abs()
    thr, share = g["beyond"]
    r = {"max": float(err.max()), "mean": float(err.mean()),
         "beyond": float((err > thr).float().mean())}
    if not torch.isfinite(got).all():
        return r, "non-finite output"
    if r["max"] > g["max"]:
        return r, f"max {r['max']:.3g} > {g['max']}"
    if r["mean"] > g["mean"]:
        return r, f"mean {r['mean']:.3g} > {g['mean']}"
    if r["beyond"] > share:
        return r, f"{r['beyond']:.3g} of the outputs beyond {thr} (at most {share})"
    return r, None


def check_dec1_close(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> dict:
    """K5 against its plain version; fails beyond DEC1_GATE[dtype]."""
    r, broken = dec1_gate(got, want, dtype)
    if broken:
        raise AssertionError(f"{name}: {broken}")
    return r


def dec1_controls(name: str, args: tuple, want: torch.Tensor) -> str:
    """Two rounding faults K5 could have, on the same bf16 inputs: the
    composition's rounding (statistics of the rounded h1/h2, a2 and the
    output in bf16) and none of the kernel's bf16 rounding of h1, a1 and h2
    (the plain version in float32 on the same bf16 values and weights).
    Fails unless the bf16 gate rejects both."""
    from image_enhancement_deglaring_tpu_torch.ops import dec1

    xu, xs, wa, wb, w2, *rest = args
    faults = {
        "composition": dec1.dec1_output_composition(*args)[..., 0],
        "no bf16 h1/a1/h2": dec1.dec1_output_plain(
            xu.float(), xs.float(), *(w.to(xu.dtype).float() for w in (wa, wb, w2)), *rest),
    }
    out = []
    for fault, got in faults.items():
        r, broken = dec1_gate(got, want, torch.bfloat16)
        if broken is None:
            raise AssertionError(f"{name}: the bf16 gate passes the control '{fault}' "
                                 f"(max {r['max']:.3g}, mean {r['mean']:.3g}, share "
                                 f"{r['beyond']:.3g})")
        out.append(f"{fault}: max {r['max']:.3g} mean {r['mean']:.3g} share "
                   f"{r['beyond']:.3g}, fails ({broken})")
    return "; ".join(out)


def _other_rounding(exact: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """The bf16 neighbour of ``rounded`` on the other side of ``exact``
    (float32): the value a sum on the rounding boundary takes when it lands
    on that side."""
    bits = rounded.contiguous().view(torch.int16)
    up, down = (bits + 1).view(torch.bfloat16), (bits - 1).view(torch.bfloat16)
    below = rounded.float() < exact
    # one step of the bits moves the magnitude: pick the step past ``exact``
    pick_up = (up.float() > down.float()) == below
    return torch.where(pick_up, up, down)


def dec1_error_sources(args: tuple, tile_h: int, want: dict) -> str:
    """Where K5's largest bf16 error against its plain version comes from.
    Compares the stored h1 and h2 of the kernel and of the plain version;
    at the worst output pixel, the part of the error that K5's h2 there
    explains under the plain GroupNorm affine; and which single a1 value in
    the pixel's 3x3 window, rounded to its other bf16 neighbour, moves the
    plain h2 there onto K5's in all 8 channels (the one-ulp flip upstream)."""
    from image_enhancement_deglaring_tpu_torch.ops import dec1

    dt = args[0].dtype
    out, h1, h2 = dec1._launch(*args, eps=1e-5, tile_h=tile_h)
    p1, p2 = want["h1"].to(dt), want["h2"].to(dt)
    d1, d2 = (h1.float() - p1.float()).abs(), (h2.float() - p2.float()).abs()
    err = (out - want["out"]).abs()
    b, rem = divmod(int(err.argmax()), out.shape[1] * out.shape[2])
    y, x = divmod(rem, out.shape[2])
    w_out, b_out = args[-2].reshape(-1).float(), args[-1].float().reshape(())

    def tail(h, coef):  # the 1x1 conv of a2 at one pixel
        z = h.float() * coef[0][b] + coef[1][b]
        return float((z * torch.sigmoid(z)) @ w_out + b_out)

    explained = tail(h2[b, y, x], want["coef2"]) - tail(p2[b, y, x], want["coef2"])
    total = float(out[b, y, x] - want["out"][b, y, x])
    # each plain a1 value of the pixel's 3x3 window rounded the other way:
    # h2 over the 3x3 pixels that value feeds, against K5's h2 there
    hh, ww = out.shape[1:]
    c1 = want["coef1"]
    w2 = args[4].to(dt).float()
    best = (-1, None)
    for qy in range(max(y - 1, 0), min(y + 2, hh)):
        for qx in range(max(x - 1, 0), min(x + 2, ww)):
            zq = p1[b, qy, qx].float() * c1[0][b] + c1[1][b]
            exact = zq * torch.sigmoid(zq)
            rounded = exact.to(dt)
            steps = _other_rounding(exact, rounded).float() - rounded.float()
            rows = list(range(max(qy - 1, 0), min(qy + 2, hh)))
            cols = list(range(max(qx - 1, 0), min(qx + 2, ww)))
            taps = w2[[qy - r + 1 for r in rows]][:, [qx - c + 1 for c in cols]]
            base, kern = want["h2"][b, rows][:, cols], h2[b, rows][:, cols]
            for ci in range(steps.numel()):
                tried = (base + steps[ci] * taps[:, :, ci, :]).to(dt)
                agree = int((tried == kern).sum())
                if agree > best[0]:
                    mid = float(rounded[ci].float() + steps[ci] / 2)
                    off = abs(float(exact[ci]) - mid) / abs(float(steps[ci]))
                    best = (agree, (qy - y, qx - x, ci, off, tried.numel(),
                                    int((base.to(dt) == kern).sum())))
    agree, (oy, ox, ci, off, n, plain_agree) = best
    found = ("K5's h2 equals the plain h2 around it" if plain_agree == n else
             f"the plain a1 at offset ({oy}, {ox}), channel {ci}, whose float32 value is "
             f"{off:.3g} ulp from its bf16 rounding midpoint, rounded the other way gives "
             f"K5's h2 at {agree} of the {n} values it feeds (the plain h2 agrees at "
             f"{plain_agree})")
    return (f"h1 differs at {float((d1 > 0).float().mean()):.3g} of values (max |delta| "
            f"{float(d1.max()):.3g}), h2 at {float((d2 > 0).float().mean()):.3g} (max |delta| "
            f"{float(d2.max()):.3g}); worst output ({b}, {y}, {x}): error {total:.4g}, h2 "
            f"channels differing there {int((d2[b, y, x] > 0).sum())}, explaining "
            f"{explained:.4g} under the plain affine; {found}")


def check_dec1(randn, record, dec1_device: list) -> None:
    """Phase 3, K5: the dec1 tail against its plain version, and twice, bit
    for bit, at the JAX tests' shapes and tilings and at the model's
    512x512 and 32x32 dec1 shapes; appends (label, call, bound) of the
    latter to ``dec1_device`` for their device times."""
    from image_enhancement_deglaring_tpu_torch.ops import dec1

    for dtype in (torch.bfloat16, torch.float32):
        for (shape, tile_h), path in DEC1_SHAPES:
            xu, xs = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            args = (xu, xs, *dec1_weights(randn))
            name = f"dec1_output{shape} tile_h {tile_h} {dtype}"
            got = dec1.fused_dec1_output(*args, tile_h=tile_h)
            again = dec1.fused_dec1_output(*args, tile_h=tile_h)
            want = dec1.dec1_stages_plain(*args)
            torch.cuda.synchronize()
            if got.shape != shape[:3] or got.dtype != torch.float32:
                raise AssertionError(f"{name}: output {tuple(got.shape)} {got.dtype}")
            if not torch.equal(got, again):
                d = float((got - again).abs().max())
                raise AssertionError(f"{name}: two calls differ by up to {d:.3g}")
            r = check_dec1_close(name, got, want["out"], dtype)
            k5 = functools.partial(dec1.fused_dec1_output, *args, tile_h=tile_h)
            ms = time_ms(k5)
            plain_ms = time_ms(lambda: dec1.dec1_output_plain(*args))
            comp_ms = time_ms(lambda: dec1.dec1_output_composition(*args))
            pixels = shape[0] * shape[1] * shape[2]
            nbytes = 2 * xu.numel() * xu.element_size() + 4 * pixels + 4 * (3 * 576 + 41)
            b = bound(nbytes, DEC1_FLOPS_PER_PIXEL * pixels, dtype)
            print(f"dec1_output {shape} tile_h {tile_h} (runs "
                  f"{dec1.effective_tile_h(shape[1], tile_h)}) {str(dtype)[6:]} path {path}: "
                  f"max_abs_err {r['max']:.3g} mean {r['mean']:.3g} share beyond "
                  f"{DEC1_GATE[dtype]['beyond'][0]} {r['beyond']:.3g} (gate {DEC1_GATE[dtype]}), "
                  f"two calls equal bit for bit; ms {ms:.5f} plain_ms {plain_ms:.5f} "
                  f"composition_ms {comp_ms:.5f} bound_ms {b[0]:.3g} ({b[1]})", flush=True)
            if path is not None:
                dec1_device.append((f"dec1_output{shape} {str(dtype)[6:]}", k5, b[0]))
            if dtype == torch.bfloat16 and path is not None:
                print(f"  sources: {dec1_error_sources(args, tile_h, want)}", flush=True)
                print(f"  controls: {dec1_controls(name, args, want['out'])}", flush=True)
            if dtype == torch.bfloat16:
                record("dec1_output", path is not None, r["max"], ms, plain_ms, comp_ms, b)


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
    from image_enhancement_deglaring_tpu_torch.ops import dec1
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
    dec1.reset_launch_counts()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    outs = np.stack([f.result(timeout=300) for f in futures])
    torch.cuda.synchronize()
    counts = {**fk.LAUNCHES, **dec1.LAUNCHES}
    forwards = eng.stats()["batches_dispatched"] - batches0
    eng.stop()
    print(f"served {len(frames)} frames in {forwards} device batches; launches {counts}",
          flush=True)
    # the model has no K4 or K5 switch, as the JAX model has none
    if counts != {"gn_silu_flat": 14 * forwards, "gn_silu_nhwc": 0,
                  "conv3x3_gn_silu": 4 * forwards, "conv3x3_gn_silu_batched": 0,
                  "dec1_output": 0}:
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
    want32 = {"gn_silu_flat": 12, "gn_silu_nhwc": 2, "conv3x3_gn_silu": 4,
              "conv3x3_gn_silu_batched": 0}
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
    # on the CPU the dispatchers take the composition unless forced, as the
    # JAX ones do off the TPU: route that engine's kernel sites as on the card
    with mock.patch.object(fk, "_routes_to_kernels", lambda x: True):
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
    return {k: counts[k] + counts32[k] for k in counts32}


def u8_frames(out: torch.Tensor) -> np.ndarray:
    """The engine's float -> uint8 step: clip to [0, 1], x255, truncate."""
    out = out.reshape(out.shape[:3]).float()
    return torch.floor(out.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def dec1_tail_times(model, args: tuple) -> None:
    """K5 beside the model's own dec1 tail (cuDNN convs, K1, the 1x1 conv as
    a matmul) and beside dec1_output_composition on the same activations:
    CUDA-event times, then device time by kernel kind from a profile."""
    from image_enhancement_deglaring_tpu_torch.ops import dec1
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import conv2d

    x_up, x_skip = args[:2]
    paths = {
        "K5": lambda: dec1.fused_dec1_output(*args),
        "model tail": lambda: conv2d(model.dec1(x_up, x_skip), model.output_conv_weight,
                                     model.output_conv_bias).float(),
        "composition": lambda: dec1.dec1_output_composition(*args),
    }
    for label, fn in paths.items():
        print(f"512x512 bf16 dec1 {label}: {time_ms(fn):.5f} ms", flush=True)
        profile(fn, f"512x512 bf16 dec1 {label}", reps=5)


def model_entry_points() -> dict:
    """Phase 5: K4 and K5 through their entry points on the production
    model's activations, at 512x512 and 32x32; then the dec1 bench entry.
    Returns the launches of those entry points."""
    from image_enhancement_deglaring_tpu_torch.modelio import load_lightweight_unet
    from image_enhancement_deglaring_tpu_torch.ops import dec1
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.serve import InferenceEngine
    from image_enhancement_deglaring_tpu_torch.tools import dec1_slice_bench

    launches = {"conv3x3_gn_silu_batched": 0, "dec1_output": 0}
    for size in (512, 32):
        frames = make_frames(8, size, seed=4)
        res = {}
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{size}x{size} {str(dtype)[6:]}"
            model = load_lightweight_unet(ONNX, dtype=dtype, device="cuda", pallas_gn=True,
                                          fused_blocks="auto")
            eng = InferenceEngine(model, image_size=size, max_batch_size=8,
                                  compute_dtype=dtype, warmup=False, device="cuda")
            caught = {}

            def keep(key):
                return lambda _m, args, out=None: caught.__setitem__(key, (args, out))

            hooks = [model.dec1.register_forward_pre_hook(keep("dec1"))]
            hooks += [getattr(model, k).register_forward_hook(keep(k))
                      for k in ("enc4", "bottleneck")]
            try:
                served = eng.infer_batch(frames)  # the model's own tail, as uint8
            finally:
                for hk in hooks:
                    hk.remove()
                eng.stop()

            fk.reset_launch_counts()
            dec1.reset_launch_counts()
            with torch.inference_mode():
                for key in ("enc4", "bottleneck"):
                    blk, ((xin,), yref) = getattr(model, key), caught[key]
                    for k in K4_IMAGES:
                        y = xin
                        for conv, g, b in ((blk.conv1, blk.gn1_scale, blk.gn1_bias),
                                           (blk.conv2, blk.gn2_scale, blk.gn2_bias)):
                            y = fk.fused_conv3x3_gn_silu(y, conv, g, b, num_groups=blk.groups,
                                                         images_per_step=k)
                        if not torch.equal(y, yref):
                            d = float((y.float() - yref.float()).abs().max())
                            raise AssertionError(f"{tag} {key} with images_per_step {k} "
                                                 f"differs from the block's K3 output by {d:.3g}")
                (x_up, x_skip), _ = caught["dec1"]
                args = dec1.dec1_output_args(model)
                k5 = dec1.fused_dec1_output(x_up, x_skip, **args)
            torch.cuda.synchronize()
            counts = {**fk.LAUNCHES, **dec1.LAUNCHES}
            want = {"gn_silu_flat": 0, "gn_silu_nhwc": 0, "conv3x3_gn_silu": 0,
                    "conv3x3_gn_silu_batched": 2 * 2 * len(K4_IMAGES), "dec1_output": 1}
            if counts != want:
                raise AssertionError(f"{tag}: entry-point launches {counts}, want {want}")
            if dtype == torch.bfloat16:
                for k in launches:
                    launches[k] += counts[k]
            with torch.inference_mode():
                want5 = dec1.dec1_stages_plain(x_up, x_skip, **args)
            name = f"dec1_output on {tag} activations"
            r = check_dec1_close(name, k5, want5["out"], dtype)
            res[dtype] = (u8_frames(k5), served)
            print(f"{tag} production activations: enc4 and bottleneck through "
                  f"images_per_step {K4_IMAGES} equal the model's K3 output bit for bit; "
                  f"K5 against plain: max {r['max']:.3g} mean {r['mean']:.3g} share beyond "
                  f"{DEC1_GATE[dtype]['beyond'][0]} {r['beyond']:.3g}", flush=True)
            if dtype == torch.bfloat16:
                targs = (x_up, x_skip, *(v for k, v in args.items() if k != "num_groups"))
                with torch.inference_mode():
                    print(f"  sources: {dec1_error_sources(targs, 64, want5)}", flush=True)
                    print(f"  controls: {dec1_controls(name, targs, want5['out'])}", flush=True)
                    if size == 512:
                        dec1_tail_times(model, targs)

        (k5_bf, tail_bf), (k5_32, tail_32) = res[torch.bfloat16], res[torch.float32]
        d32 = int(np.abs(k5_32.astype(np.int16) - tail_32.astype(np.int16)).max())
        print(f"{size}x{size} f32: K5 frame vs the f32 model's output: max |delta| {d32} "
              f"uint8 (need <= 1)", flush=True)
        if d32 > 1:
            raise AssertionError(f"{size}x{size} f32 K5 frames differ by {d32} levels")
        p_bf = psnr_u8(k5_bf, tail_bf)
        d_bf = int(np.abs(k5_bf.astype(np.int16) - tail_bf.astype(np.int16)).max())
        if size == 512:
            print(f"512x512 bf16: K5 frame vs the model's own tail: PSNR {p_bf:.2f} dB, max "
                  f"|delta| {d_bf} uint8 (need >= {DEC1_PSNR_GATE_DB} dB)", flush=True)
            if p_bf < DEC1_PSNR_GATE_DB:
                raise AssertionError(f"512x512 bf16 K5 vs model tail {p_bf:.2f} dB")
        else:
            # phase 4's 32x32 rule: both bf16 paths against the f32 output
            p_k, p_m = psnr_u8(k5_bf, tail_32), psnr_u8(tail_bf, tail_32)
            print(f"32x32 bf16 vs the f32 model's output: K5 frame {p_k:.2f} dB, model's "
                  f"tail {p_m:.2f} dB (K5 needs >= tail - 3 dB); K5 vs the bf16 tail "
                  f"{p_bf:.2f} dB, max |delta| {d_bf} uint8", flush=True)
            if p_k < p_m - 3.0:
                raise AssertionError(f"32x32 bf16 K5 {p_k:.2f} dB vs model tail {p_m:.2f} dB")

    dec1.reset_launch_counts()
    r = dec1_slice_bench.run()
    torch.cuda.synchronize()
    launches["dec1_output"] += dec1.LAUNCHES["dec1_output"]
    print(f"dec1_slice_bench (defaults: b{r['batch']} {r['size']}x{r['size']} {r['dtype']}, "
          f"tile_h {r['tile_h']}) on {r['device']}: composition {r['composition_ms']:.5f} ms, "
          f"K5 {r['dec1_output_ms']:.5f} ms, ratio {r['ratio']:.3f}x; max |K5 - composition| "
          f"{r['max_abs_err']:.5f}, mean {r['mean_abs_err']:.6f}; input transposes: none "
          f"(NHWC)", flush=True)
    if not r["finite"] or dec1.LAUNCHES["dec1_output"] == 0:
        raise AssertionError(f"dec1_slice_bench: finite {r['finite']}, "
                             f"launches {dec1.LAUNCHES['dec1_output']}")
    return launches


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
            profile(lambda: eng.infer_batch(frames[:b]), f"bucket {b} kernels={kernels}")
        eng.stop()


def _kernel_kind(name: str) -> str:
    low = name.lower()
    if "gnk::" in name or "conv3x3_" in name or "conv_gn_" in name or "dec1_" in name:
        return "port CUDA kernels"
    if any(k in low for k in ("conv", "fprop", "implicit", "cudnn")):
        return "cuDNN convolution"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other PyTorch kernels"


def trace_events(fn, reps: int) -> tuple[list, float]:
    """The events of a torch.profiler trace of ``reps`` synchronous calls of
    ``fn``, and the host wall seconds they took."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile as torch_profile

    with tempfile.TemporaryDirectory() as tmp:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], wall


def device_events(fn, reps: int) -> tuple[list, float]:
    """The kernels, copies and memsets of ``reps`` synchronous calls of
    ``fn`` in a torch.profiler trace, and the host wall seconds they took."""
    events, wall = trace_events(fn, reps)
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    return sorted(dev, key=lambda e: float(e["ts"])), wall


def profile(fn, label: str, reps: int = 3) -> None:
    """Where the device time of ``fn()`` goes: kernel time by kind and by
    name from a torch.profiler trace, and the device's busy share of the
    host wall time over ``reps`` synchronous calls."""
    dev, wall = device_events(fn, reps)
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
          f"{round(len(dev) / reps)} device ops per batch, busy share {busy / 1e6 / wall:.3f} "
          f"of {wall * 1e3 / reps:.3f} ms host wall per batch (profiler on)")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {us / 1e3 / reps:.3f} ms per batch ({us / busy:.1%})")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in ranked[:8]:
        print(f"    {us / 1e3 / reps:.3f} ms  {name[:100]}")
    for name, us in ranked[8:]:  # and every port kernel below the top 8
        if _kernel_kind(name) == "port CUDA kernels":
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

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"kernels built in {secs:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")

    def phase(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    rows = phase("3 kernels vs plain", check_kernels)
    launches = phase("4 serving slice", serve_slice)
    launches.update(phase("5 kernel entry points on model activations", model_entry_points))
    phase("6 throughput", throughput, card)

    src = "image_enhancement_deglaring_tpu_torch/csrc/"
    tpu = "image_enhancement_deglaring_tpu/ops/"
    meta = {
        "gn_silu_flat": (src + "gn_silu.cu", tpu + "pallas_kernels.py:251"),
        "gn_silu_nhwc": (src + "gn_silu.cu", tpu + "pallas_kernels.py:92"),
        "conv3x3_gn_silu": (src + "conv_gn_silu.cu", tpu + "pallas_kernels.py:339"),
        "conv3x3_gn_silu_batched": (src + "conv_gn_silu.cu", tpu + "pallas_kernels.py:419"),
        "dec1_output": (src + "dec1_output.cu", tpu + "pallas_dec1.py:249"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["by"], key=r["by"].get), "library_ms": r["library_ms"],
        }
        if name == "dec1_output":
            # no one PyTorch call computes the dec1 tail: its yardstick is the
            # composition of the model's ops
            row["library_ms"], row["composition_ms"] = None, r["library_ms"]
        kernels.append(row)
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")
    print(f"total {time.perf_counter() - t0:.1f} s after start of build", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
