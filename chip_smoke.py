#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``image_enhancement_deglaring_tpu_torch/csrc``;
3. hold every kernel against its plain PyTorch version at the main paths'
   shapes (K1 and K3 at the 512x512 levels also at batches 1, 2 and 4,
   the HTTP engine's smaller buckets), in bfloat16 and float32 (TF32 off),
   and time the kernel, the plain version and one PyTorch library call
   computing the same function (for the dec1 tail, which no one call
   computes, the composition of ops),
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
   bf16 LightweightUNet with ``kernels=True`` and the
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
   kernel and the device's busy share; (b) Restormer's channel LayerNorm
   (K6, ``fused_kernels.channel_layer_norm``) at the bucket-16 shapes of its
   88 sites, bf16 and float32, BiasFree and WithBias: against its plain
   version and the composition (at most 1 bf16 ulp; float32 within 1e-5),
   twice bit for bit, one launch a call, its time beside the bytes bound,
   the plain version's and the composition's; one 512x512 bf16 Restormer
   forward under inference_mode with 88 launches and no fallback, no
   further off the float32 forward than the composition's; a bucket of 16
   timed with K6 and with the composition; a grad-mode Restormer step with
   no launch (its training keeps the composition); K6 launches on no other
   path;
7. training (K1-K5 are forward-only; GroupNorm+SiLU trains through the
   training pair, ``fused_kernels.gn_silu_train``): (a) every forward-only
   kernel wrapper raises under grad mode on CUDA arguments that require
   grad, and runs under no_grad; (b) one f32 train step of the production
   model on the card inside ``highest_precision()`` against the same step
   on the CPU (loss, clipped gradients, parameters); (c) the bf16 train
   step at batch 32, 512x512: 18 launches of each training kernel a step
   and no fallback, median ms/step, img/s, peak memory, the loss falling,
   and one profiled step split into cuDNN conv forward and backward,
   GroupNorm+SiLU, the optimizer and the rest; (d) ``cli.train.main`` on
   the card over a synthetic dataset from the port's generator, 2 epochs,
   with its artifacts checked, and the train loader's host rate alone;
   (e) the training pair at the step's 18 sites (5 shapes, batch 32,
   bf16) against the composition's gradients, twice bit for bit, and
   each kernel's time beside its bytes bound; (f) the BatchNorm+ReLU
   training pair (``fused_kernels.bn_act_train``) at EnhancedUNet's 47
   sites (batch 32, 512x512; each epilogue, bf16 where the step has it):
   output and gradients against float64 (each under its own forward's
   ReLU mask) no further off than the float32 composition's, twice bit
   for bit with the running statistics, B1-B4 against their plain
   versions (B2 and B4 bit for bit from the same sums), each launch's
   time beside its bytes bound and the composition's;
   then one EnhancedUNet step (bf16, batch 32, 512x512) with 47 launches
   of each of B1-B4 and no fallback against the composition's step (the
   same dropout draws, loss, gradients, running statistics, ms), and a
   ``VmappedTrialGroup`` step that keeps the composition and counts it;
8. HTTP serving: first the host work of one request step by step (decode,
   luma, LANCZOS both ways, encode, base64) on one thread, for PNGs under
   one filter and under the filters PIL writes, decodes in 8 threads at
   once, and LANCZOS of a 4032x3024 photo both ways against dense
   products of the same taps; then ``create_server`` on the production
   weights in bf16 (kernels on, mode "both", warmed before it binds)
   answers real requests over 8 keep-alive connections: 512x512 gray and
   1024x768 RGB PNGs (the launches of K1 and K3 exactly 14 and 4 per
   ``batches_dispatched``), 1200x900 ``?mode=tile`` requests one at a time
   (14 and 4 per tile forward), then tile and resize requests at once;
   every answer against the same frame through the engine or tiler called
   directly (>= 45 dB), a JPEG upload answered 200 at the same gate, ``/stats`` and
   ``/metrics`` against the requests sent; then
   ``tools.load_test_api`` in its own process, closed loops at
   concurrency 8 on "up"-filtered uploads and on uploads under PIL's
   filters, and open loop on the latter at half its rate for 10 s: req/s
   and latency percentiles, and the server's host phases;
9. evaluation: ``evaluate`` on the production weights over 20 seeded
   synthetic SD1 triptychs at 512x512 in batches of 8 (8, 8 and a ragged
   4): float32 on the card (K1 and K3 launches exactly 14 and 4 per
   batch, its visualizations written from the step's prediction and
   decoded back) against the same loader on the CPU (the composition),
   bfloat16 with the kernels against bfloat16 without them, the
   ``cli.evaluate`` entry point in its own process against the in-process
   run (printed metrics and ``evaluation_results.txt``), and images/s at
   batch 16 end to end with the loader's share, and from batches held in
   memory;
10. multi-worker HTTP: ``create_server`` (bf16, 512, max batch 8) with its
   engine in this process and ``serve_multiprocess`` with 4 worker
   processes on one port: no worker maps libcuda or libtorch, 32 answers
   against the engine called directly (>= 45 dB) with K1 and K3 launches
   exactly 14 and 4 per batch, ``/stats`` through a worker against the
   engine's, the load tool's three loops beside phase 8's single process,
   ``stop()`` with 64 requests in flight (every one answered 200, every
   worker exits 0, the socket file gone), then ``cli.serve --workers 2``
   in its own process (``/ping``, one ``/infer``, SIGTERM exits 0);
11. resident training and the other model families (no kernel runs here):
   (a) ``cache_on_device`` over 1,536 seeded synthetic pairs at 512x512
   (SD1's full scale), bf16 inputs and f32 targets: bytes resident, their
   share of the card, the time to cache; (b) ``make_train_epoch(shuffle=
   False)`` against the per-step loop over the same 4 batches of 8, the
   production LightweightUNet in f32 under deterministic algorithms
   (losses rtol 1e-6, parameters rtol 1e-4 / atol 1e-5); (c) one shuffled
   resident epoch at SD1 scale, bf16, batch 32, device augmentation, in 8
   segments: img/s, peak memory, the busy share of one profiled segment,
   beside phase 7c's step rate and 7d's loader rate from this run; (d)
   ``train_model(resident=True, device_augment=True)`` preempted at a
   segment boundary and resumed, against an uninterrupted run: parameters
   and generator state equal bit for bit under deterministic algorithms;
   (e) ``device_augment_batch`` over 4,096 samples: its rates within 5
   binomial sigma, its draws within their bounds; (f) OptimizedUNet and
   EnhancedUNet at their published width from a seeded init carried over
   by ``load_jax_params``: the f32 forward card vs CPU, 5 bf16 train steps
   at batch 8 (EnhancedUNet's stateful), ``load_model_for_eval`` on the
   saved checkpoint and ``cli.evaluate --model`` in its own process; (g)
   ``cli.train --resident_data --augment device`` over 128 PNG triptychs:
   the production model at batch 32 for 2 epochs, EnhancedUNet at batch 8
   for 1; no kernel launches over the phase;
12. JPEG uploads and every family served: (a) the port's JPEG decoder
   (``data/jpeg.py``; the card's host has no PIL) on every committed JPEG
   fixture, each decode's pixels and luma against the sha256 digests PIL
   wrote (``tests/fixtures/jpeg/manifest.json``), its decode time; the
   phone-size (4032x3024) decode in a process of its own: its peak host
   memory over the process's base, and the longest wait of another Python
   thread meanwhile; each fixture POSTed to ``create_server`` (bf16, 512,
   the kernels on): 200 at the upload's size, >= 45 dB against the engine
   called directly on the decoded luma, K1 and K3 launches 14 and 4 per
   device batch; closed loops of one process at phase 8's request count
   on the 512x512 JPEG and the same page as a PNG, and 8 phone-size JPEG
   uploads; (b) OptimizedUNet and EnhancedUNet at their published width
   served from a ``.pth`` of seeded weights under the reference's names
   (``model_arch="auto"``, bf16, 512, mode "both"): resize and tile
   answers >= 45 dB against the engine and tiler called directly, req/s
   of a closed loop at phase 8's request count;
   EnhancedUNet behind 2 worker processes, and ``/reload`` of a second
   ``.pth`` whose answers equal its engine's at the gate and leave both
   the first model's and its own weights-with-the-first-statistics'; no
   kernel launches; (c) OptimizedUNet's f32 forward card vs CPU, module by
   module: the error each module's output carries, and its own on the
   CPU run's input;
13. the model-artifact lifecycle and int8 serving, on the production
   LightweightUNet at 512x512 with the kernels on: (a)
   ``tools.e2e_lifecycle --device cuda --size 512`` in its own process
   (synthesize 24 + 8 triptychs, validate, sweep (random, 3 trials, 2
   epochs at 32x32), train 2 epochs at the best trial's settings, export to
   ONNX, evaluate the export, the promotion gate against
   best_model.onnx, serve it, ``cli.test_api --test all``, the frontend
   proxy, SIGTERM drain): every stage PASS, the export over
   1,000,000 bytes, each stage's seconds; (b) the export against its
   checkpoint: ``load_model_for_eval`` gives the same parameters bit for
   bit, ``create_server`` on each answers the same pages at inf dB one at
   a time (K1/K3 14/4 per forward), and ``run_onnx`` on the host agrees
   with the f32 forward on the card at 64x64 within 1e-4; (c)
   ``InferenceEngine(quantize="int8")`` on best_model.onnx: >= 45 dB
   against the unquantized engine in float32 on 8 uniform random 512x512
   frames (the JAX gate's dtype and inputs), read in bf16 and on
   synthetic pages beside it; its kernels int8 on the card and their
   bytes; ``reload_params`` equal to a fresh int8 engine; bf16 img/s at
   buckets 8 and 64, int8 and not, in interleaved rounds; one /infer
   through ``cli.serve --quantize int8 --workers 2``; (d)
   ``calibrate_act_scales`` on 4 pages, then the ``act_scales`` forward
   with every site and with ``HOT_SITES_512`` at buckets 8 and 64: SNR >=
   20 dB against the exact forward, device ms and busy share beside
   ``act_scales=None``; K1/K3 14/4 per forward on every path;
14. hyperparameter sweeps on one card (``parallel.sweep``, ``cli.sweep``),
   the production LightweightUNet at full width, 512x512, bf16 unless
   said (no kernel runs in training): (a) a lock-step group of 4 trials
   with distinct lr/wd against 4 single-trial steps (``make_step_body`` +
   ``ClippedAdamW``) from the same weights, 3 steps at batch 4, in f32
   (TF32 off) and bf16 (losses, parameters, first-step gradient cosines),
   and EnhancedUNet's stateful group (two identical trials stay identical,
   its BatchNorm statistics move); (b) over 256 resident synthetic pairs,
   the group step's median ms (CUDA events, 20 steps), trial-img/s and
   peak memory at batch 16 for K = 1, 4, 8 and at batch 32 for K = 1, 4,
   beside its K trials' single steps run one after another, in turns,
   under the deterministic algorithms cli.sweep runs on the card (and
   batch 16, K = 8 under the defaults beside them); then
   ``tools.sweep_resident_bench`` (per-step against resident epochs, K = 8,
   batch 16); (c) ``python -m ...cli.sweep --method tpe --resident_data``
   (6 trials, 3 epochs, halving at eta 3, 4 trials per group) as a user
   runs it, in its own process without ``CUBLAS_WORKSPACE_CONFIG``, on 64 +
   16 PNG triptychs: its three files, every trial; the best trial's
   ``best_trial_params.npz`` served by ``InferenceEngine`` (bf16, the
   kernels on: K1/K3 14/4 per forward), and ``--method wandb`` refused with
   its pointer at tpe; (d) the same sweep sent SIGTERM after its first
   journaled group exits 0 with the resume hint, and ``--resume`` ends
   equal to (c): trials, stop epochs and reasons, best id, val losses bit
   for bit (the CLI's own deterministic algorithms); no kernel launch on the
   training paths;
15. heavy augmentation, the profiler and the tools, at 512x512 on the
   production LightweightUNet: (a) ``heavy_augment``'s host ms per pair and
   each numpy cv2 copy's, the train loader's img/s under heavy and optimized
   augmentation, then ``cli.train --augment heavy`` (bf16, batch 8, 48
   triptychs, 1 epoch of 5 steps) with (b) ``--profile_dir
   --profile_steps 5`` in the same run: its artifacts, and a trace that
   parses and holds CUDA kernel events; ``cli.serve --profile_port`` in
   this process while 8 connections post pages: one ``/trace?ms=1500``
   capture holds K1's and K3's device kernels, launches 14 and 4 per
   batch; (c) ``cli.enhance --visualize`` on 2 pages: the JAX CLI's file
   names, each figure the input's luma beside the output; (d)
   ``tools.crossval_artifact`` with best_model.onnx against itself (n 16):
   keep_incumbent at equal metrics; (e) ``tools.train_roofline`` at
   batches 8/16/32; (f) ``tools.train_synthetic_demo`` cut to 32 + 8
   triptychs x 3 epochs; (g) the native decode (g++) against the numpy
   route: equal at identity size, within one uint8 step at a resize, ms
   per triptych;
16. data parallelism (``parallel.distributed``, one process per device;
   the machine has one card): (a) ``cli.train --distributed
   --num_processes 1 --process_id 0 --coordinator_address
   127.0.0.1:<free port>`` (NCCL, a group of one) and the same run without
   it, the production LightweightUNet from seeded init, bf16, 512x512,
   batch 8, ``--resident_data``, 2 epochs of 12 steps on synthetic
   triptychs, under deterministic algorithms: final weights equal bit for
   bit, the last epoch's ms per step of both, the JAX CLI's single-process
   warning; then the step's gradient all-reduce alone (NCCL, a group of
   one, median of 50); (b) two ranks on the one card through
   ``launch_local(..., backend="gloo")`` with CUDA tensors (NCCL refuses
   two ranks on one GPU), f32 at 128x128, global batch 8, 2 epochs under
   deterministic algorithms: the ranks equal bit for bit and equal to one
   process within rtol 1e-5; (c) ``evaluate`` over the two ranks, bf16
   with the kernels, 16 pages at 512x512 in batches of 8: |dPSNR| <= 0.01
   dB against one rank, K1/K3 14/4 per forward (each rank's counts,
   summed); (d) ``cli.train --n_devices 2`` prints the JAX CLI's clamp
   message and trains on the one card;
17. serving and sweeps over several devices (the machine has one card):
   (a) ``InferenceEngine`` over a ``LocalMesh`` of two replicas on cuda:0
   (every card on a machine with more), bf16 with the kernels at 512x512:
   8 frames and a ragged 3, each replica's slice equal bit for bit to one
   engine's forward at its rows and >= 45 dB of one engine's forward of
   the whole bucket, buckets multiples of the mesh size, K1/K3 14/4 per
   replica forward, img/s at bucket 64 of no mesh, a one-replica mesh and
   the two replicas in turns (the split's cost, not scaling); (b)
   ``create_server(mode="both", mesh=)``: 32 pages over 8 connections and
   a 1200x900 tile request >= 45 dB of one engine / tiler, K1/K3 per
   replica forward; (c) ``cli.enhance`` / ``cli.serve --data_parallel 2``
   print the JAX CLIs' clamp message and run on one card; (d)
   ``run_sweep(mesh=)`` over two Gloo ranks on the card (f32 128x128, the
   production LightweightUNet, 4 trials x 2 epochs, deterministic
   algorithms) against one process: the best trial, per-trial best val
   losses within rtol 1e-5, rank 0 alone writing, a preempted sweep resumed
   from rank 0's journal equal to the uninterrupted one; (e) ``cli.sweep
   --distributed`` as an NCCL group of one against the same run without
   it, bit for bit.

The line before the last is a JSON object with one entry per kernel, its
launches also by path (each counted from 0 in its own run; the
microbenchmarks of phases 3 and 7e give times and errors, not launches); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.

``--soak SECONDS`` repeats phases 15 and 16 until SECONDS have passed,
before phase 17, under the state the earlier phases leave, printing each
pass and the live threads: a search for an intermittent native crash in
that stretch. A fatal signal prints every thread's Python stack
(``faulthandler``).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import faulthandler
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
# the kernels that serve (K1-K5); the training pair launches on training paths
FORWARD_ONLY = ("gn_silu_flat", "gn_silu_nhwc", "conv3x3_gn_silu", "conv3x3_gn_silu_batched",
                "dec1_output")


def forward_only(counts: dict) -> dict:
    """The launches of ``counts`` by the forward-only kernels."""
    return {k: v for k, v in counts.items() if k in FORWARD_ONLY}


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
# for the batch-8 512x512 and 32x32 forwards that serve_slice drives,
# "http" for the 512x512 forwards of the HTTP server's smaller buckets, None
# for a shape checked but on no path. Only path shapes reach the JSON line.
K1_SHAPES = [((8, 512, 512, 8), "512"), ((8, 256, 256, 16), "512"),
             ((8, 128, 128, 32), "512"), ((8, 64, 64, 64), "512"),
             ((8, 32, 32, 128), None),  # the 512x512 bottleneck level, which K3 takes
             ((8, 32, 32, 8), "32"), ((8, 16, 16, 16), "32"), ((8, 8, 8, 32), "32")]
# the HTTP server's engine (max batch 8) pads to buckets 1, 2, 4 and 8, and
# mostly runs the small ones (its mean batch fill reads ~1.4): K1's wave
# plan and K3's persistent grid depend on the batch
HTTP_BUCKETS = (1, 2, 4)
K1_SHAPES += [((n, *s[1:]), "http") for s, p in K1_SHAPES if p == "512" for n in HTTP_BUCKETS]
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
K3_SHAPES += [(((n, *s[1:]), c), "http") for (s, c), p in K3_SHAPES if p == "512"
              for n in HTTP_BUCKETS]
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

# phase 7: the trainer's defaults (cli.train) and the f32 step on the card
# against the same step on the CPU, production weights, batch 2 at 128x128.
# Gates: the loss's relative difference; the clipped gradients' largest
# difference over the largest magnitude of their leaf; the parameters after
# the step, whose differences Adam's first step turns into up to 2 * lr
# where a gradient near 0 takes another sign, so also the share of them
# beyond 1e-6. Read on the H100 (PERF.md): 2.88e-07, 1.75e-05,
# 7.62e-05 and 6.58e-04; the gates leave about 7x, 11x, the 2 * lr bound
# and 7.6x.
TRAIN_LR, TRAIN_WD = 0.002362532125818593, 6.753784966611083e-05
TRAIN_F32_GATE = {"loss_rel": 2e-6, "grad_rel": 2e-4, "param_max": 2 * TRAIN_LR,
                  "param_share_beyond_1e-6": 5e-3}
TRAIN_BATCH, TRAIN_SIZE, TRAIN_WARMUP, TRAIN_STEPS = 32, 512, 3, 20


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


def device_ms(fn, reps: int = 10, traces: int = 3) -> float:
    """Device time of one call: for each kernel or copy of a torch.profiler
    trace of ``reps`` calls, its mean duration times its runs per call
    (count / reps, rounded: a trace taken after an earlier profiler session
    can miss an event). The host's cost, which sets CUDA-event times below
    ~0.1 ms, does not enter. A trace with no device event at all (the
    profiler can drop them) is taken again, up to ``traces`` times; then
    the device time is not measured and this raises."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total / e.count * round(e.count / reps)
                    for e in prof.key_averages() if e.count) / 1e3
        if total > 0:
            return total
    raise AssertionError(f"torch.profiler recorded no device time in {traces} traces")


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
                k4 = [k for k in K4_IMAGES if shape[0] % k == 0]
                for k in k4:
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
                for k in k4:
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
            for k in k4:
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


def make_frames(n: int, s: int, seed: int, w: int | None = None) -> np.ndarray:
    """Seeded grayscale pages: a smooth background, a bright glare spot,
    sensor noise; uint8 (n, s, w), w = s by default."""
    rng = np.random.default_rng(seed)
    w = s if w is None else w
    yy, xx = np.mgrid[0:s, 0:w]
    yy, xx = yy / s, xx / w
    out = np.empty((n, s, w), np.uint8)
    for i in range(n):
        fx, fy, cx, cy = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.random(), rng.random()
        page = 0.55 + 0.25 * np.sin(2 * np.pi * (fx * xx + fy * yy))
        glare = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.03)
        img = page + 0.45 * glare + 0.04 * rng.standard_normal((s, w))
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
        model = load_lightweight_unet(ONNX, dtype=dtype, device=device, kernels=kernels)
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
    if forward_only(counts) != {"gn_silu_flat": 14 * forwards, "gn_silu_nhwc": 0,
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
    if forward_only(counts32) != want32:
        raise AssertionError(f"32x32 forward: want 12/2/4 launches, got {counts32}")

    # the same dispatch in float32 tells kernel faults from bf16 rounding
    fk.reset_launch_counts()
    got_small32 = engine(torch.float32, True, 32, max_batch_size=8, warmup=False).infer_batch(small)
    if forward_only(fk.LAUNCHES) != want32:
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
            model = load_lightweight_unet(ONNX, dtype=dtype, device="cuda", kernels=True)
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
            if forward_only(counts) != want:
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
                                      kernels=kernels)
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
    if ("gnk::" in name or "lnk::" in name or "conv3x3_" in name or "conv_gn_" in name
            or "dec1_" in name):
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


def triptych_batch(n: int, size: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(glared, ground truth) float32 NHWC in [0, 1] of ``n`` seeded SD1
    triptychs from the port's generator: its thirds, gray (R = G = B)."""
    from image_enhancement_deglaring_tpu_torch.data.synthetic import make_triptych

    rng = np.random.default_rng(seed)
    trips = [make_triptych(rng, size) for _ in range(n)]
    x = np.stack([t[:, size:2 * size, 0] for t in trips]).astype(np.float32)[..., None] / 255.0
    y = np.stack([t[:, :size, 0] for t in trips]).astype(np.float32)[..., None] / 255.0
    return x, y


def grad_guard() -> None:
    """Phase 7a: every kernel wrapper raises under grad mode on CUDA inputs
    that require grad, and runs under no_grad."""
    from image_enhancement_deglaring_tpu_torch.ops import dec1
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(7)

    def t(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", dtype=dtype, generator=gen)

    bf = torch.bfloat16
    g8, b8, g64, b64 = t(8), t(8), t(64), t(64)
    w64, w8 = t(3, 3, 64, 64) * 0.05, t(3, 3, 8, 8) * 0.1
    calls = {
        "gn_silu_flat": (lambda x, g, b: fk.gn_silu_flat(x, g, b, num_groups=8),
                         t(2, 32, 32, 8, dtype=bf), g8, b8),
        "gn_silu_nhwc": (lambda x, g, b: fk.gn_silu_nhwc(x, g, b, num_groups=8),
                         t(2, 8, 8, 64, dtype=bf), g64, b64),
        "conv3x3_gn_silu": (lambda x, w, g, b: fk.conv3x3_gn_silu(x, w, g, b, num_groups=8),
                            t(2, 16, 16, 64, dtype=bf), w64, g64, b64),
        "conv3x3_gn_silu_batched": (
            lambda x, w, g, b: fk.conv3x3_gn_silu_batched(x, w, g, b, num_groups=8, images=2),
            t(2, 16, 16, 64, dtype=bf), w64, g64, b64),
        "fused_dec1_output": (
            lambda xu, xs, w, g, b, wo, bo: dec1.fused_dec1_output(xu, xs, w, w, w, g, b, g, b,
                                                                   wo, bo),
            t(2, 64, 64, 8, dtype=bf), t(2, 64, 64, 8, dtype=bf), w8, g8, b8,
            t(1, 1, 8, 1), t(1)),
        "channel_layer_norm": (lambda x, w, b: fk.channel_layer_norm(x, w, b),
                               t(2, 8, 8, 48, dtype=bf), t(48), t(48)),
    }
    for name, (fn, *args) in calls.items():
        for which in range(len(args)):  # one argument at a time requires grad
            grad_args = [a.clone().requires_grad_(i == which) for i, a in enumerate(args)]
            try:
                fn(*grad_args)
            except RuntimeError as e:
                if "forward-only" not in str(e):
                    raise
            else:
                raise AssertionError(f"{name} ran under grad mode with argument {which} "
                                     f"requiring grad")
        with torch.no_grad():
            out = fn(*[a.clone().requires_grad_(True) for a in args])
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name} under no_grad: non-finite output")
    print(f"7a grad guard: {len(calls)} kernel wrappers raise under grad mode with any one "
          f"CUDA argument requiring grad, and run under no_grad", flush=True)


def train_f32_parity() -> None:
    """Phase 7b: one f32 train step of the production model (batch 2,
    128x128) on the card inside highest_precision(), against the same step
    on the CPU."""
    from image_enhancement_deglaring_tpu_torch.modelio import (
        export_jax_params,
        load_lightweight_unet,
    )
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import highest_precision
    from image_enhancement_deglaring_tpu_torch.train import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

    x, y = triptych_batch(2, 128, seed=5)
    res = {}
    for device in ("cuda", "cpu"):
        model = load_lightweight_unet(ONNX, dtype=torch.float32, device=device)
        state = TrainState(model=model, optimizer=make_optimizer(model, TRAIN_LR, TRAIN_WD))
        with highest_precision():
            state, loss = make_train_step()(state, torch.from_numpy(x).to(device),
                                            torch.from_numpy(y).to(device))
        grads = {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()}
        res[device] = (float(loss), grads, flatten_tree(export_jax_params(model)))
    (lc, gc, pc), (lh, gh, ph) = res["cuda"], res["cpu"]
    loss_rel = abs(lc - lh) / abs(lh)
    grad_rel = max(float(np.abs(gc[k] - gh[k]).max() / np.abs(gh[k]).max()) for k in gh)
    diffs = np.concatenate([np.abs(pc[k] - ph[k]).ravel() for k in ph])
    share = float((diffs > 1e-6).mean())
    print(f"7b f32 train step, card vs CPU (production weights, 2x128x128): loss {lc:.7f} vs "
          f"{lh:.7f}, rel diff {loss_rel:.3g}; clipped gradients max rel diff {grad_rel:.3g}; "
          f"parameters after the step max |diff| {diffs.max():.3g}, share beyond 1e-6 "
          f"{share:.3g} of {diffs.size} (gates {TRAIN_F32_GATE})", flush=True)
    got = {"loss_rel": loss_rel, "grad_rel": grad_rel, "param_max": float(diffs.max()),
           "param_share_beyond_1e-6": share}
    bad = {k: v for k, v in got.items() if not v <= TRAIN_F32_GATE[k]}
    if bad:
        raise AssertionError(f"f32 train step card vs CPU beyond its gates: {bad}")


def _train_kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("dgrad", "wgrad", "fprop")):
        return "conv"
    return "conv" if _kernel_kind(name) == "cuDNN convolution" else "other"


def train_step_split(fn, label: str) -> None:
    """Device time of one ``fn()`` (a train step) by part: cuDNN conv
    forward and backward, GroupNorm+SiLU (forward, and the backward of its
    ops), the optimizer (AdamW's step), copies and the rest, and the
    device's busy share of the host wall. A kernel belongs to the CPU ops
    around the runtime or driver call that launched it (the trace's
    correlation id); backward ops run inside
    ``autograd::engine::evaluate_function`` ranges whose sequence numbers
    name the forward op they differentiate; GroupNorm+SiLU is annotated
    by patching the model's ``_gn_silu_fn`` for this one step."""
    from image_enhancement_deglaring_tpu_torch.ops import conv_blocks as cb

    orig = cb._gn_silu_fn

    def annotated(*a, **k):
        f = orig(*a, **k)

        def gn_silu(*args):
            with torch.profiler.record_function("GroupNorm+SiLU"):
                return f(*args)
        return gn_silu

    with mock.patch.object(cb, "_gn_silu_fn", annotated):
        events, wall = trace_events(fn, 1)
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e]
    ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation") and "dur" in e]

    def ranges(prefix):
        return [(e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                for e in ops if e["name"].startswith(prefix)]

    gn, opt = ranges("GroupNorm+SiLU"), ranges("Optimizer.step#")
    bwd = ranges("autograd::engine::evaluate_function")

    def inside(op, rs):
        return next((r[3] for r in rs if r[0] == op["tid"] and r[1] <= float(op["ts"]) <= r[2]),
                    None)

    # the runtime or driver call that launched a kernel shares its correlation id
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    gn_seq = {e["args"]["Sequence number"] for e in ops
              if e["cat"] == "cpu_op" and "Sequence number" in e.get("args", {})
              and inside(e, gn) is not None}
    by_kind: dict[str, float] = {}
    by_name: dict[tuple, float] = {}
    for k in dev:
        op = launch.get(k.get("args", {}).get("correlation"))
        if k["cat"] != "kernel":
            kind = "copies"
        elif op is None:
            kind = "unattributed"
        elif inside(op, opt) is not None:
            kind = "optimizer (AdamW step)"
        else:
            ev = inside(op, bwd)
            if _train_kind(k["name"]) == "conv":
                kind = "cuDNN conv backward" if ev is not None else "cuDNN conv forward"
            elif inside(op, gn) is not None or (
                    ev is not None and ev["args"].get("Sequence number") in gn_seq):
                kind = "GroupNorm+SiLU (forward and backward)"
            else:
                kind = "other"
        by_kind[kind] = by_kind.get(kind, 0.0) + float(k["dur"])
        by_name[(kind, k["name"])] = by_name.get((kind, k["name"]), 0.0) + float(k["dur"])
    busy, end = 0.0, -math.inf
    for s, t in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev):
        if t > end:
            busy += t - max(s, end)
            end = t
    print(f"profile {label}: device busy {busy / 1e3:.3f} ms, {len(dev)} device ops, busy share "
          f"{busy / 1e6 / wall:.3f} of {wall * 1e3:.3f} ms host wall (profiler on)")
    total = sum(by_kind.values())
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {us / 1e3:.3f} ms ({us / total:.1%} of kernel+copy time)")
    for (kind, name), us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:.3f} ms  [{kind}] {name[:90]}")


def train_throughput(card: str) -> tuple[float, dict]:
    """Phase 7c: the bf16 train step at full width (production weights,
    batch 32, 512x512, a seeded synthetic batch), 3 warm-up then 20 timed
    steps. Returns its img/s and the first step's launches, counted from
    0 just before it."""
    from image_enhancement_deglaring_tpu_torch.modelio import load_lightweight_unet
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.train import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    xn, yn = triptych_batch(TRAIN_BATCH, TRAIN_SIZE, seed=6)
    # as the loader ships them: the input in bf16, the target in f32
    x = torch.from_numpy(xn).to("cuda", torch.bfloat16)
    y = torch.from_numpy(yn).to("cuda")
    model = load_lightweight_unet(ONNX, dtype=torch.bfloat16, device="cuda")
    state = TrainState(model=model, optimizer=make_optimizer(model, TRAIN_LR, TRAIN_WD))
    step = make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(TRAIN_WARMUP):
        fk.reset_launch_counts()
        state, loss = step(state, x, y)
        losses.append(loss)
        if i == 0:  # every GroupNorm+SiLU site through the training pair
            launches, fallbacks = dict(fk.LAUNCHES), dict(fk.TRAIN_FALLBACKS)
            if ({k: v for k, v in launches.items() if v} != {"gn_silu_train_fwd": 18,
                                                              "gn_silu_train_bwd": 18}
                    or any(fallbacks.values())):
                raise AssertionError(f"7c one step launched {launches}, fallbacks {fallbacks}; "
                                     f"want 18 of each training kernel and none else")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(TRAIN_STEPS):
        state, loss = step(state, x, y)
        losses.append(loss)
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = sorted(marks[i].elapsed_time(marks[i + 1]) for i in range(TRAIN_STEPS))
    med = per[len(per) // 2]
    peak = torch.cuda.max_memory_allocated()
    lv = torch.stack(losses).float().cpu().numpy()
    # the production weights are trained: the first step from a fresh Adam
    # state moves every weight by ~lr and the loss jumps, so "falling" is
    # read over the timed steps: their last five against their first five
    timed = lv[TRAIN_WARMUP:]
    first, last = float(timed[:5].mean()), float(timed[-5:].mean())
    print(f"7c bf16 train step, production LightweightUNet, batch {TRAIN_BATCH}, "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}: median {med:.3f} ms/step (min {per[0]:.3f}, max "
          f"{per[-1]:.3f}) over {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
          f"{TRAIN_BATCH / med * 1e3:.1f} img/s; host wall {wall * 1e3 / TRAIN_STEPS:.3f} ms/step; "
          f"peak memory allocated {peak / 2**30:.3f} GiB; losses "
          f"{' '.join(f'{v:.5f}' for v in lv)} (timed steps: first five {first:.5f}, last "
          f"five {last:.5f}) on {card}; one step's launches {launches}, fallbacks "
          f"{fallbacks}", flush=True)
    if not np.isfinite(lv).all() or not last < first:
        raise AssertionError(f"train losses not finite and falling over the timed steps: {lv}")
    train_step_split(lambda: step(state, x, y), f"bf16 train step b{TRAIN_BATCH} "
                     f"{TRAIN_SIZE}x{TRAIN_SIZE}")
    return TRAIN_BATCH / med * 1e3, launches


def train_entry_point() -> tuple[float, float]:
    """Phase 7d: ``cli.train.main`` on the card over a synthetic dataset
    from the port's generator (16 train + 4 val at 512), 2 epochs of batch
    8; its artifacts, where its parameters lived, and model_weights.npz
    loaded into a fresh model; then the train loader's host rate alone,
    decoding every pass and with ``cache_images``, which it returns."""
    import contextlib
    import io
    import tempfile

    import image_enhancement_deglaring_tpu_torch.train as train_pkg
    from image_enhancement_deglaring_tpu_torch.cli import train as cli_train
    from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1, make_dataloaders
    from image_enhancement_deglaring_tpu_torch.modelio import load_jax_params
    from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
    from image_enhancement_deglaring_tpu_torch.utils import load_npz_tree

    seen = {}
    orig = train_pkg.train_model

    def recording(model, *a, **k):
        out = orig(model, *a, **k)
        seen["devices"] = {str(p.device) for p in out[3].model.parameters()}
        seen["best"] = out[0]
        return out

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        generate_synthetic_sd1(os.path.join(tmp, "data"), n_train=16, n_val=4, size=512,
                               seed=0)
        t_data = time.perf_counter() - t0
        out_dir = os.path.join(tmp, "run")
        log = Tee()
        t0 = time.perf_counter()
        with mock.patch.object(train_pkg, "train_model", recording), \
                contextlib.redirect_stdout(log):
            cli_train.main(["--data_dir", os.path.join(tmp, "data"), "--output_dir", out_dir,
                            "--epochs", "2", "--batch_size", "8",
                            "--validation_metrics_every", "1"])
        t_run = time.perf_counter() - t0
        text = log.getvalue()
        missing = [f for f in ("best_model", "final_model", "model_weights.npz",
                               "logs/metrics.jsonl") if not os.path.exists(os.path.join(out_dir, f))]
        epochs = [line for line in text.splitlines() if line.startswith("Epoch ")]
        tree = load_npz_tree(os.path.join(out_dir, "model_weights.npz"))
        fresh, kept = LightweightUNet(), LightweightUNet()
        load_jax_params(fresh, tree)
        load_jax_params(kept, seen["best"])
        xn, _ = triptych_batch(2, 512, seed=8)
        with torch.no_grad():
            xs = torch.from_numpy(xn).cuda()
            same = torch.equal(fresh.cuda()(xs), kept.cuda()(xs))
        # the host side of the same path: the train loader alone, 3 passes
        rates = {}
        for cache in (False, True):
            loader, _ = make_dataloaders(os.path.join(tmp, "data"), batch_size=8,
                                         image_size=512, num_workers=4, cache_images=cache)
            t0, n = time.perf_counter(), 0
            for _ in range(3):
                for xb, _yb in loader:
                    n += xb.shape[0]
            rates[cache] = n / (time.perf_counter() - t0)
    print(f"7d cli.train on cuda: data written in {t_data:.1f} s, 2 epochs in {t_run:.1f} s; "
          f"epoch lines {len(epochs)}; parameters on {sorted(seen['devices'])}; missing "
          f"artifacts {missing}; model_weights.npz forward equal to the returned best "
          f"parameters' {same}; the train loader alone (512x512, batch 8, 4 threads, "
          f"optimized augmentation) {rates[False]:.1f} img/s decoding every pass, "
          f"{rates[True]:.1f} img/s with cache_images", flush=True)
    if (len(epochs) != 2 or missing or seen["devices"] != {"cuda:0"} or not same
            or "Training completed" not in text):
        raise AssertionError("cli.train on the card did not give its per-epoch lines, "
                             "artifacts and cuda parameters")
    return rates[False], rates[True]


# phase 7e: the GroupNorm+SiLU training pair at LightweightUNet's 18 sites of
# the bf16 step at batch 32, 512x512: (side, channels, sites a step)
TRAIN_GN_SITES = ((512, 8, 4), (256, 16, 4), (128, 32, 4), (64, 64, 4), (32, 128, 2))


def train_gn_kernels() -> dict:
    """Phase 7e: ``gn_silu_train`` at the training sites' five shapes, bf16:
    its output, dx, dgamma and dbeta against the float32 composition's,
    each no further off than the bf16 composition's own; a second call
    equal bit for bit; the kernels against their plain versions; each
    kernel's time beside its bytes bound (x, dy read once, the output
    written once), the plain versions' and the composition's forward and
    backward, and their sums over a step's 18 sites. Returns the kernel
    rows; its launches (a microbenchmark's) are printed, not counted on a
    path."""
    from image_enhancement_deglaring_tpu_torch.ops import conv_blocks as cb
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    def comp(x, g, b):
        return cb.silu(cb.group_norm(x, g, b, num_groups=GROUPS))

    def pair(x, g, b):
        return fk.gn_silu_train(x, g, b, num_groups=GROUPS)

    def outputs(fn, x, g, b, dy):
        x, g, b = (t.detach().clone().requires_grad_() for t in (x, g, b))
        y = fn(x, g, b)
        return (y,) + torch.autograd.grad(y, (x, g, b), dy.to(x.dtype))

    def rel(a, r):
        return float((a.float() - r.float()).norm() / r.float().norm())

    gen = torch.Generator(device="cuda").manual_seed(71)
    rows = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "by": {"bytes": 0.0}}
            for k in ("gn_silu_train_fwd", "gn_silu_train_bwd")}
    per_step = {"pair": 0.0, "bound": 0.0, "composition": 0.0}
    fk.reset_launch_counts()
    for side, ch, sites in TRAIN_GN_SITES:
        shape = (TRAIN_BATCH, side, side, ch)
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).bfloat16()
        g = torch.randn(ch, device="cuda", generator=gen) * 0.5 + 1
        b = torch.randn(ch, device="cuda", generator=gen) * 0.5
        dy = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        got, again = outputs(pair, x, g, b, dy), outputs(pair, x, g, b, dy)
        ref = outputs(comp, x.float(), g, b, dy.float())
        err = [rel(p, r) for p, r in zip(got, ref)]
        err_bf16 = [rel(p, r) for p, r in zip(outputs(comp, x, g, b, dy), ref)]
        with torch.no_grad():
            y, stats = fk.gn_silu_train_fwd(x, g, b, num_groups=GROUPS)
            dx = fk.gn_silu_train_bwd(x, dy, g, b, stats, num_groups=GROUPS)[0]
            y_plain, stats_plain = fk.gn_silu_train_fwd_plain(x, g, b, num_groups=GROUPS)
            dx_plain = fk.gn_silu_train_bwd_plain(x, dy, g, b, stats, num_groups=GROUPS)[0]
        torch.cuda.synchronize()
        label = f"7e {TRAIN_BATCH}x{side}^2x{ch} bf16 ({sites} sites)"
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError(f"{label}: two calls differ")
        if any(not e <= e_bf16 for e, e_bf16 in zip(err, err_bf16)):
            raise AssertionError(f"{label}: out/dx/dgamma/dbeta off the float32 composition by "
                                 f"{err}, the bf16 composition by {err_bf16}")
        errs = {"gn_silu_train_fwd": check_close(label + " forward", y, y_plain, "gn"),
                "gn_silu_train_bwd": check_close(label + " dx", dx, dx_plain, "gn")}
        stats_rel = float(((stats - stats_plain) / stats_plain.abs().clamp_min(1e-6)).abs().max())
        with torch.no_grad():
            ms = time_many({
                "gn_silu_train_fwd": lambda: fk.gn_silu_train_fwd(x, g, b, num_groups=GROUPS),
                "gn_silu_train_bwd": lambda: fk.gn_silu_train_bwd(x, dy, g, b, stats,
                                                                  num_groups=GROUPS),
                "fwd_plain": lambda: fk.gn_silu_train_fwd_plain(x, g, b, num_groups=GROUPS),
                "bwd_plain": lambda: fk.gn_silu_train_bwd_plain(x, dy, g, b, stats,
                                                                num_groups=GROUPS)})
        xg, gg, bg = (t.detach().clone().requires_grad_() for t in (x, g, b))
        yg = comp(xg, gg, bg)
        ms.update(time_many({
            "comp_fwd": lambda: comp(xg, gg, bg),
            "comp_bwd": lambda: torch.autograd.grad(yg, (xg, gg, bg), dy, retain_graph=True)}))
        nbytes = x.numel() * x.element_size()
        bounds = {"gn_silu_train_fwd": 2 * nbytes / HBM_BYTES_S * 1e3,
                  "gn_silu_train_bwd": 3 * nbytes / HBM_BYTES_S * 1e3}
        for k, plain, library in (("gn_silu_train_fwd", "fwd_plain", "comp_fwd"),
                                  ("gn_silu_train_bwd", "bwd_plain", "comp_bwd")):
            r = rows[k]
            r["max_abs_err"] = max(r["max_abs_err"], errs[k])
            r["ms"] += ms[k]
            r["plain_ms"] += ms[plain]
            r["library_ms"] += ms[library]
            r["bound_ms"] += bounds[k]
            r["by"]["bytes"] += bounds[k]
        per_step["pair"] += sites * (ms["gn_silu_train_fwd"] + ms["gn_silu_train_bwd"])
        per_step["bound"] += sites * sum(bounds.values())
        per_step["composition"] += sites * (ms["comp_fwd"] + ms["comp_bwd"])
        print(f"{label}: off the float32 composition out/dx/dgamma/dbeta "
              f"{', '.join(f'{e:.3g}' for e in err)} (bf16 composition "
              f"{', '.join(f'{e:.3g}' for e in err_bf16)}); two calls equal; stats vs plain "
              f"rel {stats_rel:.3g}; ms forward {ms['gn_silu_train_fwd']:.5f} (bound "
              f"{bounds['gn_silu_train_fwd']:.5f}, plain {ms['fwd_plain']:.5f}, composition "
              f"{ms['comp_fwd']:.5f}), backward {ms['gn_silu_train_bwd']:.5f} (bound "
              f"{bounds['gn_silu_train_bwd']:.5f}, plain {ms['bwd_plain']:.5f}, composition "
              f"{ms['comp_bwd']:.5f})", flush=True)
    torch.cuda.synchronize()
    counts = {k: fk.LAUNCHES[k] for k in rows}
    print(f"7e a step's 18 sites: training pair {per_step['pair']:.3f} ms (bound "
          f"{per_step['bound']:.3f} ms, {per_step['bound'] / per_step['pair']:.1%} of it), "
          f"composition {per_step['composition']:.3f} ms; launches {counts}", flush=True)
    return rows


# phase 7f: the BatchNorm+ReLU training pair at EnhancedUNet's 47 sites of
# the step at batch 32, 512x512 (_bn_sites: side, channels, epilogue, input
# dtype, sites a step). Per level: bn1 (ReLU), shortcut_bn (none), bn2 (add+ReLU)
# of the encoder's and the decoder's block, the attention gate's bn_g,
# bn_x (add+ReLU) at half width and bn_psi at one channel; the bottleneck's
# two (ReLU). enc1's bn1 and shortcut_bn read the bf16 input's convs.
def _bn_sites() -> tuple:
    sites = []
    for level in range(5):
        side, w = TRAIN_SIZE >> level, FAMILY_WIDTH << level
        for act in ("relu", None, "add_relu"):
            first = level == 0 and act != "add_relu"
            if first:
                sites.append((side, w, act, torch.bfloat16, 1))
            sites.append((side, w, act, torch.float32, 1 if first else 2))
        sites += [(side, w // 2, None, torch.float32, 1),
                  (side, w // 2, "add_relu", torch.float32, 1), (side, 1, None, torch.float32, 1)]
    sites.append((TRAIN_SIZE >> 5, FAMILY_WIDTH << 5, "relu", torch.float32, 2))
    return tuple(sites)


BN_KERNELS = ("bn_train_stats", "bn_train_apply", "bn_train_bwd_sums", "bn_train_bwd_apply")
# the EnhancedUNet step against the composition's (relative): loss; the
# norm of all gradients' and of all running statistics' difference, which
# carry the rounding of every layer before them through TF32 convs; the
# first BatchNorm's statistics (enc1.bn1, whose input both steps share)
BN_STEP_GATE = {"loss_rel": 1e-4, "grad_rel": 0.01, "stats_rel": 0.01, "first_stats_rel": 1e-5}


def _bn_composition(c: int, g, b):
    """The model's BatchNorm with parameters (g, b), as a function of (x,
    act, residual) that runs its float32 composition on the card."""
    from image_enhancement_deglaring_tpu_torch.models.enhanced_unet import BatchNorm
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    bn = BatchNorm(c, device="cuda")
    with torch.no_grad():
        bn.scale.copy_(g)
        bn.bias.copy_(b)

    def fn(x, act, r):
        with mock.patch.object(fk, "_routes_to_kernels", lambda t: False):
            return bn(x, True, act=act, residual=r)
    return bn, fn


def train_bn_kernels() -> tuple[dict, dict]:
    """Phase 7f: ``bn_act_train`` at EnhancedUNet's 47 training sites
    (``_bn_sites``), then one EnhancedUNet step through it and one
    ``VmappedTrialGroup`` step. Returns the kernel rows and the step's
    launches (a path: B1-B4 at all 47 sites)."""
    from image_enhancement_deglaring_tpu_torch.models import EnhancedUNet
    from image_enhancement_deglaring_tpu_torch.models import enhanced_unet as eu
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.ops.metrics import l1_loss
    from image_enhancement_deglaring_tpu_torch.parallel import Trial, VmappedTrialGroup

    def rel(a, r):
        return float((a.double() - r.double()).norm() / r.double().norm().clamp_min(1e-30))

    gen = torch.Generator(device="cuda").manual_seed(73)
    rows = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "by": {"bytes": 0.0}} for k in BN_KERNELS}
    per_step = {"pair": 0.0, "bound": 0.0, "composition": 0.0}
    fk.reset_launch_counts()
    for side, ch, epi, dtype, sites in _bn_sites():
        shape = (TRAIN_BATCH, side, side, ch)
        n = TRAIN_BATCH * side * side * ch
        act = None if epi is None else "relu"
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
        g = torch.randn(ch, device="cuda", generator=gen) * 0.5 + 1
        b = torch.randn(ch, device="cuda", generator=gen) * 0.5
        r = torch.randn(shape, device="cuda", generator=gen) if epi == "add_relu" else None
        dy = torch.randn(shape, device="cuda", generator=gen)
        bn, comp = _bn_composition(ch, g, b)

        def pair_out(running):
            xs, gs, bs = (t.detach().clone().requires_grad_() for t in (x, g, b))
            rs = None if r is None else r.clone().requires_grad_()
            y = fk.bn_act_train(xs, gs, bs, act=act, residual=rs, running=running)
            return (y,) + torch.autograd.grad(y, [xs, gs, bs] + ([rs] if r is not None else []),
                                              dy)

        def comp_out():
            xs = x.detach().clone().requires_grad_()
            rs = None if r is None else r.clone().requires_grad_()
            y = comp(xs, act, rs)
            return (y,) + torch.autograd.grad(
                y, [xs, bn.scale, bn.bias] + ([rs] if r is not None else []), dy)

        run1 = (torch.zeros(ch, device="cuda"), torch.ones(ch, device="cuda"))
        run2 = tuple(t.clone() for t in run1)
        got, again = pair_out(run1), pair_out(run2)
        ref = comp_out()
        with torch.no_grad():  # float64 truth: the plain pair's function
            x64, g64, b64 = x.double(), g.double(), b.double()
            r64 = None if r is None else r.double()
            y64, st64 = fk.bn_act_train_fwd_plain(x64, g64, b64, act=act, residual=r64)

            def truth(y):
                """The float64 gradients under the ReLU mask of the forward ``y``
                (a float32 forward's mask differs from float64's where |z| is
                within rounding of 0: each side is held to its own)."""
                dx64, dr64, dg64, db64 = fk.bn_act_train_bwd_plain(
                    x64, dy.double(), g64, b64, st64, act=act,
                    out=None if act is None else y.double())
                return (y64, dx64, dg64, db64) + ((dr64,) if r is not None else ())
        label = (f"7f {TRAIN_BATCH}x{side}^2x{ch} {str(dtype)[6:]} "
                 f"{epi or 'no epilogue'} ({sites} site{'s' if sites > 1 else ''})")
        if not (all(torch.equal(p, q) for p, q in zip(got, again))
                and all(torch.equal(p, q) for p, q in zip(run1, run2))):
            raise AssertionError(f"{label}: two calls differ")
        err = [rel(p, t) for p, t in zip(got, truth(got[0]))]
        err_comp = [rel(p, t) for p, t in zip(ref, truth(ref[0]))]
        if any(not e <= max(2 * ec, 1e-5) for e, ec in zip(err, err_comp)):
            raise AssertionError(f"{label}: out/dx/dgamma/dbeta/dr off float64 by {err}, the "
                                 f"float32 composition by {err_comp}")
        with torch.no_grad():  # each launch against its plain version, from the same inputs
            sums, sums_p = fk.bn_sums(x), fk.bn_sums_plain(x)
            rk = (torch.zeros(ch, device="cuda"), torch.ones(ch, device="cuda"))
            rp = tuple(t.clone() for t in rk)
            y, stats = fk.bn_apply(x, sums, g, b, count=n // ch, act=act, residual=r, running=rk)
            y_p, stats_p = fk.bn_apply_plain(x, sums, g, b, count=n // ch, act=act, residual=r,
                                             running=rp)
            out = y if r is not None else None
            bsums = fk.bn_bwd_sums(x, dy, g, b, stats, act=act, out=out)
            bsums_p = fk.bn_bwd_sums_plain(x, dy, g, b, stats, act=act, out=out)
            dx, dres = fk.bn_bwd_apply(x, dy, g, b, stats, bsums, count=n // ch, act=act, out=out)
            dx_p, dres_p = fk.bn_bwd_apply_plain(x, dy, g, b, stats, bsums, count=n // ch,
                                                 act=act, out=out)
        exact = [torch.equal(p, q) for p, q in ((y, y_p), (stats, stats_p), (rk[0], rp[0]),
                                                (rk[1], rp[1]), (dx, dx_p))]
        if r is not None:
            exact.append(torch.equal(dres, dres_p))
        sums_rel = (rel(sums, sums_p), rel(bsums, bsums_p))
        if not all(exact) or max(sums_rel) > 1e-5:
            raise AssertionError(f"{label}: B2/B4 against plain from the same sums bit for bit "
                                 f"{exact}; B1/B3 sums off plain by {sums_rel}")
        errs = {"bn_train_stats": float((sums - sums_p).abs().max()), "bn_train_apply": 0.0,
                "bn_train_bwd_sums": float((bsums - bsums_p).abs().max()),
                "bn_train_bwd_apply": 0.0}
        with torch.no_grad():
            ms = time_many({
                "bn_train_stats": lambda: fk.bn_sums(x),
                "bn_train_apply": lambda: fk.bn_apply(x, sums, g, b, count=n // ch, act=act,
                                                      residual=r),
                "bn_train_bwd_sums": lambda: fk.bn_bwd_sums(x, dy, g, b, stats, act=act,
                                                            out=out),
                "bn_train_bwd_apply": lambda: fk.bn_bwd_apply(x, dy, g, b, stats, bsums,
                                                              count=n // ch, act=act, out=out),
                "fwd_plain": lambda: fk.bn_act_train_fwd_plain(x, g, b, act=act, residual=r),
                "bwd_plain": lambda: fk.bn_act_train_bwd_plain(x, dy, g, b, stats, act=act,
                                                               out=out)},
                iters=5, rounds=3)
        xg = x.detach().clone().requires_grad_()
        rg = None if r is None else r.clone().requires_grad_()
        yg = comp(xg, act, rg)
        ms.update(time_many({
            "comp_fwd": lambda: comp(xg, act, rg),
            "comp_bwd": lambda: torch.autograd.grad(
                yg, [xg, bn.scale, bn.bias] + ([rg] if rg is not None else []), dy,
                retain_graph=True)}, iters=5, rounds=3))
        del xg, rg, yg
        e, f4 = x.element_size(), 4 * n  # bytes of one element of x; of a float32 tensor
        extra = f4 if r is not None else 0
        bounds = {k: v / HBM_BYTES_S * 1e3 for k, v in (
            ("bn_train_stats", e * n), ("bn_train_apply", e * n + f4 + extra),
            ("bn_train_bwd_sums", e * n + f4 + extra),
            ("bn_train_bwd_apply", 2 * e * n + f4 + 2 * extra))}
        for k in BN_KERNELS:
            row = rows[k]
            row["max_abs_err"] = max(row["max_abs_err"], errs[k])
            row["ms"] += sites * ms[k]
            row["plain_ms"] += sites * ms["fwd_plain" if k in BN_KERNELS[:2] else "bwd_plain"] / 2
            row["library_ms"] += sites * ms["comp_fwd" if k in BN_KERNELS[:2] else "comp_bwd"] / 2
            row["bound_ms"] += sites * bounds[k]
            row["by"]["bytes"] += sites * bounds[k]
        per_step["pair"] += sites * sum(ms[k] for k in BN_KERNELS)
        per_step["bound"] += sites * sum(bounds.values())
        per_step["composition"] += sites * (ms["comp_fwd"] + ms["comp_bwd"])
        print(f"{label}: off float64 out/dx/dgamma/dbeta{'/dr' if r is not None else ''} "
              f"{', '.join(f'{v:.3g}' for v in err)} (float32 composition "
              f"{', '.join(f'{v:.3g}' for v in err_comp)}); two calls equal with the running "
              f"statistics; B2, B4 equal their plain versions, B1/B3 sums off plain "
              f"{sums_rel[0]:.3g}/{sums_rel[1]:.3g}; ms "
              + ", ".join(f"{k[9:]} {ms[k]:.5f} (bound {bounds[k]:.5f})" for k in BN_KERNELS)
              + f"; plain forward {ms['fwd_plain']:.5f}, backward {ms['bwd_plain']:.5f}; "
              f"composition forward {ms['comp_fwd']:.5f}, backward {ms['comp_bwd']:.5f}",
              flush=True)
        del x, r, dy, got, again, ref, x64, y64
        torch.cuda.empty_cache()
    plan_calls = {k: fk.LAUNCHES[k] for k in BN_KERNELS}
    print(f"7f a step's 47 sites: training pair {per_step['pair']:.3f} ms (bound "
          f"{per_step['bound']:.3f} ms, {per_step['bound'] / per_step['pair']:.1%} of it), "
          f"composition {per_step['composition']:.3f} ms; microbenchmark launches {plan_calls}",
          flush=True)

    # one EnhancedUNet step as the benchmark's cell builds the model, through
    # the pair and through the composition, from the same weights and draws
    xn, yn = triptych_batch(TRAIN_BATCH, TRAIN_SIZE, seed=17)
    xs = torch.from_numpy(xn).to("cuda", torch.bfloat16)
    ys = torch.from_numpy(yn).cuda()

    def step(kernels: bool):
        model = EnhancedUNet(init_features=FAMILY_WIDTH, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(23)).cuda()
        draws, drop = [], eu.dropout

        def dropout(t, rate, train, generator):
            draws.append(generator.get_state())
            return drop(t, rate, train, generator)

        # EnhancedUNet has no kernel site but its BatchNorms
        route = contextlib.nullcontext() if kernels else mock.patch.object(
            fk, "_routes_to_kernels", lambda t: False)
        times = []
        with mock.patch.object(eu, "dropout", dropout), route:
            for i in range(4):
                draws.clear()
                model.zero_grad(set_to_none=True)
                for m in model.modules():  # every step from the same statistics
                    if isinstance(m, eu.BatchNorm):
                        m.mean.zero_()
                        m.var.fill_(1.0)
                fk.reset_launch_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                loss = l1_loss(model(xs, train=True, generator=torch.Generator(
                    device="cuda").manual_seed(5)), ys)
                loss.backward()
                t1.record()
                torch.cuda.synchronize()
                if i:
                    times.append(t0.elapsed_time(t1))
        return {"loss": float(loss), "grads": {k: p.grad for k, p in model.named_parameters()},
                "stats": dict(model.named_buffers()), "draws": [d.clone() for d in draws],
                "launches": dict(fk.LAUNCHES), "fallbacks": dict(fk.TRAIN_FALLBACKS),
                "ms": sorted(times)[len(times) // 2],
                "peak": torch.cuda.max_memory_allocated()}

    pair, comp_step = step(True), step(False)
    launches = {k: v for k, v in pair["launches"].items() if v}
    if launches != {k: 47 for k in BN_KERNELS} or any(pair["fallbacks"].values()):
        raise AssertionError(f"7f one EnhancedUNet step launched {launches}, fallbacks "
                             f"{pair['fallbacks']}; want 47 of each of B1-B4 and none else")
    if any(comp_step["launches"].values()):
        raise AssertionError(f"7f the composition's step launched {comp_step['launches']}")
    same_draws = len(pair["draws"]) == len(comp_step["draws"]) == 11 and all(
        torch.equal(a, b) for a, b in zip(pair["draws"], comp_step["draws"]))
    gaps = {"loss_rel": abs(pair["loss"] - comp_step["loss"]) / abs(comp_step["loss"]),
            "grad_rel": (sum(float((pair["grads"][k] - g).double().norm()) ** 2
                             for k, g in comp_step["grads"].items())
                         / sum(float(g.double().norm()) ** 2
                               for g in comp_step["grads"].values())) ** 0.5,
            "stats_rel": (sum(float((pair["stats"][k] - t).double().norm()) ** 2
                              for k, t in comp_step["stats"].items())
                          / sum(float(t.double().norm()) ** 2
                                for t in comp_step["stats"].values())) ** 0.5,
            "first_stats_rel": max(rel(pair["stats"][k], comp_step["stats"][k])
                                   for k in ("enc1.bn1.mean", "enc1.bn1.var"))}
    print(f"7f one EnhancedUNet step (bf16, init_features {FAMILY_WIDTH}, batch {TRAIN_BATCH}, "
          f"{TRAIN_SIZE}^2): launches {launches}, fallbacks {pair['fallbacks']}; against the "
          f"composition's step: the same 11 dropout draws {same_draws}, gaps "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + f" (gates {BN_STEP_GATE}); forward+backward {pair['ms']:.3f} ms against "
          f"{comp_step['ms']:.3f}; peak memory {pair['peak'] / 2**30:.3f} against "
          f"{comp_step['peak'] / 2**30:.3f} GiB", flush=True)
    if not same_draws or any(gaps[k] > BN_STEP_GATE[k] for k in gaps):
        raise AssertionError("7f the pair's EnhancedUNet step against the composition's")

    # the sweep's trial group runs under torch.func: the composition, counted
    xv, yv = (torch.from_numpy(a).cuda() for a in triptych_batch(4, 64, seed=18))
    fk.reset_launch_counts()
    group = VmappedTrialGroup(EnhancedUNet(init_features=FAMILY_WIDTH, dtype=torch.bfloat16,
                                           generator=torch.Generator().manual_seed(14)),
                              [Trial(i, 2, 1e-3, 1e-5) for i in range(2)], seed=0, device="cuda")
    loss = group._train_step(xv[:2], yv[:2])
    torch.cuda.synchronize()
    vmapped = {"launches": {k: fk.LAUNCHES[k] for k in BN_KERNELS},
               "fallbacks": dict(fk.TRAIN_FALLBACKS)}
    print(f"7f VmappedTrialGroup step (2 trials, EnhancedUNet, 64^2): losses {loss.tolist()}, "
          f"{vmapped}", flush=True)
    if any(vmapped["launches"].values()) or vmapped["fallbacks"]["transform"] < 47:
        raise AssertionError("7f the trial group's BatchNorm must keep the composition, counted")
    return rows, pair["launches"]


# phase 6b: Restormer's channel LayerNorm (K6) at the bucket-16 shapes of
# its 88 sites, and the sites of a forward at each: 512^2 x 48 (level 1's
# encoder), 512^2 x 96 (level 1's decoder and the refinement), 256^2 x 96
# (level 2), 128^2 x 192 (level 3), 64^2 x 384 (the latent)
LN_SHAPES = {(16, 512, 512, 48): 8, (16, 512, 512, 96): 16, (16, 256, 256, 96): 24,
             (16, 128, 128, 192): 24, (16, 64, 64, 384): 16}
# K6 and the composition each round the same float32 function once, from
# statistics summed in another order (a few float32 ulps apart, ~1e-6 of
# the output's terms): the two roundings can fall on the two sides of one
# bf16 boundary, never of two. So bf16 outputs differ by at most 1 bf16 ulp
# of their size, sizes under LN_ULP_FLOOR measured at its ulp (2^-13, still
# 100x the float32 gap): where WithBias's centred terms cancel, an output
# near 0 has finer ulps than the terms' rounding. float32 outputs differ by
# the statistics' rounding, under 1e-5 relative (a wrong formula: O(1))
LN_BF16_ULPS, LN_ULP_FLOOR = 1.0, 2.0 ** -6
LN_F32_TOL = (1e-5, 1e-5)  # atol, rtol
# one 512^2 bf16 Restormer forward with K6 against the composition's, both
# against the float32 forward: K6 no further off than 1.25x the composition
LN_FORWARD_GATE = 1.25


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over two bf16 tensors in bf16 ulps of the larger
    of |a|, |b| and ``LN_ULP_FLOOR`` (8 significant bits: an ulp is
    2^(floor(log2 v) - 7))."""
    a, b = a.float(), b.float()
    size = torch.maximum(a.abs(), b.abs()).clamp_min(LN_ULP_FLOOR)
    ulp = torch.exp2(torch.floor(torch.log2(size)) - 7)
    return float(((a - b).abs() / ulp).max())


def layer_norm_kernels(card: str) -> tuple[dict, dict]:
    """Phase 6b: K6 (``fused_kernels.channel_layer_norm``) at ``LN_SHAPES``
    in bf16 and float32, BiasFree and WithBias: against its plain version
    and the composition (``LN_BF16_ULPS``, ``LN_F32_TOL``), twice bit for
    bit, one launch a call, its time beside the bytes bound, the plain
    version's and the composition's; then one 512^2 Restormer forward
    under inference_mode (88 launches, no fallback, ``LN_FORWARD_GATE``),
    a bucket of 16 timed with K6 and with the composition, and a grad-mode
    Restormer step (no launch). Returns the kernel row (the bf16 BiasFree
    cases, as the model runs them, one call each) and the forward's
    launches."""
    from image_enhancement_deglaring_tpu_torch.models import Restormer
    from image_enhancement_deglaring_tpu_torch.ops import conv_blocks as cb
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(61)
    row = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "by": {"bytes": 0.0}}
    per_bucket = {"K6": 0.0, "device": 0.0, "bound": 0.0, "composition": 0.0}
    for shape, sites in LN_SHAPES.items():
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            # a mean far from 0, as the BiasFree input's
            x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 3).to(dtype)
            w = torch.rand(c, device="cuda", generator=gen) + 0.5
            for b in (None, torch.randn(c, device="cuda", generator=gen) * 0.5):
                label = (f"6b {'x'.join(map(str, shape))} {str(dtype)[6:]} "
                         f"{'BiasFree' if b is None else 'WithBias'}")
                with torch.inference_mode():
                    got, again = fk.channel_layer_norm(x, w, b), fk.channel_layer_norm(x, w, b)
                    plain = fk.channel_layer_norm_plain(x, w, b)
                    comp = cb.channel_layer_norm(x, w, b)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{label}: two calls differ")
                if dtype == torch.bfloat16:
                    errs = (bf16_ulps(got, plain), bf16_ulps(got, comp))
                    ok = max(errs) <= LN_BF16_ULPS
                    err_text = f"{errs[0]:g} / {errs[1]:g} bf16 ulps"
                else:
                    atol, rtol = LN_F32_TOL
                    ok = all(bool(((got - t).abs() <= atol + rtol * t.abs()).all())
                             for t in (plain, comp))
                    errs = (float((got - plain).abs().max()), float((got - comp).abs().max()))
                    err_text = f"max |d| {errs[0]:.3g} / {errs[1]:.3g}"
                if not ok:
                    raise AssertionError(f"{label}: K6 against plain / composition {err_text}")
                nbytes = 2 * x.numel() * x.element_size()
                with torch.inference_mode():
                    check_launches(lambda: fk.channel_layer_norm(x, w, b), label)
                    t = time_many({"kernel": lambda: fk.channel_layer_norm(x, w, b),
                                   "plain": lambda: fk.channel_layer_norm_plain(x, w, b),
                                   "composition": lambda: cb.channel_layer_norm(x, w, b)})
                    dev = device_ms(lambda: fk.channel_layer_norm(x, w, b))
                bound_ms = nbytes / HBM_BYTES_S * 1e3
                print(f"{label}: against plain / composition {err_text}; K6 {t['kernel']:.5f} ms "
                      f"(device {dev:.5f}), bound {bound_ms:.5f} ms (bytes, "
                      f"{bound_ms / dev:.1%} of it), plain {t['plain']:.5f}, composition "
                      f"{t['composition']:.5f} ms ({card})", flush=True)
                if dtype == torch.bfloat16 and b is None:
                    row["max_abs_err"] = max(row["max_abs_err"],
                                             float((got.float() - plain.float()).abs().max()))
                    row["ms"] += t["kernel"]
                    row["plain_ms"] += t["plain"]
                    row["bound_ms"] += bound_ms
                    row["by"]["bytes"] += bound_ms
                    row["library_ms"] += t["composition"]
                    for k, v in (("K6", t["kernel"]), ("device", dev), ("bound", bound_ms),
                                 ("composition", t["composition"])):
                        per_bucket[k] += sites * v
                del got, again, plain, comp
            del x
    torch.cuda.empty_cache()

    # one served 512^2 page, as the engine runs the model: bf16 under inference_mode
    page = torch.from_numpy(make_frames(1, 512, seed=62)).cuda().float().div(255)[..., None]

    def restormer(dtype):
        m = Restormer(dtype=dtype, generator=torch.Generator(device="cuda").manual_seed(63),
                      device="cuda").eval()
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("body.weight"):  # LayerNorm weights away from 1
                    p.copy_(torch.rand(p.shape, device="cuda", generator=gen) + 0.5)
        return m

    model, exact = restormer(torch.bfloat16), restormer(torch.float32)
    exact.load_state_dict(model.state_dict())
    with torch.inference_mode():
        with mock.patch.object(fk, "_routes_to_kernels", lambda t: False):
            want = exact(page)
            comp = model(page)
        fk.reset_launch_counts()
        got = model(page)
        torch.cuda.synchronize()
    launches = {k: v for k, v in fk.LAUNCHES.items() if v}
    fallbacks = dict(fk.LAYER_NORM_FALLBACKS)
    err = [(float((t - want).abs().mean()), float((t - want).abs().max())) for t in (got, comp)]
    print(f"6b one 512^2 Restormer forward (bf16, inference_mode): launches {launches}, "
          f"fallbacks {fallbacks}; mean / max |out - float32 forward| with K6 {err[0][0]:.4g} / "
          f"{err[0][1]:.4g}, with the composition {err[1][0]:.4g} / {err[1][1]:.4g} (gate "
          f"{LN_FORWARD_GATE}x); K6 against the composition's forward: max |d| "
          f"{float((got - comp).abs().max()):.4g}", flush=True)
    if launches != {"channel_layer_norm": 88} or any(fallbacks.values()):
        raise AssertionError("6b want 88 launches of channel_layer_norm a forward, no fallback")
    if any(e > LN_FORWARD_GATE * ec for e, ec in zip(err[0], err[1])):
        raise AssertionError("6b the forward with K6 is further off the float32 forward")
    del exact, want, comp, got

    bucket = page.expand(16, -1, -1, -1).contiguous()

    def bucket_forward():
        """ms of one forward of the bucket, and the peak memory it allocates."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms = time_many({0: lambda: model(bucket)}, iters=2, warmup=1, rounds=3)[0]
        return ms, torch.cuda.max_memory_allocated() - base

    fwd, peak = bucket_forward()
    with mock.patch.object(fk, "_routes_to_kernels", lambda t: False):
        fwd_comp, peak_comp = bucket_forward()
    print(f"6b a bucket of 16 512^2 pages (bf16): {fwd:.2f} ms with K6, {fwd_comp:.2f} ms with "
          f"the composition ({16e3 / fwd:.1f} / {16e3 / fwd_comp:.1f} img/s, no host "
          f"pipeline), peak memory above the weights and pages {peak / 2**30:.3f} / "
          f"{peak_comp / 2**30:.3f} GiB; the 88 sites at the cases' bf16 BiasFree times: K6 "
          f"{per_bucket['K6']:.3f} ms (device {per_bucket['device']:.3f}, bound "
          f"{per_bucket['bound']:.3f}), composition {per_bucket['composition']:.3f} ms",
          flush=True)
    del bucket
    torch.cuda.empty_cache()

    # Restormer's training keeps the composition: a grad call launches nothing
    small = Restormer(dtype=torch.bfloat16,
                      generator=torch.Generator(device="cuda").manual_seed(64), device="cuda")
    xs = torch.rand(2, 64, 64, 1, device="cuda", generator=gen)
    fk.reset_launch_counts()
    loss = (small(xs) - xs).abs().mean()
    loss.backward()
    torch.cuda.synchronize()
    grads = sum(1 for p in small.parameters() if p.grad is not None and p.grad.abs().sum() > 0)
    print(f"6b a grad-mode Restormer step (bf16, 2 x 64^2): loss {loss.item():.5f}, "
          f"{grads} parameters with gradients, launches "
          f"{ {k: v for k, v in fk.LAUNCHES.items() if v} }, fallbacks "
          f"{fk.LAYER_NORM_FALLBACKS}", flush=True)
    if any(fk.LAUNCHES.values()) or any(fk.LAYER_NORM_FALLBACKS.values()):
        raise AssertionError("6b the grad-mode step must keep the composition, uncounted")
    return {"channel_layer_norm": row}, launches


# phase 8: HTTP serving. Traffic (my prediction and readings: PERF.md):
# 512x512 gray PNGs, 1024x768 RGB PNGs resized both ways, 1200x900 gray
# PNGs through ?mode=tile; 8 keep-alive connections. Each answer against
# the same frame through the engine or tiler called directly, at the bf16
# gate of two bf16 paths (phase 4's).
HTTP_SIZE, HTTP_CONNECTIONS = 512, 8
HTTP_GRAY, HTTP_RGB, HTTP_TILE = 32, 8, 2
HTTP_RGB_SIZE, HTTP_TILE_SIZE = (768, 1024), (900, 1200)  # (h, w)
PHONE_SIZE = (3024, 4032)  # (h, w)
HTTP_PSNR_GATE_DB = 45.0
# closed-loop requests by the uploads' PNG filters (the load tool's --filter)
HTTP_LOAD_REQUESTS, HTTP_OPEN_LOOP_S = {"up": 400, "adaptive": 200}, 10.0


def rgb_pages(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded colour pages: make_frames' page, tinted per channel; uint8
    (n, h, w, 3)."""
    gray = make_frames(n, h, seed, w=w).astype(np.float32)
    tint = np.array([1.0, 0.93, 0.82], np.float32)
    return np.clip(gray[..., None] * tint + 8.0, 0, 255).astype(np.uint8)


def _percentiles_ms(lat: list) -> tuple:
    lat = sorted(lat)
    return tuple(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3 for p in (0.5, 0.95, 0.99))


def _post_all(port: int, bodies: list, connections: int) -> tuple[list, list, float]:
    """POST every (path, body, headers) over ``connections`` keep-alive
    connections at once; (statuses and JSON answers in order, latencies,
    wall seconds)."""
    import http.client

    answers, lat = [None] * len(bodies), [0.0] * len(bodies)

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        for i in range(k, len(bodies), connections):
            path, body, headers = bodies[i]
            t = time.perf_counter()
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            lat[i] = time.perf_counter() - t
            answers[i] = (resp.status, json.loads(data))
        conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(connections)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return answers, lat, time.perf_counter() - t0


def _get_json(port: int, path: str) -> tuple[int, object]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, (json.loads(data) if path != "/metrics" else data.decode())


def host_split() -> None:
    """The host work of one /infer request, step by step, each the median
    of 9 single-thread runs; then 8 threads decoding at once. Printed with
    the host's core counts: the request path is host-bound (PERF.md)."""
    import base64

    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.serve import imaging

    def med(fn, n=9):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)[n // 2]

    print(f"8 host: os.cpu_count() {os.cpu_count()}, usable cores "
          f"{len(os.sched_getaffinity(0))}, torch threads {torch.get_num_threads()}", flush=True)
    gray = make_frames(1, HTTP_SIZE, seed=21)[0]
    rgb = rgb_pages(1, *HTTP_RGB_SIZE, seed=22)[0]
    for label, img, ft in (("gray, up filter", gray, 2), ("gray, paeth filter", gray, 4),
                           ("gray, PIL's filters", gray, "adaptive"), ("RGB, up filter", rgb, 2),
                           ("RGB, PIL's filters", rgb, "adaptive")):
        png = encode_png(img, filter_type=ft)
        pix = imaging.decode_image(png).pixels
        luma = imaging.to_luma(pix, "RGB" if pix.ndim == 3 else "L")
        small = (luma if luma.shape == (HTTP_SIZE, HTTP_SIZE)
                 else imaging.resize_lanczos(luma, (HTTP_SIZE, HTTP_SIZE)))
        size = (luma.shape[1], luma.shape[0])
        out = encode_png(luma, compress_level=1)
        parts = {
            "decode": med(lambda: imaging.decode_image(png)),
            "luma": med(lambda: imaging.to_luma(pix, "RGB" if pix.ndim == 3 else "L")),
            "resize down": med(lambda: imaging.resize_lanczos(luma, (HTTP_SIZE, HTTP_SIZE)))
            if small is not luma else 0.0,
            "resize up": med(lambda: imaging.resize_lanczos(small, size))
            if small is not luma else 0.0,
            "encode (zlib 1)": med(lambda: encode_png(luma, compress_level=1)),
            "base64": med(lambda: base64.b64encode(out)),
        }
        print(f"8 host split, {label} {size[0]}x{size[1]} ({len(png)} B): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f"; sum {sum(parts.values()):.3f} ms", flush=True)
    for label, ft in (("up", 2), ("PIL's", "adaptive")):
        png = encode_png(gray, filter_type=ft)
        walls = []

        def decode_many():
            for _ in range(10):
                t = time.perf_counter()
                imaging.decode_image(png)
                walls.append((time.perf_counter() - t) * 1e3)

        threads = [threading.Thread(target=decode_many) for _ in range(HTTP_CONNECTIONS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(f"8 host: {HTTP_CONNECTIONS} threads decoding the gray PNG ({label} filters) 10 "
              f"times each: {len(walls) / (time.perf_counter() - t0):.1f} decodes/s, wall per "
              f"decode p50 {sorted(walls)[len(walls) // 2]:.3f} ms", flush=True)

    # a phone photo's luma (the 64 MB body limit takes one), 512x512 and
    # back: the banded passes against dense float64 matrices of the same
    # taps, which every partial sum below 2^31 keeps exact
    photo = make_frames(1, PHONE_SIZE[0], seed=23, w=PHONE_SIZE[1])[0]
    small = imaging.resize_lanczos(photo, (HTTP_SIZE, HTTP_SIZE))
    for label, src, size in (("down", photo, (HTTP_SIZE, HTTP_SIZE)),
                             ("up", small, PHONE_SIZE[::-1])):
        if not np.array_equal(imaging.resize_lanczos(src, size), dense_lanczos(src, size)):
            raise AssertionError(f"LANCZOS {label}: banded and dense passes differ")
        banded = med(lambda: imaging.resize_lanczos(src, size), n=3)
        dense = med(lambda: dense_lanczos(src, size), n=3)
        print(f"8 host: LANCZOS {label} {src.shape[1]}x{src.shape[0]} -> {size[0]}x{size[1]}: "
              f"banded {banded:.3f} ms, dense float64 {dense:.3f} ms (equal)", flush=True)


@functools.lru_cache(maxsize=8)
def _dense_pass(n_in: int, n_out: int) -> np.ndarray:
    from image_enhancement_deglaring_tpu_torch.serve import imaging

    index, weight = imaging._pass_taps(n_in, n_out)
    m = np.zeros((n_in, n_out))
    np.add.at(m, (index, np.arange(n_out)[:, None]), weight)
    return m


def dense_lanczos(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``imaging.resize_lanczos`` as dense float64 (in, out) products of
    its taps: O(in) multiply-adds per output where the banded pass does
    O(taps)."""
    def clip8(acc):
        return np.clip(np.floor((acc + 2.0 ** 21) / 2.0 ** 22), 0, 255).astype(np.uint8)

    w, h = size
    if img.shape[1] != w:
        img = clip8(img.astype(np.float64) @ _dense_pass(img.shape[1], w))
    if img.shape[0] != h:
        img = clip8(_dense_pass(img.shape[0], h).T @ img.astype(np.float64))
    return img


def http_serving(card: str) -> dict:
    """Phase 8: ``create_server`` on the production weights in bf16 (the
    kernels on) answers real HTTP requests; returns the launches of its
    counted resize and tile traffic, by path."""
    import base64
    import shutil
    import tempfile

    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.serve import imaging
    from image_enhancement_deglaring_tpu_torch.serve.http_server import create_server
    from image_enhancement_deglaring_tpu_torch.tools.load_test_api import multipart_body

    host_split()
    port = _free_port()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_api_")
    t0 = time.perf_counter()
    server = create_server(ONNX, host="127.0.0.1", port=port, compute_dtype=torch.bfloat16,
                           image_size=HTTP_SIZE, max_batch_size=8, mode="both", warmup=True,
                           log_dir=log_dir)
    t_create = time.perf_counter() - t0
    thread = _start(server, timeout=60)
    engine, tiler = server.engine, server.tiler
    print(f"8 create_server (bf16, {HTTP_SIZE}, buckets warmed) in {t_create:.1f} s; bound "
          f"127.0.0.1:{port}", flush=True)

    def upload(img):
        return multipart_body(encode_png(img))

    gray = make_frames(HTTP_GRAY, HTTP_SIZE, seed=11)
    rgb = rgb_pages(HTTP_RGB, *HTTP_RGB_SIZE, seed=12)
    tiles = make_frames(HTTP_TILE, HTTP_TILE_SIZE[0], seed=13, w=HTTP_TILE_SIZE[1])
    resize_bodies = [("/infer", *upload(im)) for im in list(gray) + list(rgb)]
    tile_bodies = [("/infer?mode=tile", *upload(im)) for im in tiles]

    def served():
        return _get_json(port, "/stats")[1]["batches_dispatched"]

    # 8a: resize traffic, counted (every launch on the engine's collector)
    fk.reset_launch_counts()
    b0 = served()
    answers, lat, wall = _post_all(port, resize_bodies, HTTP_CONNECTIONS)
    torch.cuda.synchronize()
    counts_resize, forwards = dict(fk.LAUNCHES), served() - b0
    p50, p95, p99 = _percentiles_ms(lat)
    print(f"8a {len(resize_bodies)} resize requests ({HTTP_GRAY} gray {HTTP_SIZE}^2, {HTTP_RGB} RGB "
          f"{HTTP_RGB_SIZE[1]}x{HTTP_RGB_SIZE[0]}) over {HTTP_CONNECTIONS} connections: "
          f"{len(lat) / wall:.1f} req/s, latency p50/p95/p99 {p50:.2f} / {p95:.2f} / "
          f"{p99:.2f} ms, in {forwards} device batches; launches {counts_resize} on {card}",
          flush=True)
    if forward_only(counts_resize) != {"gn_silu_flat": 14 * forwards, "gn_silu_nhwc": 0,
                                       "conv3x3_gn_silu": 4 * forwards,
                                       "conv3x3_gn_silu_batched": 0}:
        raise AssertionError(f"resize traffic: want 14 K1 and 4 K3 launches per each of "
                             f"{forwards} forwards, got {counts_resize}")

    # 8b: tile traffic, counted: one request at a time, each on its own
    # connection (the tile pool's threads launch the kernels)
    fk.reset_launch_counts()
    b0 = served()
    tile_answers = [_post_all(port, [b], 1)[0][0] for b in tile_bodies]
    torch.cuda.synchronize()
    counts_tile = dict(fk.LAUNCHES)
    tile_forwards = sum(-(-tiler.num_tiles(*HTTP_TILE_SIZE) // tiler.max_tiles_per_batch)
                        for _ in tile_bodies)
    print(f"8b {HTTP_TILE} tile requests {HTTP_TILE_SIZE[1]}x{HTTP_TILE_SIZE[0]} "
          f"({tiler.num_tiles(*HTTP_TILE_SIZE)} tiles each, {tile_forwards} forwards): "
          f"launches {counts_tile}", flush=True)
    if (forward_only(counts_tile) != {"gn_silu_flat": 14 * tile_forwards, "gn_silu_nhwc": 0,
                                      "conv3x3_gn_silu": 4 * tile_forwards,
                                      "conv3x3_gn_silu_batched": 0}
            or served() != b0):
        raise AssertionError(f"tile traffic: want 14 K1 and 4 K3 launches per each of "
                             f"{tile_forwards} tile forwards and no engine batch, got "
                             f"{counts_tile}")

    # 8c: tile and resize requests at once (the tile pool and the engine's
    # collector launch on one stream together); answers checked, not counted
    mixed = tile_bodies + resize_bodies[:16]
    mixed_answers, _, wall_c = _post_all(port, mixed, HTTP_CONNECTIONS)
    print(f"8c {len(mixed)} mixed tile + resize requests at once in {wall_c:.2f} s", flush=True)

    # the answers against the engine and the tiler called directly
    def decoded(answer):
        status, payload = answer
        if status != 200:
            raise AssertionError(f"/infer answered {status}: {payload}")
        img = imaging.decode_image(base64.b64decode(payload["image"]))
        if img.mode != "L":
            raise AssertionError(f"/infer answered a {img.mode} PNG")
        return img.pixels

    ref_gray = np.concatenate([engine.infer_batch(gray[i:i + 8]) for i in range(0, HTTP_GRAY, 8)])
    ref_rgb = []
    for im in rgb:
        small = imaging.resize_lanczos(imaging.to_luma(im, "RGB"), (HTTP_SIZE, HTTP_SIZE))
        out = engine.infer_batch(small[None])[0]
        ref_rgb.append(imaging.resize_lanczos(out, (HTTP_RGB_SIZE[1], HTTP_RGB_SIZE[0])))
    ref_tile = [tiler(im) for im in tiles]
    checks = ([(decoded(a), r, "gray") for a, r in zip(answers[:HTTP_GRAY], ref_gray)]
              + [(decoded(a), r, "rgb") for a, r in zip(answers[HTTP_GRAY:], ref_rgb)]
              + [(decoded(a), r, "tile") for a, r in zip(tile_answers, ref_tile)]
              + [(decoded(a), r, "mixed tile") for a, r in zip(mixed_answers[:HTTP_TILE], ref_tile)]
              + [(decoded(a), r, "mixed gray") for a, r in zip(mixed_answers[HTTP_TILE:], ref_gray)])
    worst: dict = {}
    for got, want, kind in checks:
        if got.shape != want.shape:
            raise AssertionError(f"{kind} answer {got.shape}, want {want.shape}")
        d = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        p = psnr_u8(got, want)
        lo = worst.setdefault(kind, [math.inf, 0])
        worst[kind] = [min(lo[0], p), max(lo[1], d)]
    print("8 answers vs the engine/tiler called directly: " + "; ".join(
        f"{k} min PSNR {v[0]:.2f} dB, max |delta| {v[1]}" for k, v in worst.items())
        + f" (need >= {HTTP_PSNR_GATE_DB} dB)", flush=True)
    if min(v[0] for v in worst.values()) < HTTP_PSNR_GATE_DB:
        raise AssertionError(f"an /infer answer is below {HTTP_PSNR_GATE_DB} dB: {worst}")

    # a JPEG upload (the JAX serve tests' photo): 200 at its size, at the gate
    with open(os.path.join(REPO, "tests", "fixtures", "photo_noise.jpg"), "rb") as f:
        jpeg = f.read()
    jpeg_answer, = _post_all(port, [("/infer", *multipart_body(jpeg))], 1)[0]
    luma = imaging.to_luma(imaging.decode_image(jpeg).pixels, "L")
    small = imaging.resize_lanczos(luma, (HTTP_SIZE, HTTP_SIZE))
    want = imaging.resize_lanczos(engine.infer_batch(small[None])[0], luma.shape[::-1])
    got = decoded(jpeg_answer)
    if got.shape != luma.shape or psnr_u8(got, want) < HTTP_PSNR_GATE_DB:
        raise AssertionError(f"JPEG upload: answer {got.shape} at {psnr_u8(got, want):.2f} dB, "
                             f"want {luma.shape} at >= {HTTP_PSNR_GATE_DB} dB")
    print(f"8 JPEG upload (photo_noise.jpg, {luma.shape[1]}x{luma.shape[0]}): 200, "
          f"{psnr_u8(got, want):.2f} dB against the engine called directly", flush=True)
    # the other endpoints
    sent = len(resize_bodies) + 16 + 1  # every request that reached the engine
    status, stats = _get_json(port, "/stats")
    status_m, text = _get_json(port, "/metrics")
    line = [x for x in text.splitlines() if x.startswith("deglaring_requests_served_total ")]
    if (status != 200 or status_m != 200 or stats["requests_served"] != sent or not line
            or float(line[0].split()[-1]) != sent
            or any(stats[f"host_{k}_ms_p50"] is None for k in ("decode", "engine", "encode"))):
        raise AssertionError(f"/stats or /metrics disagree with the {sent} requests sent: "
                             f"{stats}, {line}")
    print(f"8 /stats and /metrics: requests_served {stats['requests_served']} (sent {sent}); "
          f"host phase p50 over the requests above: decode "
          f"{stats['host_decode_ms_p50']:.2f} ms, engine {stats['host_engine_ms_p50']:.2f} ms, "
          f"encode {stats['host_encode_ms_p50']:.2f} ms", flush=True)

    # 8d: the load tool in its own process: closed loops at concurrency 8 on
    # "up"-filtered uploads (decoded a run of rows at a time) and on the
    # filters PIL writes (Paeth rows: the wavefront), then open loop on the
    # latter at half its closed-loop rate
    load = load_loops(port, "8d", card)

    _stop(server, thread)
    shutil.rmtree(log_dir, ignore_errors=True)
    return {"8a HTTP resize": counts_resize, "8b HTTP tile": counts_tile}, load


def load_tool(port: int, *args) -> dict:
    """One run of ``tools.load_test_api`` in its own process; its JSON line."""
    out = subprocess.run([sys.executable, "-m",
                          "image_enhancement_deglaring_tpu_torch.tools.load_test_api",
                          "--url", f"http://127.0.0.1:{port}", *args], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"load_test_api {args} failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def load_loops(port: int, label: str, card: str) -> dict:
    """The load tool against the server on ``port``: closed loops at
    concurrency 8 on "up" rows and on PIL's rows, then open loop on PIL's
    rows at half that closed loop's rate for 10 s; each printed with the
    server's host phases. Returns the three results by loop."""
    def host_phases(what):
        # with worker processes, /stats holds the host phases of the one
        # worker that answered it
        _, st = _get_json(port, "/stats")
        print(f"{label} host phase p50 (the answering process's last 1024 requests, "
              f"{what}): decode "
              f"{st['host_decode_ms_p50']:.2f} ms, engine {st['host_engine_ms_p50']:.2f} ms, "
              f"encode {st['host_encode_ms_p50']:.2f} ms; engine latency p50/p95/p99 "
              f"{st['latency_ms_p50']:.2f} / {st['latency_ms_p95']:.2f} / "
              f"{st['latency_ms_p99']:.2f} ms, mean batch fill {st['mean_batch_fill']:.2f}",
              flush=True)

    results = {}
    for filters, n in HTTP_LOAD_REQUESTS.items():
        results[f"closed {filters}"] = load_tool(
            port, "--size", str(HTTP_SIZE), "--requests", str(n), "--concurrency",
            str(HTTP_CONNECTIONS), "--filter", filters)
        host_phases(f"through the {filters} closed loop")
    rate = results["closed adaptive"]["req_per_s"] / 2
    results["open adaptive"] = load_tool(
        port, "--size", str(HTTP_SIZE), "--rate", f"{rate:.3f}", "--duration",
        str(HTTP_OPEN_LOOP_S), "--connections", "64", "--filter", "adaptive")
    for r in results.values():
        print(f"{label} load_test_api {r['mode']} loop, {r['input']}: {r['req_per_s']:.2f} req/s "
              f"({r['requests_ok']} ok, {r['errors']} errors, {r['wall_s']:.2f} s), latency "
              f"p50/p95/p99 {r['latency_ms_p50']:.2f} / {r['latency_ms_p95']:.2f} / "
              f"{r['latency_ms_p99']:.2f} ms"
              + (f" at {r['rate_per_s']:.2f}/s offered" if r["mode"] == "open" else
                 f" at concurrency {r['concurrency']}") + f" on {card}", flush=True)
    host_phases("through the open loop")
    if any(r["errors"] for r in results.values()):
        raise AssertionError(f"load_test_api saw errors: {results}")
    return results



# phase 9: evaluation on the card (my prediction and readings: PERF.md).
# A seeded synthetic SD1 val set at 512^2: 20 triptychs, batch 8 gives 8, 8
# and a ragged 4; the rate at batch 16 on 48 more.
EVAL_SIZE, EVAL_N, EVAL_BATCH = 512, 20, 8
EVAL_RATE_N, EVAL_RATE_BATCH, EVAL_WORKERS = 48, 16, 4
# f32 evaluation, card (K1/K3 f32) against the CPU (the composition)
EVAL_F32_GATE = {"l1_loss": 1e-5, "psnr": 0.01, "ssim": 1e-4}
# bf16 with the kernels against bf16 without them, on the card
EVAL_BF16_PSNR_GATE_DB = 0.05
EVAL_PER_FORWARD = {"gn_silu_flat": 14, "gn_silu_nhwc": 0, "conv3x3_gn_silu": 4,
                    "conv3x3_gn_silu_batched": 0}


class TimedLoader:
    """Wraps a loader; ``wait_s`` adds up the time spent waiting for its
    batches."""

    def __init__(self, loader):
        self.loader, self.wait_s = loader, 0.0

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self.wait_s += time.perf_counter() - t
            yield batch


def per_forward(n: int) -> dict:
    return {k: v * n for k, v in EVAL_PER_FORWARD.items()}


def fmt_metrics(m: dict) -> str:
    return f"L1 {m['l1_loss']:.7f}, PSNR {m['psnr']:.5f} dB, SSIM {m['ssim']:.6f}"


def evaluation(card: str) -> dict:
    """Phase 9: ``evaluate`` on the production weights at 512^2 on the card,
    f32 (the CLI's default) against the same loader on the CPU, bf16 with
    the kernels against bf16 without them, the ``cli.evaluate`` subprocess
    against the in-process run, the visualizations decoded back, and the
    images/s at batch 16. Returns the launches of the counted runs."""
    import shutil
    import tempfile

    from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1, make_eval_loader
    from image_enhancement_deglaring_tpu_torch.data.png import decode_png_image, png_text
    from image_enhancement_deglaring_tpu_torch.eval import (
        evaluate,
        load_model_for_eval,
        write_results_file,
    )
    from image_enhancement_deglaring_tpu_torch.modelio import load_lightweight_unet
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        t0 = time.perf_counter()
        generate_synthetic_sd1(os.path.join(tmp, "data"), n_train=0, n_val=EVAL_N,
                               size=EVAL_SIZE, seed=21)
        generate_synthetic_sd1(os.path.join(tmp, "rate"), n_train=0, n_val=EVAL_RATE_N,
                               size=EVAL_SIZE, seed=22)
        val = os.path.join(tmp, "data", "val")
        # evaluation_results.txt goes beside the model: a copy in tmp
        onnx = os.path.join(tmp, "best_model.onnx")
        shutil.copyfile(ONNX, onnx)
        print(f"9 synthetic SD1 val sets written ({EVAL_N} + {EVAL_RATE_N} triptychs at "
              f"{EVAL_SIZE}^2) in {time.perf_counter() - t0:.1f} s", flush=True)

        def loader(path=val, batch=EVAL_BATCH):
            return make_eval_loader(path, batch_size=batch, image_size=EVAL_SIZE,
                                    num_workers=EVAL_WORKERS)

        batches = -(-EVAL_N // EVAL_BATCH)
        vis_dir = os.path.join(tmp, "vis")
        held = list(loader())
        model32, _ = load_model_for_eval(onnx, compute_dtype=torch.float32)
        evaluate(model32, held[:1], progress=False)  # cuDNN plans, warm
        # 9a: f32 on the card, counted, with the visualizations (they reuse
        # the step's prediction, so the counts show no second forward)
        fk.reset_launch_counts()
        t0 = time.perf_counter()
        m32 = evaluate(model32, loader(), batch_size=EVAL_BATCH, progress=False,
                       save_visualizations=True, visualizations_dir=vis_dir)
        torch.cuda.synchronize()
        wall32 = time.perf_counter() - t0
        counts32 = dict(fk.LAUNCHES)
        print(f"9a evaluate f32 on cuda, {m32['num_samples']} images in {batches} batches "
              f"({wall32:.2f} s): {fmt_metrics(m32)}; launches {counts32}", flush=True)
        if m32["num_samples"] != EVAL_N or forward_only(counts32) != per_forward(batches):
            raise AssertionError(f"f32 evaluation: want {EVAL_N} samples and "
                                 f"{per_forward(batches)} launches, got {m32['num_samples']}, "
                                 f"{counts32}")
        # 9b: the visualizations decoded back against the model's output
        names = sorted(os.listdir(vis_dir))
        want_names = sorted(f"sample_{k}.png" for k in range(10))
        if names != want_names:
            raise AssertionError(f"visualizations: want {want_names}, got {names}")
        # the prediction again, in the batches evaluate ran
        x, y = (np.concatenate([b[i] for b in held[:2]])[:10] for i in (0, 1))
        with torch.inference_mode():
            pred = torch.cat([model32(torch.from_numpy(b[0]).cuda())
                              for b in held[:2]]).cpu().numpy()[:10]

        def u8(a):
            return (np.clip(a, 0, 1) * 255).astype(np.uint8)

        worst = 0
        for k in range(10):
            data = open(os.path.join(vis_dir, f"sample_{k}.png"), "rb").read()
            img = decode_png_image(data).pixels
            s = EVAL_SIZE
            if (img.shape != (s, 3 * s) or not np.array_equal(img[:, :s], u8(x[k, ..., 0]))
                    or not np.array_equal(img[:, 2 * s:], u8(y[k, ..., 0]))
                    or list(png_text(data)) != ["Input", "Prediction", "Ground Truth"]):
                raise AssertionError(f"sample_{k}.png: panels or titles wrong")
            worst = max(worst, int(np.abs(img[:, s:2 * s].astype(np.int16)
                                          - u8(pred[k, ..., 0]).astype(np.int16)).max()))
        print(f"9b 10 visualizations decoded back: input and target panels equal, prediction "
              f"panel within {worst} uint8 levels of the model's output", flush=True)
        if worst > 1:
            raise AssertionError(f"a prediction panel is {worst} levels off the model's output")

        # 9c: the same loader through the same model on the CPU (composition)
        t0 = time.perf_counter()
        m_cpu = evaluate(model32, loader(), device="cpu", batch_size=EVAL_BATCH, progress=False)
        delta = {k: abs(m32[k] - m_cpu[k]) for k in EVAL_F32_GATE}
        print(f"9c evaluate f32 on the CPU ({time.perf_counter() - t0:.1f} s): "
              f"{fmt_metrics(m_cpu)}; |delta| card vs CPU: L1 {delta['l1_loss']:.3e}, PSNR "
              f"{delta['psnr']:.3e} dB, SSIM {delta['ssim']:.3e} (gates {EVAL_F32_GATE})",
              flush=True)
        if any(delta[k] > EVAL_F32_GATE[k] for k in EVAL_F32_GATE):
            raise AssertionError(f"f32 evaluation, card vs CPU: {delta} beyond {EVAL_F32_GATE}")
        del model32

        # 9d: bf16 with the kernels against bf16 without them
        model16, _ = load_model_for_eval(onnx, compute_dtype=torch.bfloat16)
        plain16 = load_lightweight_unet(onnx, dtype=torch.bfloat16, device="cuda")
        evaluate(model16, held[:1], progress=False)
        fk.reset_launch_counts()
        m16 = evaluate(model16, loader(), batch_size=EVAL_BATCH, progress=False)
        torch.cuda.synchronize()
        counts16 = dict(fk.LAUNCHES)
        m16c = evaluate(plain16, loader(), batch_size=EVAL_BATCH, progress=False)
        d16 = abs(m16["psnr"] - m16c["psnr"])
        print(f"9d evaluate bf16 with the kernels: {fmt_metrics(m16)}; launches {counts16}",
              flush=True)
        print(f"9d evaluate bf16, kernels off: {fmt_metrics(m16c)}; |delta PSNR| "
              f"{d16:.5f} dB (gate {EVAL_BF16_PSNR_GATE_DB})", flush=True)
        if d16 > EVAL_BF16_PSNR_GATE_DB or forward_only(counts16) != per_forward(batches):
            raise AssertionError(f"bf16 evaluation: |delta PSNR| {d16} or launches {counts16}")

        # 9e: the CLI in its own process on the copy: its printed lines and
        # results file equal the in-process f32 run at the printed precision
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m",
                              "image_enhancement_deglaring_tpu_torch.cli.evaluate",
                              "--data_dir", val, "--model_path", onnx, "--batch_size",
                              str(EVAL_BATCH)], cwd=REPO, capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"cli.evaluate failed: {out.stderr[-2000:]}")
        printed = [ln for ln in out.stdout.splitlines()
                   if ln.split(":")[0] in ("L1 Loss", "PSNR", "SSIM")]
        want = [f"L1 Loss: {m32['l1_loss']:.4f}", f"PSNR: {m32['psnr']:.2f} dB",
                f"SSIM: {m32['ssim']:.4f}"]
        written = open(os.path.join(tmp, "evaluation_results.txt")).read()
        ref_dir = os.path.join(tmp, "ref")
        os.makedirs(ref_dir)
        ref = open(write_results_file(m32, onnx, val, "onnx", out_dir=ref_dir)).read()
        print(f"9e cli.evaluate on cuda in its own process ({time.perf_counter() - t0:.1f} s): "
              f"{printed}; evaluation_results.txt equal to the in-process run's: "
              f"{written == ref}", flush=True)
        if printed != want or written != ref:
            raise AssertionError(f"cli.evaluate printed {printed} (want {want}) or wrote "
                                 f"{written!r} (want {ref!r})")

        # 9f: images/s at batch 16, f32 and bf16, with the loader's share of
        # the wall time; beside it the same batches from memory
        rate_dir = os.path.join(tmp, "rate", "val")
        in_memory = list(loader(rate_dir, EVAL_RATE_BATCH))
        model32, _ = load_model_for_eval(onnx, compute_dtype=torch.float32)
        for dtype, model in ((torch.float32, model32), (torch.bfloat16, model16)):
            evaluate(model, in_memory, progress=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate(model, in_memory, progress=False)
            torch.cuda.synchronize()
            mem_rate = EVAL_RATE_N / (time.perf_counter() - t0)
            timed = TimedLoader(loader(rate_dir, EVAL_RATE_BATCH))
            t0 = time.perf_counter()
            evaluate(model, timed, batch_size=EVAL_RATE_BATCH, progress=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"9f evaluate {str(dtype).removeprefix('torch.')} at batch {EVAL_RATE_BATCH}, "
                  f"{EVAL_RATE_N} images at {EVAL_SIZE}^2: {EVAL_RATE_N / wall:.2f} img/s "
                  f"end to end (loader {EVAL_WORKERS} threads, {timed.wait_s / wall:.3f} of "
                  f"the wall time waiting for it); {mem_rate:.2f} img/s from batches held in "
                  f"memory; on {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"9a evaluate f32": counts32, "9d evaluate bf16": counts16}


# phase 10: the HTTP server with worker processes (serve.ipc) in front of
# this process's engine
HTTP_WORKERS, HTTP_DRAIN_REQUESTS = 4, 64


def _maps(pid: int) -> str:
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def http_workers(card: str, single_load: dict | None) -> dict:
    """Phase 10: ``create_server`` (bf16, 512, max batch 8) with its engine
    in this process and ``serve_multiprocess`` with 4 HTTP worker processes
    on one port: no worker holds CUDA or torch, 32 answers against the
    engine called directly, launches per batch, /stats through a worker,
    the load tool beside phase 8's single process, ``stop()`` with requests
    in flight, then ``cli.serve --workers 2`` in its own process. Returns
    the launches of the counted traffic."""
    import shutil
    import signal
    import tempfile

    from image_enhancement_deglaring_tpu_torch.data.png import decode_png, encode_png
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.serve.http_server import create_server
    from image_enhancement_deglaring_tpu_torch.serve.ipc import serve_multiprocess
    from image_enhancement_deglaring_tpu_torch.tools.load_test_api import multipart_body

    def wait_ping(port, timeout):
        deadline = time.time() + timeout
        while True:
            try:
                if _get_json(port, "/ping") == (200, {"message": "pong"}):
                    return
            except OSError:
                pass
            if time.time() > deadline:
                raise AssertionError(f"nothing answered /ping on port {port} in {timeout} s")
            time.sleep(0.1)

    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_workers_")
    t0 = time.perf_counter()
    server = create_server(ONNX, host="127.0.0.1", port=port, compute_dtype=torch.bfloat16,
                           image_size=HTTP_SIZE, max_batch_size=8, mode="resize", warmup=True,
                           log_dir=tmp)
    engine = server.engine
    engine.start()
    # spawn runs the parent's main script again in every worker unless it
    # has no __file__: this script imports torch, which a worker must not
    main = sys.modules["__main__"]
    main_file = main.__dict__.pop("__file__", None)
    try:
        mps = serve_multiprocess(engine, host="127.0.0.1", port=port, image_size=HTTP_SIZE,
                                 n_workers=HTTP_WORKERS, log_dir=tmp,
                                 address=os.path.join(tmp, "engine.sock"),
                                 model_info=server.model_info)
    finally:
        if main_file is not None:
            main.__file__ = main_file
    wait_ping(port, 120)
    pids = [p.pid for p in mps.procs]
    # /ping answers once one worker is up: wait for every worker's log line
    logs = [os.path.join(tmp, f"api.worker{pid}.log") for pid in pids]
    deadline = time.time() + 120
    while sum(os.path.exists(p) and "serving on" in open(p).read() for p in logs) < len(pids):
        if time.time() > deadline or not all(p.is_alive() for p in mps.procs):
            raise AssertionError(f"a worker never came up: exit codes "
                                 f"{[p.exitcode for p in mps.procs]}")
        time.sleep(0.1)
    print(f"10 create_server + {HTTP_WORKERS} workers up in {time.perf_counter() - t0:.1f} s "
          f"on 127.0.0.1:{port}", flush=True)

    # 10a: the card's compute processes: one, this one, no worker. In a
    # container nvidia-smi reports pids of another pid namespace (one app,
    # pid 1), so each process's own maps say which holds libcuda and
    # libtorch
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.split()
    on_card = {int(x) for x in smi if x.isdigit()}
    mapped = {pid: [lib for lib in ("libcuda.so", "libtorch") if lib in _maps(pid)]
              for pid in pids}
    mine = [lib for lib in ("libcuda.so", "libtorch") if lib in _maps(os.getpid())]
    print(f"10a nvidia-smi compute apps {sorted(on_card)}; this process {os.getpid()} "
          f"(maps {mine}); workers {pids}, their maps of libcuda/libtorch {mapped}", flush=True)
    if (len(on_card) != 1 or on_card & set(pids) or any(mapped.values())
            or mine != ["libcuda.so", "libtorch"]):
        raise AssertionError("a worker holds CUDA or torch, or the card lists other than one "
                             "compute process")

    # 10b: 32 gray pages over 8 connections, counted
    gray = make_frames(HTTP_GRAY, HTTP_SIZE, seed=31)
    bodies = [("/infer", *multipart_body(encode_png(im))) for im in gray]
    fk.reset_launch_counts()
    b0 = engine.stats()["batches_dispatched"]
    answers, lat, wall = _post_all(port, bodies, HTTP_CONNECTIONS)
    torch.cuda.synchronize()
    counts = dict(fk.LAUNCHES)
    forwards = engine.stats()["batches_dispatched"] - b0
    ref = np.concatenate([engine.infer_batch(gray[i:i + 8]) for i in range(0, HTTP_GRAY, 8)])
    worst = math.inf
    for (status, payload), want in zip(answers, ref):
        if status != 200:
            raise AssertionError(f"/infer through a worker answered {status}: {payload}")
        got = decode_png(base64.b64decode(payload["image"]))
        worst = min(worst, psnr_u8(got, want) if got.shape == want.shape else -math.inf)
    p50, p95, p99 = _percentiles_ms(lat)
    print(f"10b {HTTP_GRAY} gray {HTTP_SIZE}^2 requests over {HTTP_CONNECTIONS} connections "
          f"through {HTTP_WORKERS} workers: {len(lat) / wall:.1f} req/s, p50/p95/p99 "
          f"{p50:.2f} / {p95:.2f} / {p99:.2f} ms, {forwards} device batches; min PSNR against "
          f"the engine called directly {worst:.2f} dB (need >= {HTTP_PSNR_GATE_DB}); "
          f"launches {counts}", flush=True)
    if worst < HTTP_PSNR_GATE_DB or forward_only(counts) != per_forward(forwards):
        raise AssertionError(f"workers: min PSNR {worst}, launches {counts} for {forwards} "
                             "batches")

    # 10c: /stats through a worker is the engine's
    status, st = _get_json(port, "/stats")
    served = engine.stats()["requests_served"]
    print(f"10c /stats through a worker: requests_served {st['requests_served']}, the "
          f"engine's {served}; model {st.get('model_path')}", flush=True)
    if status != 200 or st["requests_served"] != served or st.get("model_path") != ONNX:
        raise AssertionError(f"/stats through a worker {st} against the engine's {served}")

    # 10d: the load tool, beside phase 8's single process
    load = load_loops(port, "10d", card)
    for name, r in load.items():
        single = single_load.get(name) if single_load else None
        print(f"10d {name} loop: {HTTP_WORKERS} workers {r['req_per_s']:.2f} req/s, p50/p95/p99 "
              f"{r['latency_ms_p50']:.2f} / {r['latency_ms_p95']:.2f} / "
              f"{r['latency_ms_p99']:.2f} ms; 1 process (phase 8d) "
              + (f"{single['req_per_s']:.2f} req/s, {single['latency_ms_p50']:.2f} / "
                 f"{single['latency_ms_p95']:.2f} / {single['latency_ms_p99']:.2f} ms"
                 if single else "not run") + f"; on {card}", flush=True)

    # 10e: stop() with requests in flight: uploads under PIL's row filters
    # (~50 ms of decode each under a worker's GIL), each on its own
    # connection, all sent before stop(); every one answered 200
    pil_rows = [("/infer", *multipart_body(encode_png(im, filter_type="adaptive")))
                for im in make_frames(HTTP_DRAIN_REQUESTS, HTTP_SIZE, seed=32)]
    results, done_at = [None] * len(pil_rows), [0.0] * len(pil_rows)
    sent = threading.Barrier(len(pil_rows) + 1, timeout=60)

    def one(i):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            path, body, headers = pil_rows[i]
            conn.request("POST", path, body=body, headers=headers)
            sent.wait()
            resp = conn.getresponse()
            results[i] = resp.status
            resp.read()
        except Exception as e:  # a dropped connection
            results[i] = repr(e)
        finally:
            done_at[i] = time.perf_counter()
            conn.close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(pil_rows))]
    for t in threads:
        t.start()
    sent.wait()
    time.sleep(0.25)  # the bodies read; the decodes still running
    t_stop = time.perf_counter()
    mps.stop()
    t_stopped = time.perf_counter()
    for t in threads:
        t.join(120)
    codes = [p.exitcode for p in mps.procs]
    after = sum(d > t_stop for d in done_at)
    print(f"10e stop() with {len(pil_rows)} requests sent: answers {sorted(set(map(str, results)))}"
          f", {after} finished after stop() began; stop() took {t_stopped - t_stop:.2f} s; "
          f"worker exit codes {codes}; socket file left: "
          f"{os.path.exists(os.path.join(tmp, 'engine.sock'))}", flush=True)
    if (any(r != 200 for r in results) or codes != [0] * HTTP_WORKERS or after == 0
            or os.path.exists(os.path.join(tmp, "engine.sock"))):
        raise AssertionError(f"drain: answers {results}, exit codes {codes}, {after} in flight")
    engine.stop()

    # 10f: cli.serve --workers 2 in its own process
    port2 = _free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m",
                             "image_enhancement_deglaring_tpu_torch.cli.serve",
                             "--model_path", ONNX, "--host", "127.0.0.1", "--port", str(port2),
                             "--workers", "2", "--log_dir", tmp], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wait_ping(port2, 300)
        t_up = time.perf_counter() - t0
        (status, payload), = _post_all(port2, bodies[:1], 1)[0]
        got = decode_png(base64.b64decode(payload["image"])) if status == 200 else None
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=600)[0]
    finally:
        proc.kill()
        proc.wait(60)
    p = psnr_u8(got, ref[0]) if got is not None else -math.inf
    print(f"10f cli.serve --workers 2: /ping after {t_up:.1f} s, /infer {status} at {p:.2f} dB "
          f"against the engine; SIGTERM exit code {proc.returncode}", flush=True)
    if status != 200 or p < HTTP_PSNR_GATE_DB or proc.returncode != 0:
        raise AssertionError(f"cli.serve --workers 2: {status}, {p} dB, exit "
                             f"{proc.returncode}: {out[-2000:]}")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"10b HTTP 4 workers": counts}

# phase 11: resident training, device augmentation, the other families.
# SD1 at full scale is 1,536 pairs at 512^2; as cached (bf16 inputs, f32
# targets) 2.25 GiB. The resident epoch is checked against the per-step
# loop and the preemption resume against an uninterrupted run under
# deterministic algorithms (cuDNN's default backward is not bit-stable),
# at the JAX resident tests' tolerances: losses rtol 1e-6, parameters rtol
# 1e-4 / atol 1e-5 (tests/test_resident.py); the families' f32 forwards
# card vs CPU within FAMILY_F32_GATE (written before the first run).
SD1_PAIRS, SD1_BASES = 1536, 32
RES_BATCH, RES_PARITY_BATCH, RES_PARITY_STEPS = 32, 8, 4
FAMILY_F32_GATE, FAMILY_BATCH, FAMILY_STEPS = 1e-4, 8, 5
AUG_SAMPLES = 4096
CLI_PNGS = 128


class SyntheticPairs:
    """An indexable set of ``n`` seeded (glared, clean) pairs at ``size``:
    pair i is one of ``bases`` seeded SD1 triptychs from the port's
    generator, rolled by i // bases pixels along both axes (distinct pairs
    at a cost of a copy each). ``augment`` is "none", as the cache needs."""

    augment = "none"

    def __init__(self, n: int, size: int, seed: int, bases: int = SD1_BASES):
        self.n = n
        self.x, self.y = triptych_batch(min(bases, n), size, seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        j, shift = i % len(self.x), i // len(self.x)
        return (np.roll(self.x[j], (shift, shift), axis=(0, 1)),
                np.roll(self.y[j], (shift, shift), axis=(0, 1)))


class ArrayBatches:
    """A loader over fixed NHWC arrays: the train loop's contract
    (batch_size, num_samples, len, iteration in order); the resident cache
    drains it once."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int):
        self.x, self.y, self.batch_size = x, y, batch_size

    def __len__(self):
        return len(self.x) // self.batch_size

    @property
    def num_samples(self):
        return len(self.x)

    def __iter__(self):
        for i in range(len(self)):
            s = slice(i * self.batch_size, (i + 1) * self.batch_size)
            yield self.x[s], self.y[s]


class GuardAfter:
    """A preemption guard whose flag turns on at its ``after + 1``-th read."""

    preempt_checkpoint = None

    def __init__(self, after: int):
        self.reads, self.after, self._set = 0, after, False

    @property
    def triggered(self):
        self.reads += 1
        return self._set or self.reads > self.after

    @triggered.setter
    def triggered(self, value):
        self._set = value


def busy_share(fn) -> tuple[float, float]:
    """(device busy ms, busy share of the host wall) of one synchronous
    ``fn()`` under torch.profiler."""
    dev, wall = device_events(fn, 1)
    busy, end = 0.0, -math.inf
    for s, t in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy / 1e3, busy / 1e6 / wall


def resident_cache_and_rate(card: str, step_rate: float, loader_rates: tuple) -> None:
    """Phases 11a-c: the SD1-scale cache, the resident epoch against the
    per-step loop in f32, and one shuffled bf16 epoch with device
    augmentation at batch 32."""
    from image_enhancement_deglaring_tpu_torch.modelio import export_jax_params, load_lightweight_unet
    from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import highest_precision
    from image_enhancement_deglaring_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from image_enhancement_deglaring_tpu_torch.train.resident import (
        cache_on_device,
        make_train_epoch,
        make_train_epoch_segmented,
    )
    from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

    total = torch.cuda.get_device_properties(0).total_memory
    pairs = SyntheticPairs(SD1_PAIRS, TRAIN_SIZE, seed=11)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    data = cache_on_device(pairs, dtype=torch.bfloat16, num_workers=8, device="cuda")
    torch.cuda.synchronize()
    t_cache = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - before
    print(f"11a cache_on_device: {data.n} pairs at {TRAIN_SIZE}^2 in {t_cache:.1f} s "
          f"(decode by 8 threads + copy); x {data.x.dtype} {tuple(data.x.shape)}, y "
          f"{data.y.dtype}; {held / 2**30:.3f} GiB resident, {held / total:.2%} of the "
          f"card's {total / 2**30:.1f} GiB", flush=True)
    want = SD1_PAIRS * TRAIN_SIZE ** 2 * 6
    if (data.n != SD1_PAIRS or data.x.dtype != torch.bfloat16 or data.y.dtype != torch.float32
            or not want <= held <= want + (2 << 20)):
        raise AssertionError("the SD1-scale cache has the wrong size or dtypes")

    # 11b: f32, 4 steps of batch 8, resident epoch vs the per-step loop
    n = RES_PARITY_BATCH * RES_PARITY_STEPS
    small = cache_on_device(SyntheticPairs(n, TRAIN_SIZE, seed=12), num_workers=8,
                            device="cuda")
    runs = {}
    with deterministic(), highest_precision():
        for how in ("per-step", "resident"):
            model = load_lightweight_unet(ONNX, dtype=torch.float32, device="cuda")
            state = TrainState(model=model, optimizer=make_optimizer(model, TRAIN_LR, TRAIN_WD),
                               generator=torch.Generator(device="cuda").manual_seed(0))
            if how == "per-step":
                step, losses = make_train_step(), []
                for i in range(RES_PARITY_STEPS):
                    rows = slice(i * RES_PARITY_BATCH, (i + 1) * RES_PARITY_BATCH)
                    state, loss = step(state, small.x[rows].clone(), small.y[rows].clone())
                    losses.append(loss)
                losses = torch.stack(losses)
            else:
                state, losses = make_train_epoch(batch_size=RES_PARITY_BATCH, shuffle=False)(
                    state, small.x, small.y, 0, 0, small.n)
            runs[how] = (losses.cpu().numpy(), flatten_tree(export_jax_params(model)))
    (lr_, pr), (ls, ps) = runs["resident"], runs["per-step"]
    loss_rel = float(np.max(np.abs(lr_ - ls) / np.abs(ls)))
    param_excess = max(float(np.max(np.abs(pr[k] - ps[k]) - (1e-5 + 1e-4 * np.abs(ps[k]))))
                       for k in ps)
    print(f"11b resident epoch vs per-step loop (production LightweightUNet f32, "
          f"{RES_PARITY_STEPS} steps of {RES_PARITY_BATCH} at {TRAIN_SIZE}^2, deterministic "
          f"algorithms): losses {' '.join(f'{v:.7f}' for v in lr_)}, max rel diff "
          f"{loss_rel:.3g} (gate 1e-6); params max |diff| "
          f"{max(float(np.abs(pr[k] - ps[k]).max()) for k in ps):.3g} (gate rtol 1e-4, "
          f"atol 1e-5)", flush=True)
    if not loss_rel <= 1e-6 or param_excess > 0:
        raise AssertionError("the resident epoch differs from the per-step loop")
    del small

    # 11c: one shuffled epoch at SD1 scale, bf16, batch 32, augmentation
    model = load_lightweight_unet(ONNX, dtype=torch.bfloat16, device="cuda")
    state = TrainState(model=model, optimizer=make_optimizer(model, TRAIN_LR, TRAIN_WD),
                       generator=torch.Generator(device="cuda").manual_seed(0))
    plan, segment = make_train_epoch_segmented(batch_size=RES_BATCH,
                                               augment_fn=device_augment_batch)
    warm = plan(0, 99, data.n, "cuda")[:2]  # cuDNN plans for this shape, outside the clock
    state, _ = segment(state, data.x, data.y, warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = plan(0, 0, data.n, "cuda")
    steps = int(idx.shape[0])
    seg_len = -(-steps // 8)
    parts = []
    for s in range(0, steps, seg_len):  # as train_model runs it: 8 segments, one fetch each
        state, losses = segment(state, data.x, data.y, idx[s:s + seg_len])
        parts.append(losses.double().cpu())
    t_epoch = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lv = torch.cat(parts).numpy()
    rate = steps * RES_BATCH / t_epoch
    prof_idx = plan(0, 1, data.n, "cuda")[:seg_len]
    busy_ms, share = busy_share(lambda: segment(state, data.x, data.y, prof_idx)[1].cpu())
    aug_x, aug_y = data.x[:RES_BATCH], data.y[:RES_BATCH]
    gen = torch.Generator(device="cuda").manual_seed(1)
    aug_ms = time_ms(lambda: device_augment_batch(gen, aug_x, aug_y))
    print(f"11c resident epoch at SD1 scale (production LightweightUNet bf16, batch {RES_BATCH}, "
          f"device augmentation, 8 segments): {steps} steps in {t_epoch:.3f} s, {rate:.1f} img/s; "
          f"peak memory allocated {peak / 2**30:.3f} GiB (cache included); one profiled segment "
          f"of {seg_len} steps: device busy {busy_ms:.1f} ms, busy share {share:.3f}; "
          f"device_augment_batch alone {aug_ms:.3f} ms per batch of {RES_BATCH}; beside it "
          f"from this run: phase 7c's step {step_rate:.1f} img/s, phase 7d's streaming loader "
          f"{loader_rates[0]:.1f} img/s ({loader_rates[1]:.1f} with cache_images); losses "
          f"first/last {lv[0]:.5f}/{lv[-1]:.5f} on {card}", flush=True)
    if not np.isfinite(lv).all() or steps != SD1_PAIRS // RES_BATCH:
        raise AssertionError("the resident epoch's losses are not finite or its plan is short")
    del data


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (cuDNN's and cuBLAS's) for the block; main()
    sets CUBLAS_WORKSPACE_CONFIG before the first cuBLAS call, which reads
    it once per process."""
    bench = torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = bench


def resident_resume() -> None:
    """Phase 11d: train_model(resident=True, device_augment=True) on the
    card, preempted at the first segment boundary and resumed, against an
    uninterrupted run: 2 epochs of 32 cached pairs at 512^2, batch 8, the
    production model in bf16, under deterministic algorithms."""
    import tempfile

    from image_enhancement_deglaring_tpu_torch.modelio import (
        export_jax_params,
        lightweight_unet_params_from_onnx,
    )
    from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
    from image_enhancement_deglaring_tpu_torch.train import train_model
    from image_enhancement_deglaring_tpu_torch.train.checkpoint import restore_checkpoint
    from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

    pairs = SyntheticPairs(40, TRAIN_SIZE, seed=13)
    x = np.stack([pairs[i][0] for i in range(40)])
    y = np.stack([pairs[i][1] for i in range(40)])
    init = lightweight_unet_params_from_onnx(ONNX)

    def run(out, **kw):
        return train_model(LightweightUNet(dtype=torch.bfloat16), ArrayBatches(x[:32], y[:32], 8),
                           ArrayBatches(x[32:], y[32:], 8), epochs=2, lr=TRAIN_LR,
                           weight_decay=TRAIN_WD, output_dir=out, progress=False,
                           resident=True, device_augment=True, resident_segments=2,
                           validation_metrics_every=100, init_params=init, device="cuda", **kw)

    with tempfile.TemporaryDirectory() as tmp, deterministic():
        t0 = time.perf_counter()
        _, _, full_val, full = run(os.path.join(tmp, "full"), handle_preemption=False)
        guard = GuardAfter(0)
        run(os.path.join(tmp, "cut"), preempt_guard=guard)
        meta = restore_checkpoint(guard.preempt_checkpoint)[1]
        _, _, val, resumed = run(os.path.join(tmp, "cut"), handle_preemption=False,
                                 resume_from=guard.preempt_checkpoint)
        secs = time.perf_counter() - t0
    want = flatten_tree(export_jax_params(full.model))
    got = flatten_tree(export_jax_params(resumed.model))
    same = want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)
    gen_same = torch.equal(full.generator.get_state(), resumed.generator.get_state())
    print(f"11d resident preempt at epoch {meta['epoch']} step {meta['epoch_step']} (resident "
          f"{meta['resident']}), resumed: {resumed.step} steps like the uninterrupted run's "
          f"{full.step}; final parameters equal bit for bit {same}; generator state equal "
          f"{gen_same}; val loss {val:.6f} vs {full_val:.6f} ({secs:.1f} s, deterministic "
          f"algorithms)",
          flush=True)
    if not (same and gen_same and meta["mid_epoch"] and meta["epoch_step"] == 2
            and resumed.step == full.step == 8 and val == full_val):
        raise AssertionError("the resumed resident run differs from the uninterrupted one")


def augment_statistics(x0, xa, ya, y0) -> dict:
    """Per-sample draws recovered from one augmented batch of distinct,
    asymmetric ramps in [0.35, 0.65] (no clipping at any draw): the flip
    from the target, then the image op from the un-flipped image: none, an
    exact affine map (brightness/contrast: alpha, beta) or additive noise
    (its variance, on the 0-255 scale)."""
    flips = np.array([not np.array_equal(a, b) for a, b in zip(ya, y0)])
    un = np.where(flips[:, None, None, None], xa[:, :, ::-1], xa)
    out = {"flip": flips, "pixel": [], "bc": [], "alpha": [], "beta": [], "var": []}
    for a, b in zip(x0.reshape(len(x0), -1), un.reshape(len(un), -1)):
        if np.array_equal(a, b):
            out["pixel"].append(False)
            continue
        out["pixel"].append(True)
        alpha, beta = np.polyfit(a.astype(np.float64), b.astype(np.float64), 1)
        affine = np.abs(alpha * a + beta - b).max() < 1e-5
        out["bc"].append(affine)
        if affine:
            out["alpha"].append(alpha)
            out["beta"].append(beta)
        else:
            out["var"].append(np.mean((b.astype(np.float64) - a) ** 2) * 255.0 ** 2)
    return {k: np.asarray(v) for k, v in out.items()}


def device_augmentation() -> None:
    """Phase 11e: device_augment_batch on the card over 4,096 samples of
    16x16 ramps: its rates within 5 binomial sigma, its draws within their
    bounds, the target flipped with its image."""
    from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch

    rng = np.random.default_rng(9)
    ramp = np.linspace(0.35, 0.65, 256, dtype=np.float32).reshape(16, 16)
    x0 = (ramp[None] + rng.uniform(-0.001, 0.001, (AUG_SAMPLES, 1, 1)).astype(np.float32))
    x0 = x0[..., None]
    y0 = x0 * 0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    xa, ya = device_augment_batch(gen, torch.from_numpy(x0).cuda(), torch.from_numpy(y0).cuda())
    xa, ya = xa.cpu().numpy(), ya.cpu().numpy()
    st = augment_statistics(x0, xa, ya, y0)
    target_ok = np.array_equal(ya, np.where(st["flip"][:, None, None, None], y0[:, :, ::-1], y0))

    def sigmas(hits, p):
        return abs(hits.mean() - p) / np.sqrt(p * (1 - p) / len(hits))

    z = {"flip": sigmas(st["flip"], 0.5), "pixel op": sigmas(st["pixel"], 0.5),
         "brightness/contrast share": sigmas(st["bc"], 0.8)}
    var_z = abs(st["var"].mean() - 30.0) / ((40 / np.sqrt(12)) / np.sqrt(len(st["var"])))
    print(f"11e device_augment_batch on the card, {AUG_SAMPLES} samples: flip rate "
          f"{st['flip'].mean():.4f}, pixel-op rate {st['pixel'].mean():.4f}, brightness/contrast "
          f"share {st['bc'].mean():.4f} of {len(st['bc'])} ({', '.join(f'{k} {v:.2f} sigma' for k, v in z.items())}); "
          f"alpha [{st['alpha'].min():.4f}, {st['alpha'].max():.4f}] (bounds [0.8, 1.2]), beta "
          f"[{st['beta'].min():.4f}, {st['beta'].max():.4f}] ([-0.2, 0.2]), noise variance "
          f"estimates [{st['var'].min():.2f}, {st['var'].max():.2f}] /255^2, mean "
          f"{st['var'].mean():.2f} (U(10, 50): 30, {var_z:.2f} sigma); target flipped with its "
          f"image {target_ok}", flush=True)
    if (max(z.values()) > 5 or var_z > 5 or not target_ok
            or st["alpha"].min() < 0.8 - 1e-4 or st["alpha"].max() > 1.2 + 1e-4
            or st["beta"].min() < -0.2 - 1e-4 or st["beta"].max() > 0.2 + 1e-4
            or st["var"].min() < 6 or st["var"].max() > 70):
        raise AssertionError("device augmentation's distributions are off")


def other_families(card: str) -> None:
    """Phase 11f: OptimizedUNet and EnhancedUNet at their published width
    (init_features 16) at 512^2: a seeded init carried over through
    load_jax_params, the f32 forward card vs CPU, 5 bf16 train steps at
    batch 8 (EnhancedUNet's the stateful step), load_model_for_eval on the
    saved checkpoint, and cli.evaluate --model in its own process on 8
    synthetic triptychs."""
    import tempfile

    from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1
    from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
    from image_enhancement_deglaring_tpu_torch.modelio import (
        export_jax_batch_stats,
        export_jax_params,
        load_jax_params,
    )
    from image_enhancement_deglaring_tpu_torch.models import EnhancedUNet, OptimizedUNet
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import highest_precision
    from image_enhancement_deglaring_tpu_torch.train import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from image_enhancement_deglaring_tpu_torch.train.checkpoint import save_checkpoint
    from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

    xf, _ = triptych_batch(2, TRAIN_SIZE, seed=14)
    xs, ys = triptych_batch(FAMILY_BATCH, TRAIN_SIZE, seed=15)
    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_sd1(os.path.join(tmp, "sd"), n_train=0, n_val=8, size=TRAIN_SIZE,
                               seed=3)
        procs = {}
        for family, cls in (("optimized", OptimizedUNet), ("enhanced", EnhancedUNet)):
            init = cls(generator=torch.Generator().manual_seed(0))
            params, stats = export_jax_params(init), export_jax_batch_stats(init) or None
            outs = {}
            for device in ("cuda", "cpu"):
                m = cls().to(device)
                load_jax_params(m, params, stats)
                with torch.no_grad(), highest_precision():
                    outs[device] = m.eval()(torch.from_numpy(xf).to(device)).cpu().numpy()
            err = float(np.abs(outs["cuda"] - outs["cpu"]).max())

            model = cls(dtype=torch.bfloat16).cuda()
            load_jax_params(model, params, stats)
            stateful = stats is not None
            state = TrainState(model=model, optimizer=make_optimizer(model, TRAIN_LR, TRAIN_WD),
                               generator=torch.Generator(device="cuda").manual_seed(0))
            step = make_train_step(stateful=stateful)
            x = torch.from_numpy(xs).to("cuda", torch.bfloat16)
            y = torch.from_numpy(ys).cuda()
            state, _ = step(state, x, y)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(FAMILY_STEPS + 1)]
            marks[0].record()
            losses = []
            for i in range(FAMILY_STEPS):
                state, loss = step(state, x, y)
                losses.append(loss)
                marks[i + 1].record()
            torch.cuda.synchronize()
            per = sorted(marks[i].elapsed_time(marks[i + 1]) for i in range(FAMILY_STEPS))
            med, peak = per[len(per) // 2], torch.cuda.max_memory_allocated()
            lv = torch.stack(losses).float().cpu().numpy()
            moved = finite = True
            if stateful:
                a, b = flatten_tree(export_jax_batch_stats(model)), flatten_tree(stats)
                moved = all(not np.array_equal(a[k], b[k]) for k in a)
                finite = all(np.isfinite(v).all() for v in a.values())
            ckpt = save_checkpoint(os.path.join(tmp, family), params=export_jax_params(model),
                                   model_state={"batch_stats": export_jax_batch_stats(model)}
                                   if stateful else None)
            loaded, _ = load_model_for_eval(ckpt, compute_dtype=torch.bfloat16, device="cuda")
            with torch.no_grad():
                reload_err = float((loaded(x) - model.eval()(x)).abs().max())
            print(f"11f {family} (init_features 16, {sum(p.numel() for p in model.parameters()):,}"
                  f" parameters) at {TRAIN_SIZE}^2: f32 forward card vs CPU max |diff| {err:.3g} "
                  f"(gate {FAMILY_F32_GATE}); bf16 {'stateful ' if stateful else ''}train step at "
                  f"batch {FAMILY_BATCH}: median {med:.3f} ms/step over {FAMILY_STEPS}, "
                  f"{FAMILY_BATCH / med * 1e3:.1f} img/s, peak memory allocated "
                  f"{peak / 2**30:.3f} GiB, losses {' '.join(f'{v:.5f}' for v in lv)}"
                  + (f"; BatchNorm buffers moved {moved} and finite {finite}" if stateful else "")
                  + f"; load_model_for_eval(checkpoint) forward max |diff| {reload_err:.3g} "
                  f"on {card}",
                  flush=True)
            if not (err <= FAMILY_F32_GATE and np.isfinite(lv).all() and moved and finite
                    and reload_err <= 1e-3):
                raise AssertionError(f"{family}: card checks failed")
            procs[family] = subprocess.Popen(
                [sys.executable, "-m", "image_enhancement_deglaring_tpu_torch.cli.evaluate",
                 "--data_dir", os.path.join(tmp, "sd", "val"), "--model_path", ckpt,
                 "--model", family, "--image_size", str(TRAIN_SIZE), "--batch_size", "8",
                 "--num_workers", "4"], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            del model, state, loaded
        for family, p in procs.items():
            out, _ = p.communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.split(":")[0] in
                     ("L1 Loss", "PSNR", "SSIM", "Evaluation on 8 samples")]
            print(f"11f cli.evaluate --model {family} (own process, 8 triptychs): exit "
                  f"{p.returncode}; {'; '.join(lines)}", flush=True)
            if p.returncode != 0 or len(lines) != 4:
                raise AssertionError(f"cli.evaluate --model {family} failed:\n{out[-2000:]}")


def write_triptychs(root: str, n: int, size: int, seed: int, threads: int = 8) -> None:
    """``n`` seeded SD1 triptych PNGs in ``root``, written by ``threads``
    threads (zlib runs outside the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.data.synthetic import make_triptych

    os.makedirs(root, exist_ok=True)

    def one(i):
        trip = make_triptych(np.random.default_rng([seed, i]), size)
        with open(os.path.join(root, f"synthetic_{i:04d}.png"), "wb") as f:
            f.write(encode_png(trip))

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, range(n)))


def resident_cli() -> None:
    """Phase 11g: cli.train --resident_data --augment device on the
    production model (bf16, batch 32, 512^2, 2 epochs) over 128 synthetic
    PNG triptychs, its artifacts checked as phase 7d checks them; then
    --model enhanced --resident_data --augment device, 1 epoch at batch 8."""
    import contextlib as ctx
    import io
    import tempfile

    from image_enhancement_deglaring_tpu_torch.cli import train as cli_train
    from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_triptychs(os.path.join(tmp, "data"), CLI_PNGS, TRAIN_SIZE, seed=21)
        t_data = time.perf_counter() - t0
        for label, extra, epochs in (("basic", ["--batch_size", "32"], 2),
                                     ("enhanced", ["--batch_size", "8"], 1)):
            out_dir = os.path.join(tmp, label)
            log = Tee()
            t0 = time.perf_counter()
            with ctx.redirect_stdout(log):
                cli_train.main(["--data_dir", os.path.join(tmp, "data"), "--output_dir", out_dir,
                                "--epochs", str(epochs), "--resident_data", "--augment", "device",
                                "--compute_dtype", "bfloat16", "--image_size", str(TRAIN_SIZE),
                                "--validation_metrics_every", "1", "--model", label, *extra])
            t_run = time.perf_counter() - t0
            text = log.getvalue()
            missing = [f for f in ("best_model", "final_model", "model_weights.npz",
                                   "logs/metrics.jsonl")
                       if not os.path.exists(os.path.join(out_dir, f))]
            epoch_lines = [ln for ln in text.splitlines() if ln.startswith("Epoch ")]
            with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
                ips = [json.loads(ln).get("train_images_per_sec") for ln in f]
            model, _ = load_model_for_eval(os.path.join(out_dir, "final_model"), device="cuda")
            devices = {str(p.device) for p in model.parameters()}
            print(f"11g cli.train --model {label} --resident_data --augment device "
                  f"{' '.join(extra)}: {epochs} epochs in {t_run:.1f} s ({CLI_PNGS} PNGs written in "
                  f"{t_data:.1f} s); epoch lines {len(epoch_lines)}; train img/s per epoch "
                  f"{[round(v, 1) for v in ips if v]}; missing artifacts {missing}; final_model "
                  f"loads as {type(model).__name__} on {sorted(devices)}", flush=True)
            if (len(epoch_lines) != epochs or missing or "Training completed" not in text
                    or devices != {"cuda:0"}):
                raise AssertionError(f"cli.train --resident_data ({label}) on the card failed")


def resident_training(card: str, step_rate: float, loader_rates: tuple) -> dict:
    """Phase 11: resident training and the other families on the card.
    Returns its kernel launches: the training pair's (LightweightUNet's
    GroupNorm+SiLU), no forward-only kernel's (the paths train, and the
    other families have none)."""
    from image_enhancement_deglaring_tpu_torch.ops import dec1
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    fk.reset_launch_counts()
    dec1.reset_launch_counts()
    for label, fn, *args in (("11a-c", resident_cache_and_rate, card, step_rate, loader_rates),
                             ("11d", resident_resume), ("11e", device_augmentation),
                             ("11f", other_families, card), ("11g", resident_cli)):
        t = time.perf_counter()
        fn(*args)
        print(f"phase {label}: {time.perf_counter() - t:.1f} s", flush=True)
    counts = {**fk.LAUNCHES, **dec1.LAUNCHES}
    print(f"11 kernel launches over the phase: {counts}", flush=True)
    if any(forward_only(counts).values()) or not (
            counts["gn_silu_train_fwd"] and counts["gn_silu_train_bwd"]):
        raise AssertionError(f"phase 11 launched {counts}: want the training pair alone")
    return counts


JPEG_FIXTURES = os.path.join(REPO, "tests", "fixtures")
JPEG_PHONE = "jpeg/page_4032x3024_420.jpg"
JPEG_PHONE_LOOP = 8
FAMILY_HTTP_GRAY = 16
FAMILY_WIDTH = 16  # OptimizedUNet's and EnhancedUNet's published init_features
# the phone-size decode in a process of its own: peak host memory over the
# process's resident set before the decode, and the longest another
# Python thread waits meanwhile
JPEG_FOOTPRINT = r'''
import json, os, sys, threading, time
from image_enhancement_deglaring_tpu_torch.data.jpeg import decode_jpeg

def rss_mib():
    # resident set now; the high-water marks (VmHWM, ru_maxrss) start at
    # the forking parent's size
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20
    except (OSError, ValueError, IndexError):
        return None

with open(sys.argv[1], "rb") as f:
    data = f.read()
base, rss, gaps, done = rss_mib(), [], [], threading.Event()

def tick():
    last = time.perf_counter()
    while not done.is_set():
        time.sleep(0.001)
        now = time.perf_counter()
        gaps.append(now - last)
        rss.append(rss_mib())
        last = now

ticker = threading.Thread(target=tick)
ticker.start()
t = time.perf_counter()
decode_jpeg(data)
secs = time.perf_counter() - t
done.set()
ticker.join()
peak = None if base is None or None in rss else max(rss)
print(json.dumps({"base_mib": base, "peak_mib": peak, "decode_s": secs,
                  "max_wait_ms": max(gaps) * 1e3, "waits": len(gaps)}))
'''


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start(server, timeout: float = 120.0) -> threading.Thread:
    """Run a DeglareServer on its own thread until /ping answers. The
    console gets no line per request; the file handler under its log_dir
    keeps them all."""
    import logging

    for h in server.logger.handlers:
        if type(h) is logging.StreamHandler:
            h.setLevel(logging.CRITICAL)
    thread = threading.Thread(target=server.run, daemon=True)
    thread.start()
    deadline = time.time() + timeout
    while True:
        try:
            if _get_json(server.port, "/ping") == (200, {"message": "pong"}):
                return thread
        except OSError:
            pass
        if time.time() > deadline:
            raise AssertionError(f"server on port {server.port} never answered /ping")
        time.sleep(0.05)


def _stop(server, thread) -> None:
    loop = server._server.get_loop()
    loop.call_soon_threadsafe(server._server.close)
    thread.join(timeout=30)
    server.engine.stop()


def _answer_pixels(answer) -> np.ndarray:
    import base64

    from image_enhancement_deglaring_tpu_torch.serve import imaging

    status, payload = answer
    if status != 200:
        raise AssertionError(f"/infer answered {status}: {payload}")
    img = imaging.decode_image(base64.b64decode(payload["image"]))
    if img.mode != "L":
        raise AssertionError(f"/infer answered a {img.mode} PNG")
    return img.pixels


def _resized_reference(engine, luma: np.ndarray, size: int) -> np.ndarray:
    """What /infer in resize mode answers for ``luma``, through the engine
    called directly: LANCZOS to the model's size, the forward, LANCZOS back."""
    from image_enhancement_deglaring_tpu_torch.serve import imaging

    h, w = luma.shape
    small = imaging.resize_lanczos(luma, (size, size)) if (h, w) != (size, size) else luma
    out = engine.infer_batch(small[None])[0]
    return imaging.resize_lanczos(out, (w, h)) if (h, w) != (size, size) else out


def _gate(label: str, pairs) -> float:
    """min PSNR of (got, want) pairs, each of the same shape; fails below
    phase 8's gate."""
    worst = math.inf
    for got, want in pairs:
        if got.shape != want.shape:
            raise AssertionError(f"{label}: answer {got.shape}, want {want.shape}")
        worst = min(worst, psnr_u8(got, want))
    if worst < HTTP_PSNR_GATE_DB:
        raise AssertionError(f"{label}: min PSNR {worst:.2f} dB < {HTTP_PSNR_GATE_DB} dB")
    return worst


def jpeg_uploads(card: str, single_load: dict | None) -> dict:
    """Phase 12a: the port's JPEG decoder on the card's host (no PIL here):
    every committed JPEG fixture decoded and held against the digests PIL
    wrote into the manifest, its decode time; then each POSTed to
    ``create_server`` (bf16, 512, the kernels on): 200 at the upload's
    size, >= 45 dB against the engine called directly on the decoded luma,
    K1/K3 launches 14 and 4 per device batch; and the closed-loop rates of
    one process on the 512x512 JPEG beside the same page as a PNG, at
    phase 8's request count, and on phone-size JPEGs. Returns the launches
    of the counted JPEG traffic."""
    import hashlib
    import shutil
    import tempfile

    from image_enhancement_deglaring_tpu_torch.data.jpeg import decode_jpeg
    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.serve import imaging
    from image_enhancement_deglaring_tpu_torch.serve.http_server import create_server
    from image_enhancement_deglaring_tpu_torch.tools.load_test_api import multipart_body

    with open(os.path.join(JPEG_FIXTURES, "jpeg", "manifest.json")) as f:
        manifest = json.load(f)
    files, lumas = {}, {}
    for name, entry in sorted(manifest.items()):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            img = decode_jpeg(data)
            times.append(time.perf_counter() - t)
        sha = hashlib.sha256(np.ascontiguousarray(img.pixels).tobytes()).hexdigest()
        luma = imaging.to_luma(img.pixels, img.mode)
        luma_sha = hashlib.sha256(luma.tobytes()).hexdigest()
        if (img.mode, list(img.pixels.shape), sha, luma_sha) != (
                entry["mode"], entry["shape"], entry["sha256"], entry["luma_sha256"]):
            raise AssertionError(f"12a {name}: the decode differs from PIL's manifest entry")
        print(f"12a decode {name} ({len(data)} bytes, {img.mode} "
              f"{img.pixels.shape[1]}x{img.pixels.shape[0]}): {sorted(times)[1] * 1e3:.1f} ms "
              f"(median of 3, one thread), pixels and luma equal to PIL's digests", flush=True)
        files[name], lumas[name] = data, luma
    probe = subprocess.run([sys.executable, "-c", JPEG_FOOTPRINT,
                            os.path.join(JPEG_FIXTURES, JPEG_PHONE)], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
    if probe.returncode:
        raise AssertionError(f"12a footprint probe exited {probe.returncode}: "
                             f"{probe.stderr[-2000:]}")
    fp = json.loads(probe.stdout.strip().splitlines()[-1])
    memory = ("not measured (no /proc/self/statm)" if fp["peak_mib"] is None else
              f"{fp['peak_mib'] - fp['base_mib']:.1f} MiB over the process's "
              f"{fp['base_mib']:.1f} MiB (resident set sampled at each tick)")
    print(f"12a {JPEG_PHONE} decoded in a process of its own: peak host memory {memory}; "
          f"{fp['decode_s'] * 1e3:.1f} ms while a 1 ms ticker thread ran, whose longest "
          f"wait for the GIL was {fp['max_wait_ms']:.2f} ms ({fp['waits']} ticks)", flush=True)

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_jpeg_")
    server = create_server(ONNX, host="127.0.0.1", port=_free_port(),
                           compute_dtype=torch.bfloat16, image_size=HTTP_SIZE, max_batch_size=8,
                           mode="resize", warmup=True, log_dir=log_dir)
    thread = _start(server)
    engine, port = server.engine, server.port
    try:
        names = sorted(files)
        bodies = [("/infer", *multipart_body(files[n])) for n in names]

        def served():
            return _get_json(port, "/stats")[1]["batches_dispatched"]

        fk.reset_launch_counts()
        b0 = served()
        answers, alone_ms = [], {}
        for n, b in zip(names, bodies):
            answer, lat, _ = _post_all(port, [b], 1)
            answers.append(answer[0])
            alone_ms[n] = lat[0] * 1e3
        torch.cuda.synchronize()
        counts, forwards = dict(fk.LAUNCHES), served() - b0
        if forward_only(counts) != {"gn_silu_flat": 14 * forwards, "gn_silu_nhwc": 0,
                                    "conv3x3_gn_silu": 4 * forwards,
                                    "conv3x3_gn_silu_batched": 0}:
            raise AssertionError(f"12a JPEG traffic: want 14 K1 and 4 K3 launches per each of "
                                 f"{forwards} forwards, got {counts}")
        worst = _gate("12a JPEG answers", [
            (_answer_pixels(a), _resized_reference(engine, lumas[n], HTTP_SIZE))
            for a, n in zip(answers, names)])
        print(f"12a {len(names)} JPEG uploads answered 200 at their own sizes; min PSNR "
              f"{worst:.2f} dB against the engine called directly (need >= "
              f"{HTTP_PSNR_GATE_DB}); {forwards} device batches, launches {counts}; "
              f"latency of each alone: " + ", ".join(f"{n} {ms:.1f} ms"
                                                     for n, ms in alone_ms.items()), flush=True)

        # closed loops of one process: the 512x512 photo as JPEG and as PNG
        # at phase 8's request count, then phone-size JPEGs
        page = "jpeg/page_512_420_restarts.jpg"
        rgb = decode_jpeg(files[page]).pixels
        n_page = HTTP_LOAD_REQUESTS["up"]
        for kind, payload, n in (("512x512 JPEG", files[page], n_page),
                                 ("512x512 PNG", encode_png(rgb), n_page),
                                 ("4032x3024 JPEG", files[JPEG_PHONE], JPEG_PHONE_LOOP)):
            body = ("/infer", *multipart_body(payload))
            if n == n_page:  # warm the pool
                _post_all(port, [body] * HTTP_CONNECTIONS, HTTP_CONNECTIONS)
            loop_answers, lat, wall = _post_all(port, [body] * n, HTTP_CONNECTIONS)
            if any(a[0] != 200 for a in loop_answers):
                raise AssertionError(f"12a {kind} loop: an answer was not 200")
            p50, _, p99 = _percentiles_ms(lat)
            print(f"12a closed loop, one process, {n} uploads of the {kind} ({len(payload)} "
                  f"bytes) over {HTTP_CONNECTIONS} connections: {n / wall:.2f} req/s, p50 "
                  f"{p50:.1f} ms, p99 {p99:.1f} ms on {card}", flush=True)
        if single_load:
            print("12a beside phase 8's PNG loops in this run: " + ", ".join(
                f"{k} {v['req_per_s']:.2f} req/s" for k, v in single_load.items()
                if isinstance(v, dict) and "req_per_s" in v), flush=True)
        stats = _get_json(port, "/stats")[1]
        print(f"12a host phase p50 over this server's requests: decode "
              f"{stats['host_decode_ms_p50']:.2f} ms, engine {stats['host_engine_ms_p50']:.2f} "
              f"ms, encode {stats['host_encode_ms_p50']:.2f} ms", flush=True)
    finally:
        _stop(server, thread)
        shutil.rmtree(log_dir, ignore_errors=True)
    return {"12a HTTP JPEG": counts}


def every_family_served(card: str) -> dict:
    """Phase 12b: OptimizedUNet and EnhancedUNet served from a ``.pth`` of
    seeded weights under the reference's names (``model_arch="auto"``),
    bf16, 512, mode "both": resize and tile answers against the engine and
    the tiler called directly, a closed loop's req/s; EnhancedUNet also
    behind 2 worker processes, and ``/reload`` of a second ``.pth`` that
    must swap weights and BatchNorm statistics together. No kernel
    launches. Returns the (zero) launch counts.

    Random weights amplify bf16 rounding far more than the trained
    LightweightUNet does, so a frame's answer depends on the batch it rode
    in (cuDNN picks per batch size): checked answers go one request at a
    time, against the engine called on that frame alone (bucket 1)."""
    import tempfile

    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
    from image_enhancement_deglaring_tpu_torch.ops import dec1
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
    from image_enhancement_deglaring_tpu_torch.serve import imaging
    from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine
    from image_enhancement_deglaring_tpu_torch.serve.http_server import create_server
    from image_enhancement_deglaring_tpu_torch.serve.ipc import serve_multiprocess
    from image_enhancement_deglaring_tpu_torch.tools.load_test_api import multipart_body
    import importlib.util

    # the tests' seeded weights, loaded by path: another installed "tests"
    # package cannot shadow it
    spec = importlib.util.spec_from_file_location(
        "torch_port_weights", os.path.join(REPO, "tests", "torch_port_weights.py"))
    weights = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(weights)
    seeded_tree = weights.seeded_tree

    def write_pth(path, arch, params, stats):
        return weights.save_pth(path, weights.state_dict_from_params(arch, params, stats))

    fk.reset_launch_counts()
    dec1.reset_launch_counts()
    gray = make_frames(FAMILY_HTTP_GRAY, HTTP_SIZE, seed=21)
    rgb = rgb_pages(2, *HTTP_RGB_SIZE, seed=22)
    tile = make_frames(1, HTTP_TILE_SIZE[0], seed=23, w=HTTP_TILE_SIZE[1])[0]
    gray_bodies = [("/infer", *multipart_body(encode_png(im))) for im in gray]
    rgb_bodies = [("/infer", *multipart_body(encode_png(im))) for im in rgb]
    tile_body = ("/infer?mode=tile", *multipart_body(encode_png(tile)))

    def direct_engine(path):
        model, _ = load_model_for_eval(path, compute_dtype=torch.bfloat16, device="cuda")
        return InferenceEngine(model, image_size=HTTP_SIZE, max_batch_size=8,
                               compute_dtype=torch.bfloat16, warmup=False, device="cuda")

    with tempfile.TemporaryDirectory() as tmp:
        for arch in ("optimized", "enhanced"):
            params, stats = seeded_tree(arch, 0, FAMILY_WIDTH)
            pth = write_pth(os.path.join(tmp, f"{arch}.pth"), arch, params, stats)
            t0 = time.perf_counter()
            server = create_server(pth, model_arch="auto", host="127.0.0.1", port=_free_port(),
                                   compute_dtype=torch.bfloat16, image_size=HTTP_SIZE,
                                   max_batch_size=8, mode="both", warmup=True,
                                   allow_reload=arch == "enhanced", log_dir=tmp)
            if server.model_info["model"] != arch:
                raise AssertionError(f"12b {pth}: detected {server.model_info['model']}")
            thread = _start(server)
            engine, tiler, port = server.engine, server.tiler, server.port
            try:
                print(f"12b {arch} (init_features {FAMILY_WIDTH}, "
                      f"{sum(p.numel() for p in engine._model.parameters()):,} parameters) "
                      f"from .pth, auto-detected, create_server bf16 {HTTP_SIZE} up in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                def one_by_one(p, bodies):
                    return [_answer_pixels(_post_all(p, [b], 1)[0][0]) for b in bodies]

                ref = [engine.infer_batch(im[None])[0] for im in gray[:4]]
                worst = _gate(f"12b {arch}", list(zip(one_by_one(port, gray_bodies[:4]), ref))
                              + [(got, _resized_reference(engine, imaging.to_luma(im, "RGB"),
                                                          HTTP_SIZE))
                                 for got, im in zip(one_by_one(port, rgb_bodies), rgb)]
                              + [(one_by_one(port, [tile_body])[0], tiler(tile))])
                n = HTTP_LOAD_REQUESTS["up"]
                loop = (gray_bodies * -(-n // len(gray_bodies)))[:n]
                _post_all(port, loop[:HTTP_CONNECTIONS], HTTP_CONNECTIONS)  # warm the pool
                answers, lat, wall = _post_all(port, loop, HTTP_CONNECTIONS)
                if any(a[0] != 200 for a in answers):
                    raise AssertionError(f"12b {arch} loop: an answer was not 200")
                rate = n / wall
                p50, _, p99 = _percentiles_ms(lat)
                print(f"12b {arch}: 4 gray + {len(rgb_bodies)} RGB + 1 tile answers, one at a "
                      f"time, min PSNR {worst:.2f} dB against the engine/tiler called directly;"
                      f" closed loop of {n} uploads {rate:.2f} req/s over {HTTP_CONNECTIONS} "
                      f"connections (p50 "
                      f"{p50:.1f} ms, p99 {p99:.1f} ms) on {card}", flush=True)

                if arch == "enhanced":
                    # behind 2 worker processes: the engine of this process
                    main = sys.modules["__main__"]
                    main_file = main.__dict__.pop("__file__", None)
                    wport = _free_port()
                    try:
                        mps = serve_multiprocess(engine, host="127.0.0.1", port=wport,
                                                 image_size=HTTP_SIZE, n_workers=2, log_dir=tmp,
                                                 address=os.path.join(tmp, "engine.sock"),
                                                 model_info=server.model_info)
                    finally:
                        if main_file is not None:
                            main.__file__ = main_file
                    try:
                        deadline = time.time() + 120
                        while True:
                            try:
                                if _get_json(wport, "/ping")[0] == 200:
                                    break
                            except OSError:
                                pass
                            if time.time() > deadline:
                                raise AssertionError("12b workers never answered /ping")
                            time.sleep(0.1)
                        worst_w = _gate("12b enhanced --workers 2",
                                        list(zip(one_by_one(wport, gray_bodies[:4]), ref)))
                    finally:
                        mps.stop(grace_s=60)
                    print(f"12b enhanced behind 2 worker processes: 4 answers, min PSNR "
                          f"{worst_w:.2f} dB against the engine called directly", flush=True)

                    # /reload of a second .pth: other weights, other statistics
                    params2, stats2 = seeded_tree(arch, 1, FAMILY_WIDTH)
                    second = write_pth(os.path.join(tmp, "enhanced_2.pth"), arch, params2, stats2)
                    mixed = write_pth(os.path.join(tmp, "enhanced_mixed.pth"), arch, params2,
                                      stats)
                    status, data = _post_all(port, [("/reload", json.dumps(
                        {"model_path": second}).encode(), {"Content-Type": "application/json"})],
                        1)[0][0]
                    if status != 200:
                        raise AssertionError(f"12b /reload answered {status}: {data}")
                    after = one_by_one(port, gray_bodies[:4])
                    after_tile = one_by_one(port, [tile_body])[0]
                    e2, em = direct_engine(second), direct_engine(mixed)
                    want2 = [e2.infer_batch(im[None])[0] for im in gray[:4]]
                    want_mixed = [em.infer_batch(im[None])[0] for im in gray[:4]]
                    p_new = _gate("12b /reload vs the second model's engine",
                                  list(zip(after, want2)))
                    p_before = min(psnr_u8(a, r) for a, r in zip(after, ref))
                    p_mixed = min(psnr_u8(a, r) for a, r in zip(after, want_mixed))
                    if not (p_before < HTTP_PSNR_GATE_DB and p_mixed < HTTP_PSNR_GATE_DB):
                        raise AssertionError(
                            f"12b /reload: the answers must leave both the first model ("
                            f"{p_before:.2f} dB) and the second model's weights with the first "
                            f"statistics ({p_mixed:.2f} dB)")
                    if psnr_u8(after_tile, tiler(tile)) < HTTP_PSNR_GATE_DB:
                        raise AssertionError("12b /reload: the tiler kept other weights")
                    print(f"12b /reload of a second EnhancedUNet .pth: answers {p_new:.2f} dB "
                          f"against its engine; against the first model {p_before:.2f} dB, "
                          f"against its weights with the first statistics {p_mixed:.2f} dB; "
                          f"the tiler swapped too", flush=True)
            finally:
                _stop(server, thread)
    torch.cuda.synchronize()
    counts = {**fk.LAUNCHES, **dec1.LAUNCHES}
    if any(counts.values()):
        raise AssertionError(f"12b launched kernels: {counts}")
    print(f"12b kernel launches over the other families' serving: {counts}", flush=True)
    return {"12b HTTP other families": counts}


def optimized_f32_layers(card: str) -> None:
    """Phase 12c: OptimizedUNet's f32 forward card vs CPU (phase 11f's
    model and input), located layer by layer: each top-level module's
    output error as the forward propagates it, and its own error when the
    card runs it on the CPU run's input to it; relative to the output's
    largest magnitude."""
    from image_enhancement_deglaring_tpu_torch.modelio import export_jax_params, load_jax_params
    from image_enhancement_deglaring_tpu_torch.models import OptimizedUNet
    from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import highest_precision

    xf, _ = triptych_batch(2, TRAIN_SIZE, seed=14)
    params = export_jax_params(OptimizedUNet(generator=torch.Generator().manual_seed(0)))
    models, seen = {}, {}
    for device in ("cuda", "cpu"):
        m = OptimizedUNet().to(device).eval()
        load_jax_params(m, params)
        models[device], seen[device] = m, []
        for name, mod in m.named_children():
            mod.register_forward_hook(lambda mod, args, out, device=device, name=name:
                                      seen[device].append((name, args[0].detach(),
                                                           out.detach())))
        with torch.no_grad(), highest_precision():
            seen[device].append(("output", None, m(torch.from_numpy(xf).to(device))))
    rows = []
    for (name, x_cpu, y_cpu), (_, _, y_card) in zip(seen["cpu"], seen["cuda"]):
        scale = float(y_cpu.abs().max())
        prop = float((y_card.cpu() - y_cpu).abs().max())
        own = math.nan
        if x_cpu is not None:
            with torch.no_grad(), highest_precision():
                own = float((getattr(models["cuda"], name)(x_cpu.cuda()).cpu() - y_cpu)
                            .abs().max())
        rows.append((name, scale, prop, own))
    print(f"12c OptimizedUNet f32 card vs CPU by module on {card} (phase 11f's model and "
          f"input), max |out|, propagated |err|, own |err| (card on the CPU's input), own "
          f"relative:", flush=True)
    for name, scale, prop, own in rows:
        print(f"12c   {name:>11}: max|out| {scale:.4g}, propagated {prop:.3g}, own {own:.3g}, "
              f"own/max|out| {own / scale if scale else math.nan:.3g}", flush=True)
    worst = max((r for r in rows if not math.isnan(r[3])), key=lambda r: r[3] / max(r[1], 1e-30))
    print(f"12c largest own relative error: {worst[0]} ({worst[3] / worst[1]:.3g}); final "
          f"output error {rows[-1][2]:.3g} (gate 1e-4 in phase 11f)", flush=True)


def jpeg_and_families(card: str, single_load: dict | None) -> dict:
    """Phase 12: 12a JPEG uploads, 12b every family served, 12c
    OptimizedUNet's f32 error by layer. Returns launches by path."""
    counts = {}
    for label, fn, *args in (("12a", jpeg_uploads, card, single_load),
                             ("12b", every_family_served, card),
                             ("12c", optimized_f32_layers, card)):
        t = time.perf_counter()
        out = fn(*args)
        if out:
            counts.update(out)
        print(f"phase {label}: {time.perf_counter() - t:.1f} s", flush=True)
    return counts



# phase 13: the model-artifact lifecycle and int8 serving, on the production
# LightweightUNet (features 8..128, 486,409 parameters), 512^2, bf16, the
# kernels on. Gates: the export's parameters bit for bit and its answers
# at inf dB (13b); run_onnx on the host against the f32 forward on the
# card within LIFECYCLE_ONNX_ATOL at 64^2 (the CPU tests' bound for the
# f32 forward against the numpy executor); int8 weights >= 45 dB against
# the unquantized engine (the JAX package's gate, tests/test_serve.py);
# the act_scales forward >= 20 dB SNR against the exact one (its gate,
# tests/test_quant_act.py). K1/K3 exactly 14/4 per forward on each path.
LIFECYCLE_TRAIN, LIFECYCLE_EPOCHS, LIFECYCLE_ONNX_ATOL = 24, 2, 1e-4
INT8_PAGES, INT8_ROUNDS = 8, 5
INT8_PSNR_GATE_DB, ACT_SNR_GATE_DB, ACT_CALIB_PAGES = 45.0, 20.0, 4
STAGES = ("make_synthetic", "check_dataset", "sweep", "train", "export_onnx", "evaluate_onnx",
          "crossval_gate", "serve_up", "test_api_all", "frontend_proxy", "sigterm_drain")


def _per_forward(counts: dict, forwards: int, label: str) -> None:
    """Fails unless K1 and K3 launched exactly 14 and 4 times per forward
    and no other kernel of the port did."""
    want = {"gn_silu_flat": 14 * forwards, "gn_silu_nhwc": 0, "conv3x3_gn_silu": 4 * forwards,
            "conv3x3_gn_silu_batched": 0, "dec1_output": 0}
    if forwards == 0 or forward_only(counts) != want:
        raise AssertionError(f"{label}: want 14 K1 / 4 K3 launches per forward over "
                             f"{forwards} forwards, got {counts}")


def _launches() -> dict:
    from image_enhancement_deglaring_tpu_torch.ops import dec1
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    torch.cuda.synchronize()
    return {**fk.LAUNCHES, **dec1.LAUNCHES}


def _reset_launches() -> None:
    from image_enhancement_deglaring_tpu_torch.ops import dec1
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    torch.cuda.synchronize()
    fk.reset_launch_counts()
    dec1.reset_launch_counts()


def lifecycle_cli(work: str) -> dict:
    """Phase 13a: ``tools.e2e_lifecycle --device cuda --size 512`` in its own
    process: every stage's PASS line, rc 0, the export over 1,000,000
    bytes. Returns its summary."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "image_enhancement_deglaring_tpu_torch.tools.e2e_lifecycle",
                        "--device", "cuda", "--size", "512", "--epochs", str(LIFECYCLE_EPOCHS),
                        "--work_dir", work], cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    passed = [ln.split()[1] for ln in r.stdout.splitlines() if ln.startswith("PASS ")]
    if r.returncode != 0 or tuple(passed) != STAGES:
        raise AssertionError(f"13a lifecycle rc {r.returncode}, passed {passed}: "
                             f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    summary = json.loads(next(ln for ln in r.stdout.splitlines()
                              if ln.startswith("E2E_SUMMARY ")).split(" ", 1)[1])
    if summary["onnx_bytes"] <= 1_000_000:
        raise AssertionError(f"13a export of {summary['onnx_bytes']} bytes")
    print(f"13a tools.e2e_lifecycle --device cuda --size 512 ({LIFECYCLE_TRAIN} train + 8 val "
          f"triptychs, {LIFECYCLE_EPOCHS} epochs): every stage PASS, rc 0, "
          f"{time.perf_counter() - t0:.1f} s; best val L1 "
          f"{summary['train_best_val_loss']:.5f}, the export's L1 {summary['onnx_l1']:.4f}, "
          f"{summary['onnx_bytes']:,} bytes; the sweep's best {summary['sweep_best']} at val L1 "
          f"{summary['sweep_best_val_loss']:.5f}; promotion gate {summary['gate_verdict']}",
          flush=True)
    print("13a stage seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                             summary["stage_seconds"].items()), flush=True)
    return summary


def exported_artifact(card: str, work: str) -> dict:
    """Phase 13b: 13a's export against its checkpoint: the parameters bit
    for bit; ``create_server`` on each answers the same pages at inf dB, one
    at a time, K1/K3 14/4 per forward; ``run_onnx`` on the host against the
    f32 forward on the card at 64^2. Returns the launches."""
    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
    from image_enhancement_deglaring_tpu_torch.modelio import run_onnx
    from image_enhancement_deglaring_tpu_torch.serve.http_server import create_server
    from image_enhancement_deglaring_tpu_torch.tools.load_test_api import multipart_body
    from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

    onnx = os.path.join(work, "models", "best_model.onnx")
    ckpt = os.path.join(work, "models", "best_model")
    trees = {p: flatten_tree(load_model_for_eval(p, device="cuda")[1]) for p in (onnx, ckpt)}
    if trees[onnx].keys() != trees[ckpt].keys() or not all(
            np.array_equal(trees[onnx][k], trees[ckpt][k]) for k in trees[ckpt]):
        raise AssertionError("13b: the export's parameters differ from its checkpoint's")
    pages = make_frames(4, HTTP_SIZE, seed=131)
    bodies = [("/infer", *multipart_body(encode_png(im))) for im in pages]
    answers, counts = {}, {}
    for label, path in (("onnx", onnx), ("checkpoint", ckpt)):
        server = create_server(path, host="127.0.0.1", port=_free_port(),
                               compute_dtype=torch.bfloat16, image_size=HTTP_SIZE,
                               max_batch_size=8, warmup=True, log_dir=work, device="cuda")
        thread = _start(server)
        try:
            b0 = server.engine.stats()["batches_dispatched"]
            _reset_launches()
            answers[label] = [_answer_pixels(_post_all(server.port, [b], 1)[0][0])
                              for b in bodies]
            counts = _launches()
            _per_forward(counts, server.engine.stats()["batches_dispatched"] - b0,
                         f"13b create_server({label})")
        finally:
            _stop(server, thread)
    worst = min(psnr_u8(a, b) for a, b in zip(answers["onnx"], answers["checkpoint"]))
    if worst != math.inf:
        raise AssertionError(f"13b: the export answers {worst:.2f} dB against its checkpoint")

    model, _ = load_model_for_eval(onnx, device="cuda")  # float32, the kernels on
    x = triptych_batch(2, 64, seed=132)[0]
    with torch.inference_mode():
        card_out = model(torch.from_numpy(x).cuda()).cpu().numpy()
    t0 = time.perf_counter()
    host = run_onnx(onnx, {"input": x.transpose(0, 3, 1, 2).copy()})["output"]
    t_host = time.perf_counter() - t0
    err = float(np.abs(host.transpose(0, 2, 3, 1) - card_out).max())
    print(f"13b export vs checkpoint: {len(trees[ckpt])} leaves equal bit for bit; "
          f"create_server on each, {len(pages)} pages one at a time: min PSNR {worst} dB, "
          f"K1/K3 launches {counts['gn_silu_flat']}/{counts['conv3x3_gn_silu']} over "
          f"{len(pages)} forwards; run_onnx (numpy, {t_host:.2f} s on the host) vs the f32 "
          f"forward on {card} at 2x64x64: max |diff| {err:.3g} (need <= "
          f"{LIFECYCLE_ONNX_ATOL})", flush=True)
    if err > LIFECYCLE_ONNX_ATOL:
        raise AssertionError(f"13b run_onnx vs the card: {err:.3g}")
    return {"13b HTTP exported .onnx": counts}


def int8_weights(card: str, work: str) -> dict:
    """Phase 13c: ``InferenceEngine(quantize="int8")`` on best_model.onnx
    against ``quantize=None``, the kernels on: fidelity in float32 (the JAX
    gate's dtype and inputs) and in bf16, int8 storage on the card,
    ``reload_params``, bf16 img/s at buckets 8 and 64 in interleaved rounds,
    launches; then one /infer through ``cli.serve --quantize int8
    --workers 2``. Returns the launches of the int8 forwards."""
    import shutil
    import signal
    import tempfile

    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
    from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine
    from image_enhancement_deglaring_tpu_torch.tools.load_test_api import multipart_body
    from image_enhancement_deglaring_tpu_torch.train.checkpoint import restore_params
    from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

    def pair(dtype, max_batch, warmup):
        model, params = load_model_for_eval(ONNX, compute_dtype=dtype, device="cuda")
        return {q: InferenceEngine(model, image_size=512, max_batch_size=max_batch,
                                   compute_dtype=dtype, quantize=q, device="cuda",
                                   warmup=warmup) for q in (None, "int8")}, params

    # the gate's inputs are the JAX test's: uniform random frames, float32
    # engines; seeded synthetic pages, and both in bf16, are read beside it
    noise = (np.random.default_rng(133).random((INT8_PAGES, 512, 512)) * 255).astype(np.uint8)
    pages = make_frames(INT8_PAGES, 512, seed=133)
    f32, _ = pair(torch.float32, 8, False)
    engines, prod_params = pair(torch.bfloat16, 64, True)
    q8 = engines["int8"]
    psnr, total = {}, {}
    for dtype, pr in (("float32", f32), ("bf16", engines)):
        for kind, frames in (("noise", noise), ("pages", pages)):
            want = pr[None].infer_batch(frames)
            _reset_launches()
            got = pr["int8"].infer_batch(frames)
            counts = _launches()
            _per_forward(counts, 1, f"13c int8 engine {dtype}")
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            psnr[(dtype, kind)] = [psnr_u8(a, b) for a, b in zip(got, want)] + [
                psnr_u8(got, want)]
            if (dtype, kind) == ("bf16", "noise"):
                got_bf16 = got
    print(f"13c int8 weights against the unquantized engine, {INT8_PAGES} frames at 512^2, "
          f"K1/K3 14/4 per forward on {card}:", flush=True)
    for (dtype, kind), v in psnr.items():
        print(f"13c   {dtype} {kind}: PSNR {v[-1]:.2f} dB over the batch, per frame "
              + ", ".join(f"{x:.2f}" for x in v[:-1])
              + (f" (need >= {INT8_PSNR_GATE_DB})" if (dtype, kind) == ("float32", "noise")
                 else " (no gate)"), flush=True)
    p = psnr[("float32", "noise")][-1]
    if p < INT8_PSNR_GATE_DB:
        raise AssertionError(f"13c int8 fidelity {p:.2f} dB")
    for eng in f32.values():
        eng.stop()
    got = got_bf16

    q_leaves = flatten_tree(q8._int8[1])
    s_leaves = flatten_tree(q8._int8[2])
    kernels = {k: v for k, v in q_leaves.items() if v.ndim >= 2}
    bad = [k for k, v in kernels.items() if v.dtype != torch.int8 or v.device.type != "cuda"]
    if bad or not kernels:
        raise AssertionError(f"13c: leaves not int8 on the card: {bad}")
    int8_bytes = sum(v.numel() for v in kernels.values())
    scale_bytes = sum(s_leaves[k].numel() * 4 for k in kernels)
    f32_bytes = sum(v.numel() * 4 for v in kernels.values())
    rest = sum(v.numel() * v.element_size() for k, v in q_leaves.items() if k not in kernels)
    print(f"13c int8 weights on {card}: {len(kernels)} kernels as torch.int8 on cuda, "
          f"{int8_bytes:,} B + {scale_bytes:,} B of float32 scales against {f32_bytes:,} B in "
          f"float32 ({(int8_bytes + scale_bytes) / f32_bytes:.3f}x); {len(q_leaves) - len(kernels)}"
          f" vectors stay float32 ({rest:,} B)", flush=True)

    # reload_params quantizes again: 13a's trained weights against a fresh
    # int8 engine on them
    params = restore_params(os.path.join(work, "models", "best_model"))
    q8.reload_params(params)
    fresh_model, _ = load_model_for_eval(os.path.join(work, "models", "best_model"),
                                         compute_dtype=torch.bfloat16, device="cuda")
    fresh = InferenceEngine(fresh_model, image_size=512, max_batch_size=64,
                            compute_dtype=torch.bfloat16, quantize="int8", device="cuda",
                            warmup=False)
    a, b = q8.infer_batch(noise), fresh.infer_batch(noise)
    if not np.array_equal(a, b) or psnr_u8(a, got) >= INT8_PSNR_GATE_DB:
        raise AssertionError(f"13c reload_params: {psnr_u8(a, b):.2f} dB against a fresh int8 "
                             f"engine, {psnr_u8(a, got):.2f} dB against the old weights")
    print(f"13c reload_params under int8 (13a's weights): equal to a fresh int8 engine bit for "
          f"bit; {psnr_u8(a, got):.2f} dB against the old weights' answers", flush=True)
    q8.reload_params(prod_params)  # back to the production weights for the rates

    frames = make_frames(64, 512, seed=134)
    rates: dict = {}
    for b, iters in ((8, 30), (64, 8)):
        for q, eng in engines.items():
            eng.infer_batch(frames[:b])
        for r in range(INT8_ROUNDS):
            order = list(engines)
            random.Random(r).shuffle(order)
            for q in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    engines[q].infer_batch(frames[:b])
                rates.setdefault((b, q), []).append(b * iters / (time.perf_counter() - t0))
    for b in (8, 64):
        line = []
        for q in (None, "int8"):
            v = sorted(rates[(b, q)])
            line.append(f"{q or 'bf16'} {v[len(v) // 2]:.1f} img/s ({v[0]:.1f}-{v[-1]:.1f})")
        med = {q: sorted(rates[(b, q)])[INT8_ROUNDS // 2] for q in (None, "int8")}
        print(f"13c infer_batch bucket {b}, 512^2, {INT8_ROUNDS} interleaved rounds, median "
              f"(range): {'; '.join(line)}; int8/bf16 {med['int8'] / med[None]:.4f} on {card}",
              flush=True)
    busy = {q: busy_share(lambda q=q: engines[q].infer_batch(frames)) for q in engines}
    print("13c one bucket-64 batch: " + "; ".join(
        f"{q or 'bf16'} device busy {ms:.3f} ms, busy share {sh:.3f}"
        for q, (ms, sh) in busy.items()), flush=True)
    for eng in engines.values():
        eng.stop()

    # cli.serve --quantize int8 --workers 2 in its own process
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m",
                             "image_enhancement_deglaring_tpu_torch.cli.serve",
                             "--model_path", ONNX, "--host", "127.0.0.1", "--port", str(port),
                             "--workers", "2", "--quantize", "int8", "--log_dir", tmp], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while True:
            try:
                if _get_json(port, "/ping") == (200, {"message": "pong"}):
                    break
            except OSError:
                pass
            if time.time() > deadline or proc.poll() is not None:
                raise AssertionError("13c cli.serve --quantize int8 never answered /ping")
            time.sleep(0.1)
        t_up = time.perf_counter() - t0
        (status, payload), = _post_all(port, [("/infer", *multipart_body(
            encode_png(noise[0])))], 1)[0]
        stats = _get_json(port, "/stats")[1]
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=300)[0]
    finally:
        proc.kill()
        proc.wait(60)
        shutil.rmtree(tmp, ignore_errors=True)
    p_cli = psnr_u8(_answer_pixels((status, payload)), got[0]) if status == 200 else -math.inf
    print(f"13c cli.serve --quantize int8 --workers 2: /ping after {t_up:.1f} s, /infer {status} "
          f"at {p_cli:.2f} dB against the int8 engine, /stats quantize "
          f"{stats.get('quantize')!r}, SIGTERM exit code {proc.returncode}", flush=True)
    if (status != 200 or stats.get("quantize") != "int8" or proc.returncode != 0
            or p_cli < INT8_PSNR_GATE_DB):
        raise AssertionError(f"13c cli.serve --quantize int8: {status}, {stats}, exit "
                             f"{proc.returncode}: {out[-2000:]}")
    return {"13c int8 engine": total}


def int8_activations(card: str) -> dict:
    """Phase 13d: ``calibrate_act_scales`` on seeded 512^2 pages, then the
    forward with every site and with ``HOT_SITES_512`` against
    ``act_scales=None`` at buckets 8 and 64: SNR, device ms and busy share,
    launches. Returns the launches of the quantized forwards."""
    from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
    from image_enhancement_deglaring_tpu_torch.models import calibrate_act_scales
    from image_enhancement_deglaring_tpu_torch.ops.quant import HOT_SITES_512, subset_act_scales

    model, _ = load_model_for_eval(ONNX, compute_dtype=torch.bfloat16, device="cuda")
    calib = triptych_batch(ACT_CALIB_PAGES, 512, seed=135)[0]
    t0 = time.perf_counter()
    scales = calibrate_act_scales(model, [calib])
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    sites = {"all": scales, "hot": subset_act_scales(scales, HOT_SITES_512)}
    n_sites = {k: sum(len(v) if isinstance(v, dict) else 1 for v in s.values())
               for k, s in sites.items()}
    print(f"13d calibrate_act_scales on {ACT_CALIB_PAGES} seeded 512^2 pages: {t_cal:.2f} s, "
          f"{n_sites['all']} sites ({n_sites['hot']} in HOT_SITES_512)", flush=True)
    total: dict = {}
    x64 = torch.from_numpy(triptych_batch(64, 512, seed=136)[0]).to("cuda", torch.bfloat16)
    for b in (8, 64):
        x = x64[:b]
        with torch.inference_mode():
            exact = model(x)
            for label, sc in sites.items():
                _reset_launches()
                got = model(x, act_scales=sc)
                counts = _launches()
                _per_forward(counts, 1, f"13d act_scales={label} bucket {b}")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
                snr = 10 * math.log10(float(exact.square().mean())
                                      / float((got - exact).square().mean()))
                if snr < ACT_SNR_GATE_DB:
                    raise AssertionError(f"13d {label} bucket {b}: SNR {snr:.2f} dB")
                print(f"13d act_scales={label} ({n_sites[label]} sites) bucket {b}: SNR "
                      f"{snr:.2f} dB against the exact forward (need >= {ACT_SNR_GATE_DB}); "
                      f"K1/K3 {counts['gn_silu_flat']}/{counts['conv3x3_gn_silu']}",
                      flush=True)
        for label, sc in (("none", None), *sites.items()):
            def fwd(sc=sc):
                with torch.inference_mode():
                    model(x, act_scales=sc)
            ms, share = busy_share(fwd)
            t = time_ms(fwd, iters=5 if b == 64 else 10, warmup=2, rounds=3)
            print(f"13d bucket {b} act_scales={label}: device busy {ms:.3f} ms per forward, busy "
                  f"share {share:.3f}; {t:.3f} ms per forward by CUDA events on {card}",
                  flush=True)
    return {"13d act_scales forward": total}


def lifecycle_and_int8(card: str) -> dict:
    """Phase 13: 13a the lifecycle through the port's CLIs, 13b the exported
    artifact, 13c int8 weights, 13d int8 activations. Returns launches by
    path."""
    import shutil
    import tempfile

    counts: dict = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    try:
        for label, fn, *args in (("13a", lifecycle_cli, work),
                                 ("13b", exported_artifact, card, work),
                                 ("13c", int8_weights, card, work),
                                 ("13d", int8_activations, card)):
            t = time.perf_counter()
            out = fn(*args)
            if label != "13a":
                counts.update(out)
            print(f"phase {label}: {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


# phase 14: hyperparameter sweeps on one card (parallel.sweep, cli.sweep),
# the production LightweightUNet at full width, 512^2, bf16 unless said;
# the groups train on the composition (the training pair has no vmap
# rule), the single steps on the training pair. 14a
# holds a lock-step group of SWEEP_CFG's 4 trials against 4 single-trial
# steps (make_step_body + ClippedAdamW) from the same weights. Gates, set
# before the first card run from the CPU tests' rules: f32 (TF32 off)
# losses rel 1e-5 and each trial's parameters within 2 * its lr (one Adam
# sign flip) with at most 1 % beyond 1e-5; bf16 losses rel 1e-2 and, at the
# first step, each gradient leaf's cosine >= 0.95 (tests/test_torch_port_
# train.py's bf16 rule). 14b times the group step against its K trials'
# single steps in turns, under the deterministic algorithms cli.sweep runs
# on the card, and one case under the defaults beside them; 14c/14d run
# cli.sweep as a user does, in processes of their own without
# CUBLAS_WORKSPACE_CONFIG: the CLI sets up its own determinism, so a
# resumed sweep can equal the uninterrupted one bit for bit.
SWEEP_CFG = [(2e-3, 1e-4), (1e-3, 1e-5), (5e-3, 5e-4), (3e-4, 1e-6)]
SWEEP_BATCH, SWEEP_STEPS = 4, 3
SWEEP_GATE = {"f32_loss_rel": 1e-5, "f32_share_beyond_1e-5": 0.01, "bf16_loss_rel": 1e-2,
              "bf16_grad_cos": 0.95}
# (batch, trials, deterministic algorithms)
SWEEP_RATE_CASES = ((16, 1, True), (16, 4, True), (16, 8, True), (32, 1, True), (32, 4, True),
                    (16, 8, False))
SWEEP_PAIRS, SWEEP_ROUNDS, SWEEP_ROUND_STEPS = 256, 4, 5
SWEEP_CLI_TRAIN, SWEEP_CLI_VAL = 64, 16
SWEEP_CLI_FLAGS = ["--method", "tpe", "--sweep_count", "6", "--max_epochs", "3",
                   "--early_stop_min_iter", "1", "--eta", "3", "--parallel_trials", "4",
                   "--resident_data", "--num_workers", "8"]


def _sweep_model(dtype, family: str = "basic"):
    from image_enhancement_deglaring_tpu_torch.models import EnhancedUNet, LightweightUNet

    gen = torch.Generator().manual_seed(14)
    if family == "enhanced":
        return EnhancedUNet(init_features=FAMILY_WIDTH, dtype=dtype, generator=gen)
    return LightweightUNet(dtype=dtype, generator=gen)


def sweep_group_parity(card: str) -> None:
    """Phase 14a: the group against K single-trial steps from the same
    weights, f32 and bf16; EnhancedUNet's stateful group."""
    from image_enhancement_deglaring_tpu_torch.ops.metrics import l1_loss
    from image_enhancement_deglaring_tpu_torch.parallel import Trial, VmappedTrialGroup
    from image_enhancement_deglaring_tpu_torch.train import TrainState, make_optimizer
    from image_enhancement_deglaring_tpu_torch.train.loop import make_step_body

    x, y = (torch.from_numpy(a).cuda() for a in
            triptych_batch(SWEEP_BATCH * SWEEP_STEPS, 512, seed=141))
    batches = [(x[s * SWEEP_BATCH:(s + 1) * SWEEP_BATCH], y[s * SWEEP_BATCH:(s + 1) * SWEEP_BATCH])
               for s in range(SWEEP_STEPS)]
    body = make_step_body()
    got = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        g = VmappedTrialGroup(_sweep_model(dtype), [Trial(i, SWEEP_BATCH, lr, wd) for i, (lr, wd)
                                                    in enumerate(SWEEP_CFG)], seed=0,
                              device="cuda")
        singles = []
        for lr, wd in SWEEP_CFG:
            m = _sweep_model(dtype).cuda()
            singles.append(TrainState(model=m, optimizer=make_optimizer(m, lr, wd, 1.0)))
        if tag == "bf16":  # the first step's gradients, before any update
            _, grads, _ = g._loss_and_grads(*batches[0])
            m = singles[0].model
            m.zero_grad(set_to_none=True)
            l1_loss(m(batches[0][0]), batches[0][1]).backward()
            cos = min((float(torch.nn.functional.cosine_similarity(
                grads[n][k].flatten().float(), p.grad.flatten().float(), dim=0)), n)
                for n, p in m.named_parameters() for k in range(len(SWEEP_CFG)))
            m.zero_grad(set_to_none=True)
        lg, ls = [], []
        for xb, yb in batches:
            lg.append(g._train_step(xb, yb).double().cpu())
            ls.append(torch.stack([body(st, xb, yb)[1] for st in singles]).double().cpu())
        lg, ls = torch.stack(lg), torch.stack(ls)
        loss_rel = float(((lg - ls).abs() / ls.abs()).max())
        worst, beyond, total = [], 0, 0
        for k, (st, (lr, _)) in enumerate(zip(singles, SWEEP_CFG)):
            d = [(g.params[n][k] - p.detach()).abs() for n, p in st.model.named_parameters()]
            worst.append(max(float(t.max()) for t in d) / (2 * lr))
            beyond += sum(int((t > 1e-5).sum()) for t in d)
            total += sum(t.numel() for t in d)
        got[tag] = (loss_rel, max(worst), beyond / total)
        print(f"14a {tag} group of {len(SWEEP_CFG)} (lr/wd {SWEEP_CFG}) vs {len(SWEEP_CFG)} "
              f"single-trial steps, {SWEEP_STEPS} steps of {SWEEP_BATCH}x512^2 on {card}: "
              f"losses max rel diff {loss_rel:.3g}; parameters max |diff| / (2 lr) "
              f"{max(worst):.3g} (per trial {', '.join(f'{w:.3g}' for w in worst)}), share "
              f"beyond 1e-5 {beyond / total:.3g} of {total}"
              + (f"; first-step gradient cosine min {cos[0]:.6f} ({cos[1]})"
                 if tag == "bf16" else ""), flush=True)
        del g, singles
    bad = [got["f32"][0] > SWEEP_GATE["f32_loss_rel"], got["f32"][1] > 1.0,
           got["f32"][2] > SWEEP_GATE["f32_share_beyond_1e-5"],
           got["bf16"][0] > SWEEP_GATE["bf16_loss_rel"], cos[0] < SWEEP_GATE["bf16_grad_cos"]]
    if any(bad):
        raise AssertionError(f"14a group vs single steps beyond the gates {SWEEP_GATE}: {got}, "
                             f"cosine {cos}")

    # EnhancedUNet: two identical trials stay identical, the statistics
    # move. cuDNN's default weight-gradient algorithms may sum in an order
    # that varies from call to call, so the trials are equal bit for bit
    # only under deterministic algorithms (gated); the default is read
    size, bs = 128, 4
    xe, ye = (torch.from_numpy(a).cuda() for a in triptych_batch(2 * bs, size, seed=142))
    for det in (False, True):
        with deterministic() if det else contextlib.nullcontext():
            g = VmappedTrialGroup(_sweep_model(torch.bfloat16, "enhanced"),
                                  [Trial(i, bs, 1e-3, 1e-5) for i in range(2)], seed=0,
                                  device="cuda")
            stats0 = {k: v.clone() for k, v in g.model_state.items()}
            g.generator.manual_seed(14)
            losses = [g._train_step(xe[s * bs:(s + 1) * bs], ye[s * bs:(s + 1) * bs]).cpu()
                      for s in range(2)]
        apart = max(float((v[0] - v[1]).abs().max()) for tree in (g.params, g.model_state)
                    for v in tree.values())
        moved = sum(not torch.equal(g.model_state[k], v) for k, v in stats0.items())
        print(f"14a EnhancedUNet (init_features {FAMILY_WIDTH}, bf16, {bs}x{size}^2) group of 2 "
              f"identical trials, 2 steps, {'deterministic' if det else 'default'} algorithms: "
              f"losses {[l.tolist() for l in losses]}; the trials' largest |diff| {apart:.3g}"
              f"{' (gate 0)' if det else ' (read)'}; {moved} of {len(stats0)} BatchNorm "
              f"statistics moved", flush=True)
        if moved != len(stats0) or not all(torch.isfinite(l).all() for l in losses):
            raise AssertionError("14a EnhancedUNet's stateful group")
    if apart != 0:
        raise AssertionError("14a EnhancedUNet's identical trials differ under deterministic "
                             "algorithms")


def _sweep_rate_case(x, y, bs: int, k: int, det: bool, card: str) -> None:
    """One (batch, K) case of phase 14b: the group step against its K
    trials' single steps, in turns."""
    from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch
    from image_enhancement_deglaring_tpu_torch.parallel import Trial, VmappedTrialGroup
    from image_enhancement_deglaring_tpu_torch.train import TrainState, make_optimizer
    from image_enhancement_deglaring_tpu_torch.train.loop import make_step_body
    from image_enhancement_deglaring_tpu_torch.train.resident import epoch_batch_plan

    body = make_step_body(augment_fn=device_augment_batch)
    cfg = [(SWEEP_CFG[i % 4][0], SWEEP_CFG[i % 4][1]) for i in range(k)]
    g = VmappedTrialGroup(_sweep_model(torch.bfloat16), [Trial(i, bs, lr, wd) for i, (lr, wd)
                                                         in enumerate(cfg)], seed=0,
                          augment_fn=device_augment_batch, device="cuda")
    singles = []
    for i, (lr, wd) in enumerate(cfg):
        m = _sweep_model(torch.bfloat16).cuda()
        singles.append(TrainState(model=m, optimizer=make_optimizer(m, lr, wd, 1.0),
                                  generator=torch.Generator("cuda").manual_seed(i)))
    plan = epoch_batch_plan(14, 0, SWEEP_PAIRS, bs, device="cuda")
    steps = {"group": lambda xb, yb: g._train_step(xb, yb),
             "loop": lambda xb, yb: [body(st, xb, yb) for st in singles]}
    peak, times, i = {}, {name: [] for name in steps}, 0
    for name, fn in steps.items():  # two warm steps; the second one's peak
        fn(x.index_select(0, plan[0]), y.index_select(0, plan[0]))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(x.index_select(0, plan[1]), y.index_select(0, plan[1]))
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() / 2**30,
                      (torch.cuda.max_memory_allocated() - base) / 2**30)
    for r in range(SWEEP_ROUNDS):
        for name in (("group", "loop") if r % 2 == 0 else ("loop", "group")):
            for _ in range(SWEEP_ROUND_STEPS):
                row = plan[i % plan.shape[0]]
                i += 1
                xb, yb = x.index_select(0, row), y.index_select(0, row)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                e0.record()
                steps[name](xb, yb)
                e1.record()
                times[name].append((e0, e1))
    torch.cuda.synchronize()
    med = {n: float(np.median([a.elapsed_time(b) for a, b in ev])) for n, ev in times.items()}
    print(f"14b batch {bs}, K {k}, {'deterministic' if det else 'default'} algorithms: group "
          f"step {med['group']:.2f} ms median of {len(times['group'])} "
          f"({k * bs / med['group'] * 1e3:.1f} trial-img/s), K single steps {med['loop']:.2f} ms "
          f"({k * bs / med['loop'] * 1e3:.1f} trial-img/s); stack vs loop "
          f"{med['loop'] / med['group']:.3f}x; peak memory group {peak['group'][0]:.3f} GiB "
          f"(+{peak['group'][1]:.3f} over its state and data), loop {peak['loop'][0]:.3f} GiB "
          f"(+{peak['loop'][1]:.3f}) on {card}", flush=True)


def sweep_rates(card: str) -> None:
    """Phase 14b: group step ms (CUDA events, median of 20), trial-img/s
    and peak memory per (batch, K), beside its K trials' single steps run
    one after another, in turns, under cli.sweep's deterministic algorithms
    (one case under the defaults); then tools.sweep_resident_bench under
    the same setting."""
    from image_enhancement_deglaring_tpu_torch.tools.sweep_resident_bench import run as bench

    x, y = triptych_batch(SWEEP_PAIRS, 512, seed=143)
    x, y = torch.from_numpy(x).to("cuda", torch.bfloat16), torch.from_numpy(y).cuda()
    print(f"14b {SWEEP_PAIRS} resident synthetic pairs at 512^2 (bf16 inputs, f32 targets), "
          f"device augmentation, bf16 compute, on {card}:", flush=True)
    for bs, k, det in SWEEP_RATE_CASES:
        with deterministic() if det else contextlib.nullcontext():
            _sweep_rate_case(x, y, bs, k, det, card)
        torch.cuda.empty_cache()
    del x, y
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with deterministic():
        r = bench(n=128, size=512, bs=16, k=8, epochs=1, dtype="bfloat16", device="cuda")
    print(f"14b tools.sweep_resident_bench --n 128 --size 512 --bs 16 --k 8 --epochs 1 --dtype "
          f"bfloat16, deterministic algorithms: per-step epoch {r['stepwise_epoch_s']:.3f} s, "
          f"resident {r['resident_epoch_s']:.3f} s, per-step / resident {r['speedup']:.3f}x; "
          f"peak GiB {r['peak_gib']} ({time.perf_counter() - t0:.1f} s in all) on {card}",
          flush=True)
    torch.cuda.empty_cache()


def _sweep_cli(args: list, log: str, **kw) -> subprocess.Popen:
    """``python -m ...cli.sweep`` in a process of its own, as a user runs
    it: without this script's CUBLAS_WORKSPACE_CONFIG, which the CLI sets
    up itself with its deterministic algorithms."""
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m",
                                 "image_enhancement_deglaring_tpu_torch.cli.sweep", *args],
                                cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT, **kw)


def _sweep_outcome(out: str) -> tuple[dict, dict]:
    """(results file, journal val losses by trial id) of a sweep directory."""
    with open(os.path.join(out, "sweep_results.json")) as f:
        result = json.load(f)
    with open(os.path.join(out, "sweep_journal.jsonl")) as f:
        losses = {t["trial_id"]: t["val_losses"] for ln in f
                  if "group" in (rec := json.loads(ln)) for t in rec["group"]}
    return result, losses


def sweep_cli(card: str, work: str) -> tuple[dict, dict]:
    """Phase 14c: cli.sweep end to end on the card; its best trial's
    artifact served (bf16, kernels on, K1/K3 counted); --method wandb
    refused offline. Returns (launches by path, the sweep's outcome)."""
    import gc

    from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
    from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()  # the sweep runs in another process on this card
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    write_triptychs(data, SWEEP_CLI_TRAIN + SWEEP_CLI_VAL, 512, seed=144)
    t_data = time.perf_counter() - t0
    out = os.path.join(work, "full")
    t0 = time.perf_counter()
    proc = _sweep_cli(["--data_dir", data, "--output_dir", out, *SWEEP_CLI_FLAGS],
                      os.path.join(work, "full.log"))
    rc = proc.wait(timeout=900)
    secs = time.perf_counter() - t0
    with open(os.path.join(work, "full.log")) as f:
        text = f.read()
    files = [f for f in ("sweep_results.json", "sweep_journal.jsonl", "best_trial_params.npz")
             if os.path.exists(os.path.join(out, f))]
    if rc != 0 or len(files) != 3:
        raise AssertionError(f"14c cli.sweep rc {rc}, files {files}: {text[-3000:]}")
    result, losses = _sweep_outcome(out)
    best = result["best"]
    print(f"14c cli.sweep {' '.join(SWEEP_CLI_FLAGS)} on {SWEEP_CLI_TRAIN} + {SWEEP_CLI_VAL} "
          f"triptychs at 512^2 ({t_data:.1f} s to write them): rc 0 in {secs:.1f} s, files "
          f"{files}; '{text.strip().splitlines()[-1]}'", flush=True)
    for t in result["trials"]:
        print(f"14c   trial {t['trial_id']}: batch {t['batch_size']}, lr {t['lr']:.6g}, wd "
              f"{t['wd']:.6g}, epochs {t['epochs_run']}, stop {t['stop_reason']} at "
              f"{t['stopped_at']}, best val L1 {t['best_val_loss']:.6f}", flush=True)
    if best is None or not math.isfinite(best["best_val_loss"]):
        raise AssertionError(f"14c best trial {best}")

    model, _ = load_model_for_eval(os.path.join(out, "best_trial_params.npz"),
                                   compute_dtype=torch.bfloat16, device="cuda")
    eng = InferenceEngine(model, image_size=512, max_batch_size=8, compute_dtype=torch.bfloat16,
                          device="cuda", warmup=True)
    try:
        frames = make_frames(8, 512, seed=145)
        _reset_launches()
        answer = eng.infer_batch(frames)
        counts = _launches()
    finally:
        eng.stop()
    _per_forward(counts, 1, "14c the sweep's best served")
    print(f"14c best_trial_params.npz (trial {best['trial_id']}) through load_model_for_eval, "
          f"InferenceEngine bf16 with the kernels: {answer.shape} {answer.dtype}, K1/K3 "
          f"{counts['gn_silu_flat']}/{counts['conv3x3_gn_silu']} for one forward", flush=True)
    if answer.shape != frames.shape or answer.dtype != np.uint8:
        raise AssertionError("14c the served answer")

    r = subprocess.run([sys.executable, "-m", "image_enhancement_deglaring_tpu_torch.cli.sweep",
                        "--data_dir", data, "--output_dir", os.path.join(work, "wandb"),
                        "--method", "wandb"], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    said = (r.stdout + r.stderr).strip().splitlines()[-1]
    print(f"14c cli.sweep --method wandb offline: rc {r.returncode}, '{said}'", flush=True)
    if r.returncode == 0 or "--method tpe" not in said:
        raise AssertionError("14c --method wandb did not refuse with its pointer at tpe")
    return {"14c sweep's best served": counts}, {"result": result, "losses": losses}


def sweep_resume(card: str, work: str, want: dict) -> None:
    """Phase 14d: the same cli.sweep, SIGTERM after its first journaled
    group: exit 0 with the resume hint; --resume then ends where 14c's
    uninterrupted sweep did."""
    import signal

    data, out = os.path.join(work, "data"), os.path.join(work, "cut")
    journal = os.path.join(out, "sweep_journal.jsonl")
    args = ["--data_dir", data, "--output_dir", out, *SWEEP_CLI_FLAGS]
    t0 = time.perf_counter()
    proc = _sweep_cli(args, os.path.join(work, "cut.log"))
    sent = None
    while proc.poll() is None and time.perf_counter() - t0 < 900:
        if os.path.exists(journal):
            with open(journal) as f:
                if any('"group"' in ln for ln in f):
                    proc.send_signal(signal.SIGTERM)
                    sent = time.perf_counter() - t0
                    break
        time.sleep(0.02)
    rc = proc.wait(timeout=900)
    with open(os.path.join(work, "cut.log")) as f:
        text = f.read()
    with open(journal) as f:
        groups = sum('"group"' in ln for ln in f)
    print(f"14d SIGTERM {sent if sent is None else round(sent, 1)} s after start (first group "
          f"journaled): rc {rc}, {groups} group(s) journaled, results file "
          f"{os.path.exists(os.path.join(out, 'sweep_results.json'))}; "
          f"'{text.strip().splitlines()[-1]}'", flush=True)
    if (sent is None or rc != 0 or "--resume" not in text
            or os.path.exists(os.path.join(out, "sweep_results.json"))):
        raise AssertionError(f"14d the preempted sweep: {text[-3000:]}")
    t0 = time.perf_counter()
    proc = _sweep_cli(args + ["--resume", out], os.path.join(work, "resume.log"))
    rc = proc.wait(timeout=900)
    with open(os.path.join(work, "resume.log")) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"14d --resume rc {rc}: {text[-3000:]}")
    result, losses = _sweep_outcome(out)
    fields = ("trial_id", "batch_size", "lr", "wd", "epochs_run", "stopped_at", "stop_reason")
    same = ([{k: t[k] for k in fields} for t in result["trials"]]
            == [{k: t[k] for k in fields} for t in want["result"]["trials"]]
            and result["best"]["trial_id"] == want["result"]["best"]["trial_id"])
    diff = max(abs(a - b) for i, v in want["losses"].items() for a, b in zip(v, losses[i]))
    print(f"14d --resume: rc 0 in {time.perf_counter() - t0:.1f} s; trials, stop epochs, stop "
          f"reasons and best id equal to 14c's {same}; val losses largest |diff| {diff} "
          f"(bit for bit {diff == 0}) on {card}", flush=True)
    if not same or diff != 0:
        raise AssertionError("14d the resumed sweep differs from the uninterrupted one")


def sweeps(card: str) -> dict:
    """Phase 14: 14a group parity, 14b rates and memory, 14c cli.sweep and
    its artifact served, 14d preemption and resume. Returns launches by
    path; the training paths launch no forward-only kernel (the groups run
    the composition under vmap, the single steps the training pair)."""
    import shutil
    import tempfile

    _reset_launches()
    for label, fn in (("14a", sweep_group_parity), ("14b", sweep_rates)):
        t = time.perf_counter()
        fn(card)
        print(f"phase {label}: {time.perf_counter() - t:.1f} s", flush=True)
    counts = _launches()
    from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

    print(f"14a-b kernel launches over the sweep's training paths: {counts}; the groups' "
          f"GroupNorm+SiLU calls on the composition {fk.TRAIN_FALLBACKS}", flush=True)
    if any(forward_only(counts).values()) or not fk.TRAIN_FALLBACKS["transform"]:
        raise AssertionError(f"the sweep's training paths launched {counts}, fallbacks "
                             f"{fk.TRAIN_FALLBACKS}")
    work = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        t = time.perf_counter()
        paths, outcome = sweep_cli(card, work)
        paths["14a-b sweep groups and single steps"] = counts
        print(f"phase 14c: {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        sweep_resume(card, work, outcome)
        print(f"phase 14d: {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths


# phase 15: heavy augmentation, the profiler, --visualize, the promotion
# gate, the training scripts and the native decode, at 512x512 on the
# production LightweightUNet. Training launches the training pair alone;
# the paths that serve or evaluate launch K1/K3 as the rest of serving does.
HEAVY_TRIPTYCHS, HEAVY_VAL_SPLIT, HEAVY_BATCH, PROFILE_STEPS = 48, 0.1, 8, 5
TOOLS_SIZE = 512


def heavy_host_times(root: str) -> None:
    """15a's host side: ``heavy_augment`` ms per pair and each of its
    numpy cv2 copies (one thread, the card's host has no cv2), then the
    train loader's img/s under heavy and optimized augmentation (batch 8,
    4 threads), decoding every pass and from ``cache_images``."""
    from image_enhancement_deglaring_tpu_torch.data import cv_ops, make_dataloaders
    from image_enhancement_deglaring_tpu_torch.data.augment import heavy_augment
    from image_enhancement_deglaring_tpu_torch.data.pipeline import decode_triptych

    paths = sorted(os.path.join(root, f) for f in os.listdir(root))[:8]
    pairs = [decode_triptych(p, TOOLS_SIZE) for p in paths]
    t0 = time.perf_counter()
    n = 32
    for i in range(n):
        heavy_augment(*pairs[i % len(pairs)], np.random.default_rng(i))
    per_pair = (time.perf_counter() - t0) * 1e3 / n
    img = pairs[0][0]
    m = cv_ops.rotation_matrix((TOOLS_SIZE / 2, TOOLS_SIZE / 2), 9.5, 1.04)
    u8 = (img * 255).astype(np.uint8)
    ops = {"warp bilinear": lambda: cv_ops.warp_affine(img, m, cv_ops.INTER_LINEAR),
           "warp nearest": lambda: cv_ops.warp_affine(img, m, cv_ops.INTER_NEAREST),
           "blur 3x3": lambda: cv_ops.gaussian_blur_3x3(img),
           "CLAHE": lambda: cv_ops.clahe_u8(u8, 2.5)}
    each = {}
    for name, fn in ops.items():
        t0 = time.perf_counter()
        for _ in range(8):
            fn()
        each[name] = (time.perf_counter() - t0) * 1e3 / 8
    print(f"15a heavy_augment on the host: {per_pair:.3f} ms per {TOOLS_SIZE}x{TOOLS_SIZE} "
          f"pair (mean of {n} seeds, one thread); "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in each.items()), flush=True)
    rates = {}
    for augment in ("heavy", "optimized"):
        for cache in (False, True):
            loader, _ = make_dataloaders(root, batch_size=HEAVY_BATCH, val_split=HEAVY_VAL_SPLIT,
                                         image_size=TOOLS_SIZE, num_workers=4,
                                         cache_images=cache,
                                         augment=augment)
            t0, count = time.perf_counter(), 0
            for _ in range(2):
                for xb, _yb in loader:
                    count += xb.shape[0]
            rates[augment, cache] = count / (time.perf_counter() - t0)
    print(f"15a train loader alone ({TOOLS_SIZE}x{TOOLS_SIZE}, batch 8, 4 threads, 2 passes): "
          + "; ".join(f"{a} {rates[a, False]:.1f} img/s decoding every pass, "
                      f"{rates[a, True]:.1f} from cache_images" for a in ("heavy", "optimized")),
          flush=True)


def heavy_and_profiled_training(work: str) -> None:
    """15a/15b: ``cli.train --augment heavy --profile_dir D --profile_steps
    5`` as one run (one process start, one epoch of 5 steps at batch 8):
    the production model, bf16, 512x512; it ends normally with its
    artifacts; the trace parses and holds CUDA kernel events of the traced
    steps."""
    import contextlib
    import io

    from image_enhancement_deglaring_tpu_torch.cli import train as cli_train

    root = os.path.join(work, "heavy")
    t0 = time.perf_counter()
    write_triptychs(root, HEAVY_TRIPTYCHS, TOOLS_SIZE, seed=15)
    t_data = time.perf_counter() - t0
    heavy_host_times(root)
    prof, out = os.path.join(work, "train_trace"), os.path.join(work, "heavy_run")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        cli_train.main(["--data_dir", root, "--output_dir", out, "--epochs", "1",
                        "--batch_size", str(HEAVY_BATCH), "--val_split", str(HEAVY_VAL_SPLIT),
                        "--augment", "heavy", "--validation_metrics_every", "1",
                        "--image_size", str(TOOLS_SIZE),
                        "--profile_dir", prof, "--profile_steps", str(PROFILE_STEPS)])
    t_run = time.perf_counter() - t0
    text = log.getvalue()
    missing = [f for f in ("final_model", "model_weights.npz", "logs/metrics.jsonl")
               if not os.path.exists(os.path.join(out, f))]
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"15b --profile_dir wrote {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    epoch = [ln for ln in text.splitlines() if ln.startswith("Epoch ")]
    print(f"15a cli.train --augment heavy on cuda ({HEAVY_TRIPTYCHS} triptychs at {TOOLS_SIZE} written "
          f"in {t_data:.1f} s, 1 epoch of batch {HEAVY_BATCH}, bf16, traced): {t_run:.1f} s; "
          f"{epoch[-1] if epoch else 'no epoch line'}; missing artifacts {missing}", flush=True)
    print(f"15b --profile_dir --profile_steps {PROFILE_STEPS}: one trace "
          f"({os.path.getsize(os.path.join(prof, traces[0])) / 2**20:.1f} MiB), "
          f"{len(events)} events, {len(kernels)} CUDA kernel events over "
          f"{len({e['name'] for e in kernels})} kernel names", flush=True)
    if missing or "Training completed" not in text or not kernels or not epoch:
        raise AssertionError(f"15a/15b cli.train --augment heavy --profile_dir failed: "
                             f"{text[-2000:]}")


def profiled_serving(card: str, work: str) -> dict:
    """15b: ``cli.serve --profile_port`` (bf16, the kernels on, max batch 8)
    in this process, so the wrappers' launch counters see its engine: while
    8 connections post 512x512 pages, one ``GET /trace?ms=1500`` capture;
    its trace holds K1's and K3's device kernels. Returns the launches."""
    import image_enhancement_deglaring_tpu_torch.serve as serve_pkg
    from image_enhancement_deglaring_tpu_torch.cli import serve as cli_serve
    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.tools.load_test_api import multipart_body

    port, trace_port = _free_port(), _free_port()
    servers = []
    real = serve_pkg.create_server

    def capture(*a, **k):
        import logging

        servers.append(real(*a, **k))
        for h in servers[-1].logger.handlers:  # no console line per request, as _start
            if type(h) is logging.StreamHandler:
                h.setLevel(logging.CRITICAL)
        return servers[-1]

    # the captures' default directory (under tempfile.gettempdir()) inside
    # work; the process environment stays as it is, since other threads run
    traces = os.path.join(work, "serve_traces")
    os.makedirs(traces, exist_ok=True)
    with mock.patch.object(serve_pkg, "create_server", capture), \
            mock.patch("tempfile.tempdir", traces):
        thread = threading.Thread(target=cli_serve.main, args=([
            "--model_path", ONNX, "--host", "127.0.0.1", "--port", str(port),
            "--profile_port", str(trace_port), "--log_dir", os.path.join(work, "serve_logs"),
            "--image_size", str(TOOLS_SIZE)],),
            daemon=True)
        thread.start()
        deadline = time.time() + 180
        while not servers or _ping(port) is not True:
            if time.time() > deadline or not thread.is_alive():
                raise AssertionError("15b cli.serve --profile_port never answered /ping")
            time.sleep(0.1)
        server = servers[0]
        bodies = [("/infer", *multipart_body(encode_png(im))) for im in make_frames(16, TOOLS_SIZE, 15)]
        done = threading.Event()
        sent, bad = [0], []

        def traffic():
            while not done.is_set():
                answers, _, _ = _post_all(port, bodies, 8)
                bad.extend(a[0] for a in answers if a[0] != 200)
                sent[0] += len(answers)

        poster = threading.Thread(target=traffic, daemon=True)
        _reset_launches()  # after the server's warmup
        batches0 = server.engine.stats()["batches_dispatched"]
        poster.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        status, answer = _get_json(trace_port, "/trace?ms=1500")
        t_capture = time.perf_counter() - t0
        done.set()
        poster.join(timeout=120)
        counts = _launches()
        batches = server.engine.stats()["batches_dispatched"] - batches0
        loop = server._server.get_loop()
        loop.call_soon_threadsafe(server._server.close)
        thread.join(timeout=60)
    if status != 200 or thread.is_alive() or bad or poster.is_alive():
        raise AssertionError(f"15b /trace answered {status} {answer}; server thread alive "
                             f"{thread.is_alive()}; /infer statuses other than 200: {bad}")
    with open(answer["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = sum(1 for e in kern if "gn_silu_kernel" in e["name"])
    k3 = sum(1 for e in kern if "conv3x3_tc_kernel" in e["name"])
    engine_tids = {e["tid"] for e in events if e.get("name") == "aten::conv2d"}
    print(f"15b cli.serve --profile_port on {card}: /trace?ms=1500 answered in {t_capture:.2f} s "
          f"while {sent[0]} requests were served ({batches} batches): {len(events)} events, "
          f"{len(kern)} kernel events, {k1} of K1 (gn_silu_kernel), {k3} of K3's conv "
          f"(conv3x3_tc_kernel), host conv2d ops on {len(engine_tids)} thread(s); launches "
          f"over the run {counts}", flush=True)
    if not (k1 and k3 and counts.get("gn_silu_flat") and counts.get("conv3x3_gn_silu")):
        raise AssertionError("15b the serving trace holds no K1/K3 kernel events")
    if counts["gn_silu_flat"] != 14 * batches or counts["conv3x3_gn_silu"] != 4 * batches:
        raise AssertionError(f"15b launches {counts} against {batches} batches (14/4 each)")
    return counts


def _ping(port: int) -> bool:
    try:
        return _get_json(port, "/ping") == (200, {"message": "pong"})
    except OSError:
        return False


def enhance_visualize(card: str, work: str) -> dict:
    """15c: ``cli.enhance --visualize`` on 2 pages (a 512x512 gray PNG and a
    1024x768 RGB PNG) on the card: outputs and figures named as the JAX CLI
    names them, each figure the input's luma beside the output. Returns
    the launches."""
    import contextlib
    import io

    from image_enhancement_deglaring_tpu_torch.cli import enhance as cli_enhance
    from image_enhancement_deglaring_tpu_torch.data.png import decode_png, png_text, write_png

    inp, out = os.path.join(work, "pages"), os.path.join(work, "enhanced")
    os.makedirs(inp)
    write_png(os.path.join(inp, "page_a.png"), make_frames(1, TOOLS_SIZE, 16)[0])
    write_png(os.path.join(inp, "page_b.png"), rgb_pages(1, 768, 1024, 17)[0])
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_enhance.main(["--input", inp, "--output_dir", out, "--model_path", ONNX,
                          "--image_size", str(TOOLS_SIZE), "--visualize"])
    secs = time.perf_counter() - t0
    counts = _launches()
    names = sorted(os.listdir(out))
    want = ["page_a.png", "page_a_comparison.png", "page_b.png", "page_b_comparison.png"]
    shapes = []
    for stem, w_in in (("page_a", TOOLS_SIZE), ("page_b", 1024)):
        with open(os.path.join(out, stem + "_comparison.png"), "rb") as f:
            data = f.read()
        fig = decode_png(data)
        shapes.append(fig.shape)
        if fig.shape[1] != w_in + 16 + TOOLS_SIZE or set(png_text(data)) != {"Input", "Output"}:
            raise AssertionError(f"15c figure {stem}: {fig.shape}, {png_text(data)}")
    print(f"15c cli.enhance --visualize on {card}: 2 pages in {secs:.1f} s, files {names}, "
          f"figures {shapes}; launches {counts}", flush=True)
    if names != want or counts.get("gn_silu_flat") != 28 or counts.get("conv3x3_gn_silu") != 8:
        raise AssertionError(f"15c files {names} (want {want}), launches {counts}")
    return counts


def crossval_gate(card: str) -> dict:
    """15d: ``tools.crossval_artifact`` with best_model.onnx against itself
    (n = 16, 512x512, f32 on the card): keep_incumbent, equal metrics.
    Returns the launches."""
    import contextlib
    import io

    from image_enhancement_deglaring_tpu_torch.tools import crossval_artifact

    _reset_launches()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        crossval_artifact.main(["--candidate", ONNX, "--n", "16", "--size", str(TOOLS_SIZE)])
    secs = time.perf_counter() - t0
    counts = _launches()
    res = json.loads(log.getvalue().strip().splitlines()[-1])
    print(f"15d tools.crossval_artifact best_model.onnx vs itself on {card} (n 16, {TOOLS_SIZE}x{TOOLS_SIZE}): "
          f"{secs:.1f} s, {json.dumps(res)}; launches {counts}", flush=True)
    if res["verdict"] != "keep_incumbent" or res["candidate"] != res["incumbent"]:
        raise AssertionError(f"15d the artifact against itself: {res}")
    return counts


def training_tools(card: str, work: str) -> None:
    """15e: ``tools.train_roofline`` at batches 8/16/32; 15f:
    ``tools.train_synthetic_demo`` cut to 32 + 8 triptychs x 3 epochs (from
    96 + 24 x 100)."""
    import contextlib
    import io

    from image_enhancement_deglaring_tpu_torch.tools import train_roofline, train_synthetic_demo

    t0 = time.perf_counter()
    train_roofline.main(["--batches", "8,16,32", "--size", str(TOOLS_SIZE)])
    print(f"15e tools.train_roofline: {time.perf_counter() - t0:.1f} s", flush=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        train_synthetic_demo.main(["--data_dir", os.path.join(work, "demo"), "--out_dir",
                                   os.path.join(work, "demo", "models"), "--n_train", "32",
                                   "--n_val", "8", "--epochs", "3", "--size",
                                   str(TOOLS_SIZE)])
    lines = [ln for ln in log.getvalue().splitlines()
             if ln.startswith(("identity baseline", "trained in", "final ("))]
    print(f"15f tools.train_synthetic_demo (32 + 8 triptychs x 3 epochs, cut from 96 + 24 x 100) "
          f"on {card}: {time.perf_counter() - t0:.1f} s; " + "; ".join(lines), flush=True)
    if len(lines) != 3:
        raise AssertionError(f"15f demo output: {log.getvalue()[-2000:]}")


def native_decode(work: str) -> None:
    """15g: the native route (g++ on the card's host) against the numpy
    route: equal at 512x512 triptychs decoded at 512, within one uint8 step
    at a resize (768 -> 512); ms per triptych of the per-pixel work and of
    the whole decode."""
    from image_enhancement_deglaring_tpu_torch import native
    from image_enhancement_deglaring_tpu_torch.data.pipeline import (
        _resize_uint8,
        _to_gray_uint8,
        decode_triptych,
        read_image,
    )

    t0 = time.perf_counter()
    native.get_lib()
    t_build = time.perf_counter() - t0
    root = os.path.join(work, "heavy")
    paths = sorted(os.path.join(root, f) for f in os.listdir(root))[:16]

    def numpy_route(img, size):
        third = img.shape[1] // 3
        return tuple(_resize_uint8(_to_gray_uint8(img[:, a:a + third]), size).astype(
            np.float32) / 255.0 for a in (third, 0))

    times, steps = {}, {}
    big = TOOLS_SIZE * 3 // 2
    for label, imgs in (("identity", [read_image(p) for p in paths]),
                        (f"{big} -> {TOOLS_SIZE}", [np.random.default_rng(i).integers(
                            0, 256, (big, 3 * big, 4), dtype=np.uint8) for i in range(4)])):
        outs = {}
        for route, fn in (("native", native.triptych_preprocess), ("numpy", numpy_route)):
            t0 = time.perf_counter()
            outs[route] = [fn(img, TOOLS_SIZE) for img in imgs]
            times[label, route] = (time.perf_counter() - t0) * 1e3 / len(imgs)
        steps[label] = 255 * max(float(np.abs(x - y).max()) for a, b in zip(
            outs["native"], outs["numpy"]) for x, y in zip(a, b))
    whole = {}
    for route, flag in (("native", True), ("numpy", None)):
        t0 = time.perf_counter()
        for p in paths:
            decode_triptych(p, TOOLS_SIZE, use_native=flag)
        whole[route] = (time.perf_counter() - t0) * 1e3 / len(paths)
    print(f"15g native decode: g++ build {t_build:.1f} s; largest difference from numpy in "
          f"uint8 steps " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
          + "; per-pixel ms per triptych "
          + ", ".join(f"{k[0]} {k[1]} {v:.3f}" for k, v in times.items())
          + f"; whole decode_triptych (PNG decode included) native {whole['native']:.3f}, "
          f"numpy {whole['numpy']:.3f} ms per {TOOLS_SIZE}x{TOOLS_SIZE} triptych", flush=True)
    if steps["identity"] != 0 or max(steps.values()) > 1.0 + 1e-3:
        raise AssertionError(f"15g native vs numpy in uint8 steps: {steps}")


def slice_tools(card: str) -> dict:
    """Phase 15: 15a/15b heavy-augmented, profiled cli.train; 15b cli.serve
    --profile_port; 15c cli.enhance --visualize; 15d the promotion gate;
    15e/15f the training tools; 15g the native decode. Returns launches by
    path."""
    import shutil
    import tempfile

    paths = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        for label, fn, args, path in (
                ("15a-b train", heavy_and_profiled_training, (work,), None),
                ("15b serve", profiled_serving, (card, work), "15b served under --profile_port"),
                ("15c", enhance_visualize, (card, work), "15c cli.enhance --visualize"),
                ("15d", crossval_gate, (card,), "15d crossval_artifact"),
                ("15e-f", training_tools, (card, work), None),
                ("15g", native_decode, (work,), None)):
            t = time.perf_counter()
            counts = fn(*args)
            if path is not None:
                paths[path] = counts
            print(f"phase {label}: {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths


# ----------------------------------------------------------------------
# phase 16: data parallelism on the card (parallel.distributed, one process
# per device). The machine has one H100: NCCL runs a group of one, and two
# ranks share the card under Gloo, since NCCL refuses two ranks on one GPU.

DP_SIZE, DP_BATCH, DP_TRAIN_N, DP_VAL_N = 512, 8, 96, 24     # 16a/16d
DP_F32_SIZE, DP_F32_N, DP_F32_BATCH = 128, 16, 8             # 16b
DP_EVAL_N, DP_EVAL_BATCH = 16, 8                             # 16c, at 512^2
DP_RTOL = 1e-5                          # tests/test_torch_port_distributed.py
DP_PSNR_GATE_DB = EVAL_F32_GATE["psnr"]  # phase 9's gate


class _DPLoader:
    """Fixed NHWC arrays in batches, dropping a ragged tail."""

    def __init__(self, x, y, batch_size):
        self.x, self.y, self.batch_size = x, y, batch_size

    def __len__(self):
        return len(self.x) // self.batch_size

    @property
    def num_samples(self):
        return len(self.x)

    def __iter__(self):
        for i in range(len(self)):
            s = slice(i * self.batch_size, (i + 1) * self.batch_size)
            yield self.x[s], self.y[s]


def _dp_summary(tree) -> dict:
    from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

    leaves = {k: float(np.abs(np.asarray(v, np.float64)).sum())
              for k, v in flatten_tree(tree).items()}
    return {"abs_sum": sum(leaves.values()), "leaves": leaves}


def _dp_f32_train(work: str, mesh=None) -> dict:
    """16b's run: the production LightweightUNet from seeded init, f32,
    under deterministic algorithms, 2 epochs over seeded triptychs; with
    ``mesh`` each rank takes its half of every batch."""
    from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
    from image_enhancement_deglaring_tpu_torch.parallel import distributed
    from image_enhancement_deglaring_tpu_torch.train import train_model

    x, y = triptych_batch(DP_F32_N, DP_F32_SIZE, seed=41)
    loaders = [_DPLoader(x[:DP_F32_N // 2], y[:DP_F32_N // 2], DP_F32_BATCH),
               _DPLoader(x[DP_F32_N // 2:], y[DP_F32_N // 2:], DP_F32_BATCH)]
    if mesh is not None:
        loaders = [distributed.LocalSliceLoader(ld) for ld in loaders]
    model = LightweightUNet(dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    torch.use_deterministic_algorithms(True)
    try:
        best, _, val, state = train_model(
            model, *loaders, epochs=2, lr=1e-3, save_every=100, progress=False,
            validation_metrics_every=1, handle_preemption=False, output_dir=work, mesh=mesh,
            device="cuda")
    finally:
        torch.use_deterministic_algorithms(False)
    return {"best_val": float(val), "step": state.step, **_dp_summary(best)}


def _dp_evaluate(data: str, mesh=None) -> tuple[dict, dict]:
    """16c's run: ``evaluate`` on the production weights, bf16 with the
    kernels, over the synthetic val set; its metrics and its launches,
    counted from 0 just before it."""
    from image_enhancement_deglaring_tpu_torch.data import make_eval_loader
    from image_enhancement_deglaring_tpu_torch.eval import evaluate, load_model_for_eval

    model, _ = load_model_for_eval(ONNX, compute_dtype=torch.bfloat16,
                                   device=mesh.device if mesh is not None else "cuda")
    loader = make_eval_loader(data, batch_size=DP_EVAL_BATCH, image_size=DP_SIZE,
                              num_workers=EVAL_WORKERS)
    _reset_launches()
    metrics = evaluate(model, loader, batch_size=DP_EVAL_BATCH, progress=False, mesh=mesh)
    return metrics, _launches()


def _dp_rank(work: str, eval_data: str) -> None:
    """One rank of 16b/16c (``parallel.distributed.launch_local`` over Gloo
    on the one card): its training summary, evaluation and launches as JSON."""
    from image_enhancement_deglaring_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(device="cuda")  # Gloo ranks on the card
    out = {"device": str(mesh.device), "backend": mesh.backend,
           "train": _dp_f32_train(os.path.join(work, "ranks"), mesh)}
    out["evaluate"], out["launches"] = _dp_evaluate(eval_data, mesh)
    with open(os.path.join(work, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)


def _dp_cli(argv: list) -> tuple[str, str]:
    """``cli.train.main(argv)`` in this process, its stdout and stderr
    echoed and returned."""
    import contextlib
    import io

    from image_enhancement_deglaring_tpu_torch.cli import train as cli_train

    class Tee(io.StringIO):
        def __init__(self, echo):
            super().__init__()
            self.echo = echo

        def write(self, text):
            self.echo.write(text)
            return super().write(text)

    out, err = Tee(sys.__stdout__), Tee(sys.__stderr__)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli_train.main(argv)
    return out.getvalue(), err.getvalue()


def _dp_ms_per_step(run_dir: str) -> float:
    """The last epoch's ms per step from its train_images_per_sec."""
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if "train_images_per_sec" in line]
    return 1000.0 * DP_BATCH / recs[-1]["train_images_per_sec"]


def _dp_allreduce_ms(card: str) -> None:
    """What the gradient all-reduce costs a step, NCCL in a group of one on
    this card: the production model's bf16 step at 16a's shape with and
    without it, in turns on the same state (CUDA events, median of 20
    rounds after 5 warm ones), and ``average_gradients`` alone."""
    from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
    from image_enhancement_deglaring_tpu_torch.parallel import distributed
    from image_enhancement_deglaring_tpu_torch.parallel.mesh import make_mesh
    from image_enhancement_deglaring_tpu_torch.train import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from image_enhancement_deglaring_tpu_torch.train.loop import average_gradients

    def timed(fn) -> float:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0)
    try:
        model = LightweightUNet(dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0)).to("cuda")
        state = TrainState(model=model, optimizer=make_optimizer(model, TRAIN_LR, TRAIN_WD))
        x, y = (torch.from_numpy(a).cuda() for a in triptych_batch(DP_BATCH, DP_SIZE, seed=33))
        mesh = make_mesh()
        steps = {"without": make_train_step(), "with": make_train_step(mesh=mesh)}
        times = {name: [] for name in steps}
        for r in range(25):
            for name, step in steps.items():
                ms = timed(lambda: step(state, x, y))
                if r >= 5:
                    times[name].append(ms)
        params = list(model.parameters())
        alone = [timed(lambda: average_gradients(params, mesh)) for _ in range(60)][10:]
        n = sum(p.numel() for p in params)
        med = {name: float(np.median(v)) for name, v in times.items()}
        print(f"16a bf16 step at {DP_SIZE}^2 batch {DP_BATCH} on {card}, in turns over 20 rounds:"
              f" median {med['without']:.4f} ms without the all-reduce, {med['with']:.4f} ms "
              f"with it (NCCL, group of one), cost {med['with'] - med['without']:.4f} ms; "
              f"average_gradients alone on {n} floats ({4 * n / 2**20:.2f} MiB): median "
              f"{np.median(alone):.4f} ms, min {min(alone):.4f} ms over 50 calls", flush=True)
    finally:
        distributed.shutdown()


def data_parallel(card: str) -> dict:
    """Phase 16: (a) ``cli.train --distributed`` as a group of one on NCCL
    against the same run without it, bit for bit, ms per step of both and
    what the all-reduce costs a step, paired; (b) two ranks on the card under Gloo training f32
    under deterministic algorithms: the ranks equal bit for bit and equal
    to one process at the same global batch; (c) ``evaluate`` over the two
    ranks against one, |dPSNR| <= 0.01 dB, their K1/K3 launches counted;
    (d) ``cli.train --n_devices 2`` clamped to the one card. Returns the
    launches of (c)."""
    import shutil
    import tempfile

    from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1
    from image_enhancement_deglaring_tpu_torch.parallel import distributed
    from image_enhancement_deglaring_tpu_torch.utils import load_npz_tree

    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t = time.perf_counter()
        data = os.path.join(work, "data")
        generate_synthetic_sd1(data, n_train=DP_TRAIN_N, n_val=DP_VAL_N, size=DP_SIZE, seed=31)
        generate_synthetic_sd1(os.path.join(work, "eval"), n_train=0, n_val=DP_EVAL_N,
                               size=DP_SIZE, seed=32)
        eval_data = os.path.join(work, "eval", "val")
        print(f"16 synthetic sets written ({DP_TRAIN_N + DP_VAL_N} + {DP_EVAL_N} triptychs at "
              f"{DP_SIZE}^2) in {time.perf_counter() - t:.1f} s", flush=True)

        # 16a: a group of one on NCCL against no group, under deterministic
        # algorithms so that the two runs can agree bit for bit
        common = ["--data_dir", data, "--epochs", "2", "--batch_size", str(DP_BATCH),
                  "--resident_data", "--validation_metrics_every", "1", "--num_workers", "4"]
        runs = {}
        torch.use_deterministic_algorithms(True)
        try:
            for name, extra in (("plain", []), ("distributed", [
                    "--distributed", "--num_processes", "1", "--process_id", "0",
                    "--coordinator_address", f"127.0.0.1:{distributed.free_port()}"])):
                out_dir = os.path.join(work, name)
                text, err = _dp_cli(common + ["--output_dir", out_dir] + extra)
                runs[name] = (out_dir, text, err)
        finally:
            torch.use_deterministic_algorithms(False)
        plain = load_npz_tree(os.path.join(runs["plain"][0], "model_weights.npz"))
        dist_ = load_npz_tree(os.path.join(runs["distributed"][0], "model_weights.npz"))
        from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

        fp, fd = flatten_tree(plain), flatten_tree(dist_)
        differ = [k for k in fp if not np.array_equal(fp[k], fd[k])]
        ms = {name: _dp_ms_per_step(d) for name, (d, _, _) in runs.items()}
        print(f"16a cli.train bf16 {DP_SIZE}^2 batch {DP_BATCH} resident, 2 epochs of "
              f"{DP_TRAIN_N // DP_BATCH} steps on {card}: last epoch {ms['plain']:.3f} ms/step "
              f"without a group, {ms['distributed']:.3f} ms/step with --distributed (NCCL, one "
              f"process); final weights: {len(fp) - len(differ)} of {len(fp)} leaves equal bit "
              f"for bit", flush=True)
        if differ or fp.keys() != fd.keys():
            raise AssertionError(f"16a: --distributed changed the weights: {differ[:5]}")
        if ("Distributed runtime: 1 process(es)" not in runs["distributed"][1]
                or "resolved to a SINGLE process" not in runs["distributed"][2]):
            raise AssertionError("16a: the group of one was not announced as the JAX CLI does")
        _dp_allreduce_ms(card)

        # 16b/16c: two ranks on the one card under Gloo, CUDA tensors
        t = time.perf_counter()
        distributed.launch_local(_dp_rank, 2, work, eval_data, device="cuda", backend="gloo")
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in (0, 1)]
        t_ranks = time.perf_counter() - t
        one = _dp_f32_train(os.path.join(work, "one"))
        one_eval, _ = _dp_evaluate(eval_data)
        r0, r1 = ranks
        rel = {k: abs(r0["train"][k] - one[k]) / abs(one[k]) for k in ("best_val", "abs_sum")}
        print(f"16b two ranks on {r0['device']} and {r1['device']} ({r0['backend']}), f32 "
              f"{DP_F32_SIZE}^2, global batch {DP_F32_BATCH}, 2 epochs ({t_ranks:.1f} s with "
              f"16c, two processes): ranks equal bit for bit "
              f"{r0['train'] == r1['train']}; against one process best val "
              f"{r0['train']['best_val']:.8f} vs {one['best_val']:.8f} (rel {rel['best_val']:.2e}),"
              f" |params| sum rel {rel['abs_sum']:.2e} (gate {DP_RTOL})", flush=True)
        if r0["train"] != r1["train"] or r0["train"]["step"] != one["step"]:
            raise AssertionError("16b: the ranks disagree or stepped otherwise than one process")
        if max(rel.values()) > DP_RTOL:
            raise AssertionError(f"16b: two ranks vs one process beyond {DP_RTOL}: {rel}")
        d_psnr = abs(r0["evaluate"]["psnr"] - one_eval["psnr"])
        launches = {k: r0["launches"].get(k, 0) + r1["launches"].get(k, 0)
                    for k in set(r0["launches"]) | set(r1["launches"])}
        forwards = 2 * -(-DP_EVAL_N // DP_EVAL_BATCH)  # each rank runs every batch's half
        print(f"16c evaluate bf16 with the kernels over two ranks: {fmt_metrics(r0['evaluate'])};"
              f" one rank {fmt_metrics(one_eval)}; |dPSNR| {d_psnr:.5f} dB (gate "
              f"{DP_PSNR_GATE_DB}); launches {launches} over {forwards} forwards", flush=True)
        if r0["evaluate"] != r1["evaluate"] or d_psnr > DP_PSNR_GATE_DB:
            raise AssertionError("16c: two-rank evaluation beyond its gate or ranks disagree")
        if r0["evaluate"]["num_samples"] != DP_EVAL_N:
            raise AssertionError(f"16c: {r0['evaluate']['num_samples']} samples")
        _per_forward(launches, forwards, "16c")

        # 16d: more devices asked for than the card count
        text, _ = _dp_cli(["--data_dir", data, "--output_dir", os.path.join(work, "clamp"),
                           "--epochs", "1", "--batch_size", str(DP_BATCH), "--resident_data",
                           "--n_devices", "2"])
        clamp = "requested --n_devices 2, but only 1 available; using 1"
        trained = os.path.exists(os.path.join(work, "clamp", "model_weights.npz"))
        print(f"16d cli.train --n_devices 2 on one card: clamp message printed "
              f"{clamp in text}, trained on one {trained}", flush=True)
        if clamp not in text or not trained:
            raise AssertionError("16d: --n_devices 2 was not clamped to the one card")
        return {"16c evaluate over two ranks": launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 17: serving and sweeps over several devices. Serving runs in one
# process over a LocalMesh (one model replica per device, each batch split
# over them); sweeps run one process per device (the trial axis split over
# the ranks of a DataMesh). The machine has one H100: the serving mesh
# puts two replicas on cuda:0 (the cost of the split, not scaling), and
# the sweep's two ranks share the card under Gloo (NCCL refuses two ranks
# on one GPU), as 16b/16c do.

MESH_SIZE, MESH_MAX_BATCH, MESH_RATE_BUCKET = 512, 64, 64                  # 17a
MESH_RATE_ROUNDS, MESH_RATE_CALLS, MESH_SUBMIT_FRAMES = 6, 4, 256
MESH_HTTP_PAGES, MESH_TILE_SIZE = 32, (900, 1200)                          # 17b
MESH_SWEEP_SIZE, MESH_SWEEP_TRAIN, MESH_SWEEP_VAL = 128, 32, 16            # 17d
MESH_SWEEP = dict(n_trials=4, max_epochs=2, min_iter=1, eta=2, method="random", seed=17)
MESH_RESUME = dict(n_trials=2, max_epochs=1, min_iter=1, eta=2, method="random", seed=7,
                   max_parallel_trials=1)
MESH_SWEEP_RTOL = 1e-5             # tests/test_distributed.py's two-host sweep
MESH_CLI_FLAGS = ["--method", "random", "--sweep_count", "4", "--max_epochs", "2",
                  "--early_stop_min_iter", "1", "--eta", "2", "--image_size", "128",
                  "--num_workers", "4"]                                      # 17e


def _mesh_devices() -> tuple:
    """Every card, or two replicas on cuda:0 on a machine with one."""
    n = torch.cuda.device_count()
    return tuple(torch.device("cuda", i) for i in range(n)) if n > 1 else (
        torch.device("cuda", 0),) * 2


class _Tee:
    """Stdout echoed to the console and kept (``text``)."""

    def __init__(self):
        import io

        self.buf = io.StringIO()

    def write(self, text):
        sys.__stdout__.write(text)
        return self.buf.write(text)

    def flush(self):
        sys.__stdout__.flush()

    @property
    def text(self) -> str:
        return self.buf.getvalue()


def _record_buckets(engine) -> list:
    """The row counts of every batch ``engine`` launches from now on."""
    seen, step = [], engine._step
    engine._step = lambda batch: (seen.append(batch.shape[0]), step(batch))[1]
    return seen


def mesh_engine(card: str, mesh) -> tuple[dict, object]:
    """17a: ``InferenceEngine(mesh=)`` against one engine on the production
    weights, bf16 with the kernels: answers, buckets, launches, img/s in
    turns. Returns (launches, the single engine)."""
    from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
    from image_enhancement_deglaring_tpu_torch.parallel import LocalMesh
    from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine

    model, _ = load_model_for_eval(ONNX, compute_dtype=torch.bfloat16, device="cuda")
    kw = dict(image_size=MESH_SIZE, max_batch_size=MESH_MAX_BATCH, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    engines = {"no mesh": InferenceEngine(model, device="cuda", **kw),
               "1-replica mesh": InferenceEngine(model, mesh=LocalMesh(mesh.devices[:1]), **kw),
               f"{mesh.size}-replica mesh": InferenceEngine(model, mesh=mesh, **kw)}
    t_warm = time.perf_counter() - t0
    solo, eng = engines["no mesh"], engines[f"{mesh.size}-replica mesh"]
    print(f"17a three engines (bf16, {MESH_SIZE}^2, max batch {MESH_MAX_BATCH}) built and warmed "
          f"in {t_warm:.1f} s; mesh {[str(d) for d in mesh.devices]}", flush=True)

    frames = make_frames(8, MESH_SIZE, seed=171)
    buckets = _record_buckets(eng)
    results = []
    for batch in (frames, frames[:3]):
        _reset_launches()
        got = eng.infer_batch(batch)
        counts = _launches()
        want = solo.infer_batch(batch)
        bucket = buckets[-1]
        _per_forward(counts, mesh.size, f"17a batch {len(batch)} (bucket {bucket})")
        # each replica's slice is one engine's forward at bucket / n rows:
        # the same weights and kernels on the same shapes, so bit for bit
        rows = bucket // mesh.size
        padded = np.concatenate([batch, np.zeros((bucket - len(batch),) + batch.shape[1:],
                                                 np.uint8)])
        sliced = np.concatenate([solo.infer_batch(padded[i * rows:(i + 1) * rows])
                                 for i in range(mesh.size)])[:len(batch)]
        exact = bool(np.array_equal(got, sliced))
        levels = int(np.abs(got.astype(np.int16) - want).max())
        worst = min(psnr_u8(g, w) for g, w in zip(got, want))
        results.append((len(batch), bucket, levels, worst, counts))
        print(f"17a infer_batch of {len(batch)} on the {mesh.size}-replica mesh: bucket {bucket}, "
              f"{rows} rows per replica, equal bit for bit to one engine's forwards of {rows} "
              f"rows {exact}; against one engine's one forward of {bucket}: max "
              f"{levels} levels, min PSNR {worst:.2f} dB (bf16 convs at another batch); "
              f"launches {counts} ({mesh.size} replica forwards)", flush=True)
        if got.shape != batch.shape or not exact or worst < HTTP_PSNR_GATE_DB:
            raise AssertionError(f"17a the mesh's answers: bit for bit {exact}, {worst:.2f} dB")
    if any(b % mesh.size for b in buckets):
        raise AssertionError(f"17a buckets {buckets} not multiples of {mesh.size}")

    # img/s at bucket 64, in turns (the first round warms): infer_batch (one
    # synchronous call at a time) and submit (the collector feeding every
    # replica, up to 4 batches in flight)
    big = make_frames(MESH_RATE_BUCKET, MESH_SIZE, seed=172)
    rates = {name: [] for name in engines}
    stream = {name: [] for name in engines}
    for r in range(MESH_RATE_ROUNDS):
        for name, e in engines.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(MESH_RATE_CALLS):
                e.infer_batch(big)
            if r:
                rates[name].append(MESH_RATE_CALLS * MESH_RATE_BUCKET / (time.perf_counter() - t))
            t = time.perf_counter()
            futs = [e.submit(big[i % MESH_RATE_BUCKET]) for i in range(MESH_SUBMIT_FRAMES)]
            for f in futs:
                f.result(timeout=300)
            if r:
                stream[name].append(MESH_SUBMIT_FRAMES / (time.perf_counter() - t))
    for e in engines.values():
        e.stop()
    print(f"17a img/s at bucket {MESH_RATE_BUCKET} on {card}, in turns, median of "
          f"{MESH_RATE_ROUNDS - 1} rounds: infer_batch ({MESH_RATE_CALLS} calls) "
          + ", ".join(f"{k} {np.median(v):.1f}" for k, v in rates.items())
          + f"; submit ({MESH_SUBMIT_FRAMES} frames, one collector thread) "
          + ", ".join(f"{k} {np.median(v):.1f}" for k, v in stream.items())
          + (" (two replicas on one card: the cost of the split, not scaling)"
             if mesh.devices[0] == mesh.devices[-1] else ""), flush=True)
    return {"17a engine over the mesh": {k: sum(c[4][k] for c in results)
                                         for k in results[0][4]}}, solo


def mesh_server(card: str, mesh, solo) -> dict:
    """17b: ``create_server(mode="both", mesh=)``: 8 connections post 512^2
    pages, then one 1200x900 tile request; answers >= 45 dB of the single
    engine and a single tiler (phase 8's gate: bf16 convs at other batch
    sizes round apart), the buckets multiples of the mesh size, K1/K3 14/4
    per replica forward. Returns the launches."""
    import tempfile

    from image_enhancement_deglaring_tpu_torch.serve.http_server import create_server
    from image_enhancement_deglaring_tpu_torch.serve.tiling import TiledInference

    server = create_server(ONNX, host="127.0.0.1", port=_free_port(), mode="both",
                           max_batch_size=8, compute_dtype=torch.bfloat16, image_size=MESH_SIZE,
                           log_dir=tempfile.mkdtemp(prefix="chip_smoke_mesh_api_"), mesh=mesh)
    thread = _start(server)
    try:
        buckets = _record_buckets(server.engine)
        pages = make_frames(MESH_HTTP_PAGES, MESH_SIZE, seed=173)
        bodies = [("/infer", *_png_upload(p)) for p in pages]
        b0 = server.engine.stats()["batches_dispatched"]
        _reset_launches()
        answers, lat, wall = _post_all(server.port, bodies, HTTP_CONNECTIONS)
        counts = _launches()
        batches = server.engine.stats()["batches_dispatched"] - b0
        _per_forward(counts, mesh.size * batches, "17b resize traffic")
        pairs = [(_answer_pixels(a), w) for a, w in zip(answers, solo.infer_batch(pages))]
        levels = max(int(np.abs(g.astype(np.int16) - w).max()) for g, w in pairs)
        worst = _gate("17b resize answers against one engine", pairs)
        tile_img = make_frames(1, MESH_TILE_SIZE[0], seed=174, w=MESH_TILE_SIZE[1])[0]
        _reset_launches()
        (tile_answer,), _, _ = _post_all(server.port, [("/infer?mode=tile",
                                                         *_png_upload(tile_img))], 1)
        tile_counts = _launches()
        tiler = server.tiler
        chunks = -(-tiler.num_tiles(*MESH_TILE_SIZE) // tiler.max_tiles_per_batch)
        _per_forward(tile_counts, mesh.size * chunks, "17b tile request")
        one_tiler = TiledInference(solo._model, tile=MESH_SIZE, compute_dtype=torch.bfloat16,
                                   device="cuda")
        tile_pair = (_answer_pixels(tile_answer), one_tiler(tile_img))
        tile_levels = int(np.abs(tile_pair[0].astype(np.int16) - tile_pair[1]).max())
        tile_worst = _gate("17b tile answer against one tiler", [tile_pair])
        stats = _get_json(server.port, "/stats")[1]
    finally:
        _stop(server, thread)
    p50, p95, p99 = _percentiles_ms(lat)
    print(f"17b create_server(mode='both', mesh of {mesh.size}) on {card}: {len(bodies)} /infer "
          f"over {HTTP_CONNECTIONS} connections, {len(bodies) / wall:.1f} req/s, p50/p95/p99 "
          f"{p50:.2f} / {p95:.2f} / {p99:.2f} ms, {batches} batches, buckets "
          f"{sorted(set(buckets))}, against one engine max {levels} levels, min PSNR "
          f"{worst:.2f} dB; one {MESH_TILE_SIZE[1]}x{MESH_TILE_SIZE[0]} tile request "
          f"({tiler.num_tiles(*MESH_TILE_SIZE)} tiles, buckets {sorted(tiler._buckets_seen)}): "
          f"{tile_levels} levels, {tile_worst:.2f} dB from one tiler; "
          f"/stats requests_served {stats['requests_served']}, mean_batch_fill "
          f"{stats['mean_batch_fill']}; launches {counts} + {tile_counts}", flush=True)
    if any(b % mesh.size for b in buckets) or any(b % mesh.size for b in tiler._buckets_seen):
        raise AssertionError(f"17b buckets {buckets} / {tiler._buckets_seen} not multiples of "
                             f"{mesh.size}")
    return {"17b server over the mesh": {k: counts[k] + tile_counts[k] for k in counts}}


def mesh_clis(card: str, work: str) -> None:
    """17c: ``cli.enhance --data_parallel 2`` and ``cli.serve --data_parallel
    2`` resolve as the JAX CLIs do: on one card the clamp message, then
    one device (the enhanced files equal the plain run's bit for bit)."""
    from image_enhancement_deglaring_tpu_torch.cli import enhance as cli_enhance
    from image_enhancement_deglaring_tpu_torch.cli import serve as cli_serve
    from image_enhancement_deglaring_tpu_torch.data.png import decode_png, write_png

    n = torch.cuda.device_count()
    want = ("requested --data_parallel 2, but only 1 device(s) available; using 1"
            if n == 1 else "data-parallel over 2 chips")
    inp = os.path.join(work, "pages")
    os.makedirs(inp)
    for i, page in enumerate(make_frames(3, MESH_SIZE, seed=175)):
        write_png(os.path.join(inp, f"page_{i}.png"), page)
    outs = {}
    for name, extra in (("plain", []), ("dp", ["--data_parallel", "2"])):
        tee = _Tee()
        with contextlib.redirect_stdout(tee):
            cli_enhance.main(["--input", inp, "--output_dir", os.path.join(work, name),
                              "--model_path", ONNX, "--batch_size", "3", *extra])
        outs[name] = tee.text
    same = all(np.array_equal(decode_png(open(os.path.join(work, "plain", f), "rb").read()),
                              decode_png(open(os.path.join(work, "dp", f), "rb").read()))
               for f in os.listdir(os.path.join(work, "plain")))
    print(f"17c cli.enhance --data_parallel 2 on {n} card(s): '{want}' printed "
          f"{want in outs['dp']}; 3 pages equal to the run without it {same}", flush=True)
    if want not in outs["dp"] or (n == 1 and not same):
        raise AssertionError(f"17c cli.enhance: {outs['dp'][-2000:]}")

    import image_enhancement_deglaring_tpu_torch.serve as serve_pkg

    servers, real = [], serve_pkg.create_server

    def capture(*a, **k):
        servers.append(real(*a, **k))
        return servers[-1]

    port, tee = _free_port(), _Tee()
    with mock.patch.object(serve_pkg, "create_server", capture), contextlib.redirect_stdout(tee):
        thread = threading.Thread(target=cli_serve.main, args=([
            "--model_path", ONNX, "--host", "127.0.0.1", "--port", str(port), "--data_parallel",
            "2", "--log_dir", os.path.join(work, "serve_logs")],), daemon=True)
        thread.start()
        deadline = time.time() + 180
        while not servers or _ping(port) is not True:
            if time.time() > deadline or not thread.is_alive():
                raise AssertionError(f"17c cli.serve --data_parallel 2 never answered: {tee.text}")
            time.sleep(0.1)
        (answer,), _, _ = _post_all(port, [("/infer", *_png_upload(
            make_frames(1, MESH_SIZE, seed=176)[0]))], 1)
        server = servers[0]
        loop = server._server.get_loop()
        loop.call_soon_threadsafe(server._server.close)
        thread.join(timeout=60)
    mesh = server.engine.mesh
    print(f"17c cli.serve --data_parallel 2 on {n} card(s): '{want}' printed {want in tee.text}, "
          f"engine mesh {None if mesh is None else mesh.size}, /infer answered {answer[0]}",
          flush=True)
    if want not in tee.text or answer[0] != 200 or (mesh is None) != (n == 1):
        raise AssertionError(f"17c cli.serve: {tee.text[-2000:]}")


def _png_upload(img: np.ndarray) -> tuple:
    """(body, headers) of a multipart /infer upload of ``img`` as a PNG."""
    from image_enhancement_deglaring_tpu_torch.data.png import encode_png
    from image_enhancement_deglaring_tpu_torch.tools.load_test_api import multipart_body

    return multipart_body(encode_png(img))


class _MeshTrig:
    """A preemption guard that reads as triggered from its n+1-th read on
    (every rank reads it at the same points)."""

    def __init__(self, n):
        self.n, self.c = n, 0

    @property
    def triggered(self):
        self.c += 1
        return self.c > self.n


def _mesh_sweep_model():
    from image_enhancement_deglaring_tpu_torch.models import LightweightUNet

    return LightweightUNet(dtype=torch.float32, generator=torch.Generator().manual_seed(17))


def _mesh_sweep_loaders(bs):
    x, y = triptych_batch(MESH_SWEEP_TRAIN + MESH_SWEEP_VAL, MESH_SWEEP_SIZE, seed=177)
    n = MESH_SWEEP_TRAIN
    return _DPLoader(x[:n], y[:n], bs), _DPLoader(x[n:], y[n:], bs)


def _mesh_sweep(out_dir: str, mesh=None, **kw) -> dict:
    from image_enhancement_deglaring_tpu_torch.parallel import SearchSpace, run_sweep

    torch.use_deterministic_algorithms(True)
    try:
        return run_sweep(_mesh_sweep_model, _mesh_sweep_loaders, mesh=mesh, output_dir=out_dir,
                         space=SearchSpace(batch_sizes=(8,)), device="cuda", **kw)
    finally:
        torch.use_deterministic_algorithms(False)


def _mesh_sweep_rank(work: str) -> None:
    """One rank of 17d (``launch_local`` over Gloo on the one card): the
    sweep, and a preempted sweep resumed from rank 0's journal, per-rank
    directories; what it saw as JSON."""
    from image_enhancement_deglaring_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(device="cuda")
    r = mesh.rank
    t = time.perf_counter()
    res = _mesh_sweep(os.path.join(work, f"sweep_r{r}"), mesh, **MESH_SWEEP)
    secs = time.perf_counter() - t
    full = _mesh_sweep(os.path.join(work, f"full_r{r}"), mesh, **MESH_RESUME)
    pre_dir = os.path.join(work, f"pre_r{r}")
    pre = _mesh_sweep(pre_dir, mesh, preempt_guard=_MeshTrig(3), **MESH_RESUME)
    journal = os.path.exists(os.path.join(pre_dir, "sweep_journal.jsonl"))
    resumed = _mesh_sweep(pre_dir, mesh, resume=True, **MESH_RESUME)
    files = {f: os.path.exists(os.path.join(work, f"sweep_r{r}", f))
             for f in ("sweep_results.json", "sweep_journal.jsonl", "best_trial_params.npz")}
    out = {"device": str(mesh.device), "backend": mesh.backend, "seconds": secs,
           "result": res, "files": files, "preempted": pre["preempted"],
           "pre_trials": len(pre["trials"]), "journal_local": journal,
           "resumed_equal": resumed["trials"] == full["trials"] and resumed["best"] == full["best"],
           "resumed_results": os.path.exists(os.path.join(pre_dir, "sweep_results.json"))}
    with open(os.path.join(work, f"rank{r}.json"), "w") as f:
        json.dump(out, f)


def mesh_sweeps(card: str, work: str) -> None:
    """17d: ``run_sweep(mesh=)`` over two Gloo ranks on the card against one
    process: the best trial, per-trial best val losses within rtol 1e-5,
    rank 0 alone writes, and a sweep preempted then resumed from rank 0's
    journal equals the uninterrupted one."""
    from image_enhancement_deglaring_tpu_torch.parallel import distributed

    t = time.perf_counter()
    distributed.launch_local(_mesh_sweep_rank, 2, work, device="cuda", backend="gloo")
    t_ranks = time.perf_counter() - t
    r0, r1 = (json.load(open(os.path.join(work, f"rank{r}.json"))) for r in (0, 1))
    t = time.perf_counter()
    one = _mesh_sweep(os.path.join(work, "one"), None, **MESH_SWEEP)
    t_one = time.perf_counter() - t
    got = [x["best_val_loss"] for x in r0["result"]["trials"]]
    want = [x["best_val_loss"] for x in one["trials"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"17d run_sweep over two ranks on {r0['device']} and {r1['device']} ({r0['backend']}), "
          f"production LightweightUNet f32 {MESH_SWEEP_SIZE}^2, {MESH_SWEEP['n_trials']} trials x "
          f"{MESH_SWEEP['max_epochs']} epochs, halving forced to mask: {r0['seconds']:.1f} s "
          f"(both phases {t_ranks:.1f} s with the ranks' start) vs one process {t_one:.1f} s on "
          f"{card}; best trial {r0['result']['best']['trial_id']} vs "
          f"{one['best']['trial_id']}; per-trial best val rel diff max {rel:.2e} (gate "
          f"{MESH_SWEEP_RTOL}); ranks agree {r0['result'] == r1['result']}; files rank 0 "
          f"{r0['files']}, rank 1 {r1['files']}", flush=True)
    print(f"17d preempted after {r0['pre_trials']} journaled group(s), journal on rank 0 only "
          f"{r0['journal_local'] and not r1['journal_local']}; resumed equals uninterrupted "
          f"{r0['resumed_equal']} / {r1['resumed_equal']}; results file on rank 0 only "
          f"{r0['resumed_results'] and not r1['resumed_results']}", flush=True)
    if (r0["result"] != r1["result"] or r0["result"]["best"]["trial_id"] != one["best"]["trial_id"]
            or rel > MESH_SWEEP_RTOL):
        raise AssertionError("17d two ranks against one process")
    if not all(r0["files"].values()) or any(r1["files"].values()):
        raise AssertionError(f"17d files: rank 0 {r0['files']}, rank 1 {r1['files']}")
    if not (r0["preempted"] and r1["preempted"] and r0["journal_local"]
            and not r1["journal_local"] and r0["resumed_equal"] and r1["resumed_equal"]
            and r0["resumed_results"] and not r1["resumed_results"]):
        raise AssertionError(f"17d preempt and resume: {r0} / {r1}")


def mesh_sweep_cli(card: str, work: str) -> None:
    """17e: ``cli.sweep --distributed`` as an NCCL group of one against the
    same sweep without it, each in a process of its own as a user runs
    it: the results and the best trial's weights equal bit for bit."""
    from image_enhancement_deglaring_tpu_torch.parallel import distributed

    data = os.path.join(work, "data")
    write_triptychs(data, 24, 128, seed=178)
    outs = {}
    for name, extra in (("plain", []), ("distributed", [
            "--distributed", "--num_processes", "1", "--process_id", "0",
            "--coordinator_address", f"127.0.0.1:{distributed.free_port()}"])):
        out = os.path.join(work, name)
        t = time.perf_counter()
        proc = _sweep_cli(["--data_dir", data, "--output_dir", out, *MESH_CLI_FLAGS, *extra],
                          os.path.join(work, f"{name}.log"))
        rc = proc.wait(timeout=600)
        text = open(os.path.join(work, f"{name}.log")).read()
        if rc != 0:
            raise AssertionError(f"17e cli.sweep {name} rc {rc}: {text[-3000:]}")
        outs[name] = (json.load(open(os.path.join(out, "sweep_results.json"))),
                      dict(np.load(os.path.join(out, "best_trial_params.npz"))),
                      time.perf_counter() - t, text)
    (res_p, w_p, s_p, _), (res_d, w_d, s_d, text_d) = outs["plain"], outs["distributed"]
    same_w = w_p.keys() == w_d.keys() and all(np.array_equal(w_p[k], w_d[k]) for k in w_p)
    print(f"17e cli.sweep {' '.join(MESH_CLI_FLAGS)} (bf16) on {card}: without a group "
          f"{s_p:.1f} s, --distributed (NCCL, one process) {s_d:.1f} s; results equal "
          f"{res_p == res_d}, best_trial_params.npz equal bit for bit {same_w}; best trial "
          f"{res_d['best']['trial_id']}", flush=True)
    if res_p != res_d or not same_w or "Distributed runtime: 1 process(es)" not in text_d:
        raise AssertionError("17e --distributed changed the sweep")


def serving_and_sweeps_over_devices(card: str) -> dict:
    """Phase 17: (a) the engine over a LocalMesh, (b) the server over it, (c)
    the CLIs' --data_parallel, (d) run_sweep over two ranks, (e) cli.sweep
    --distributed. Returns the launches of (a) and (b) by path."""
    import shutil
    import tempfile

    from image_enhancement_deglaring_tpu_torch.parallel import LocalMesh

    mesh = LocalMesh(_mesh_devices())
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    try:
        paths, solo = timed("17a", mesh_engine, card, mesh)
        paths.update(timed("17b", mesh_server, card, mesh, solo))
        timed("17c", mesh_clis, card, os.path.join(work, "clis"))
        timed("17d", mesh_sweeps, card, os.path.join(work, "sweeps"))
        timed("17e", mesh_sweep_cli, card, os.path.join(work, "cli_sweep"))
        return paths
    finally:
        shutil.rmtree(work, ignore_errors=True)


def soak(card: str, seconds: float) -> None:
    """Phases 15 and 16 again until ``seconds`` have passed (at least once);
    their launches count on no path."""
    t0, passes = time.perf_counter(), 0
    while not passes or time.perf_counter() - t0 < seconds:
        passes += 1
        slice_tools(card)
        data_parallel(card)
        names = sorted(t.name for t in threading.enumerate())
        print(f"soak pass {passes} done at {time.perf_counter() - t0:.1f} s; "
              f"{len(names)} threads: {names}", flush=True)


def main(argv: list | None = None) -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--soak", type=float, default=0.0, metavar="SECONDS",
                        help="repeat phases 15 and 16 for SECONDS before phase 17")
    args = parser.parse_args(argv)
    # a fatal signal (a native crash) prints every thread's Python stack
    faulthandler.enable(all_threads=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    # cuBLAS under deterministic algorithms (phase 11) needs a fixed
    # workspace; 8 x 4 MiB is also PyTorch's default size on Hopper
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # each path's launches, counted from 0 in its own run
    paths = {"4 serving slice": phase("4 serving slice", serve_slice),
             "5 entry points": phase("5 kernel entry points on model activations",
                                     model_entry_points)}
    phase("6 throughput", throughput, card)
    ln_rows, paths["6b one Restormer forward"] = phase("6b Restormer's channel LayerNorm (K6)",
                                                       layer_norm_kernels, card)
    rows.update(ln_rows)
    phase("7a kernels refuse autograd", grad_guard)
    phase("7b f32 train step, card vs CPU", train_f32_parity)
    step_rate, paths["7c one bf16 train step"] = phase("7c bf16 train step throughput",
                                                       train_throughput, card)
    loader_rates = phase("7d cli.train entry point", train_entry_point)
    # a microbenchmark, as phase 3 is: its rows, not its launches
    rows.update(phase("7e GroupNorm+SiLU training pair", train_gn_kernels))
    bn_rows, paths["7f one EnhancedUNet step"] = phase("7f BatchNorm+ReLU training pair",
                                                       train_bn_kernels)
    rows.update(bn_rows)
    counts, single_load = phase("8 HTTP serving on the card", http_serving, card)
    paths.update(counts)
    paths.update(phase("9 evaluation on the card", evaluation, card))
    paths.update(phase("10 HTTP worker processes", http_workers, card, single_load))
    paths["11 resident training and the other families"] = phase(
        "11 resident training and the other families", resident_training, card, step_rate,
        loader_rates)
    paths.update(phase("12 JPEG uploads, every family served", jpeg_and_families, card,
                       single_load))
    paths.update(phase("13 lifecycle, exported artifact, int8 serving", lifecycle_and_int8,
                       card))
    paths.update(phase("14 sweeps on one card", sweeps, card))
    paths.update(phase("15 heavy augmentation, profiler, tools, native decode", slice_tools,
                       card))
    paths.update(phase("16 data parallelism on the card", data_parallel, card))
    if args.soak > 0:
        phase("15-16 soak", soak, card, args.soak)
    paths.update(phase("17 serving and sweeps over several devices",
                       serving_and_sweeps_over_devices, card))

    src = "image_enhancement_deglaring_tpu_torch/csrc/"
    tpu = "image_enhancement_deglaring_tpu/ops/"
    meta = {
        "gn_silu_flat": (src + "gn_silu.cu", tpu + "pallas_kernels.py:251"),
        "gn_silu_nhwc": (src + "gn_silu.cu", tpu + "pallas_kernels.py:92"),
        "conv3x3_gn_silu": (src + "conv_gn_silu.cu", tpu + "pallas_kernels.py:339"),
        "conv3x3_gn_silu_batched": (src + "conv_gn_silu.cu", tpu + "pallas_kernels.py:419"),
        "dec1_output": (src + "dec1_output.cu", tpu + "pallas_dec1.py:249"),
        # training replaced XLA's fusion of the composition, no Pallas kernel
        "gn_silu_train_fwd": (src + "gn_silu.cu", None),
        "gn_silu_train_bwd": (src + "gn_silu.cu", None),
        **{k: (src + "batch_norm.cu", None) for k in BN_KERNELS},
        # Restormer exists only in the port
        "channel_layer_norm": (src + "layer_norm.cu", None),
    }
    ln_elsewhere = {p: c["channel_layer_norm"] for p, c in paths.items()
                    if c.get("channel_layer_norm") and p != "6b one Restormer forward"}
    if ln_elsewhere:
        raise AssertionError(f"K6 launched on U-Net paths: {ln_elsewhere}")
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c.get(name, 0) for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items() if c.get(name)},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["by"], key=r["by"].get), "library_ms": r["library_ms"],
        }
        if name in ("dec1_output", "channel_layer_norm") or name.startswith(
                ("gn_silu_train", "bn_train")):
            # no one PyTorch call computes the dec1 tail, a training pass or
            # Restormer's BiasFree LayerNorm over NHWC channels:
            # the yardstick is the composition of the model's ops
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
