"""The GroupNorm+SiLU kernel's launch plan (``fused_kernels._gn_plan``) on
the CPU: every pixel of every image is owned by exactly one block in
exactly one wave, a wave holds whole images whose resident chunks fit the
card's shared memory, the re-read route is taken exactly where one image
does not fit, and shapes whose channels do not fill 16-byte vectors get a
valid element-by-element plan. Also the per-stream workspace and the
wrappers on CPU tensors. The kernel itself runs only on the card
(chip_smoke.py)."""

import sys
import threading

import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

# the K1 shapes of chip_smoke.py (without the batch)
K1_SHAPES = [(512, 512, 8), (256, 256, 16), (128, 128, 32), (64, 64, 64), (32, 32, 128),
             (32, 32, 8), (16, 16, 16), (8, 8, 32)]
BATCHES = (8, 64)
SMS = (132, 16)
SM_SHARED_TOTAL = 132 * 232_448  # every H100 block's dynamic shared memory at once
DTYPES = (torch.bfloat16, torch.float32)


def _coverage(plan) -> np.ndarray:
    """How many times each (image, pixel) is owned by a block in a wave."""
    seen = np.zeros((plan.n, plan.pixels), np.int16)
    for b in range(plan.grid):
        for img, p0, p1 in plan.work(b):
            seen[img, p0:p1] += 1
    return seen


def _check_layout(plan, sms):
    """What every plan must satisfy, whatever its route."""
    assert 1 <= plan.grid == plan.images * plan.chunks <= sms
    assert 0 < plan.smem <= fk.BLOCK_SHARED_MAX
    assert plan.threads <= 1024 and plan.threads % (plan.c // plan.vec) == 0
    assert plan.vec == 1 or plan.threads == 512
    assert 1 <= plan.resident_pix <= plan.chunk_pix
    assert plan.resident_pix * plan.c * plan.elem <= plan.smem
    # chunks start on 16-byte boundaries of the slab, and none is empty
    assert plan.chunks == 1 or plan.chunk_pix * plan.c * plan.elem % 16 == 0
    assert (plan.chunks - 1) * plan.chunk_pix < plan.pixels <= plan.chunks * plan.chunk_pix


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c", K1_SHAPES)
def test_gn_plan_covers_every_pixel_once(h, w, c, dtype):
    for n in BATCHES:
        for sms in SMS:
            plan = fk._gn_plan(n, h, w, c, dtype, sms)
            _check_layout(plan, sms)
            assert (_coverage(plan) == 1).all(), (n, sms)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", BATCHES)
def test_gn_plan_waves_hold_whole_images_that_fit(n, dtype):
    for h, w, c in K1_SHAPES:
        plan = fk._gn_plan(n, h, w, c, dtype, 132)
        assert plan.reread_pix == 0 and plan.resident_pix == plan.chunk_pix
        assert plan.bytes_read == n * h * w * c * plan.elem
        assert plan.grid * plan.resident_pix * c * plan.elem <= SM_SHARED_TOTAL
        for wave in range(plan.waves):
            images = {}
            for b in range(plan.grid):
                work = plan.work(b)
                if wave < len(work):
                    images.setdefault(work[wave][0], []).append(b % plan.chunks)
            # every image of the wave has all its chunks in the wave
            assert all(sorted(v) == list(range(plan.chunks)) for v in images.values())
            assert len(images) == min(plan.images, n - wave * plan.images)
        # waves even out the batch: none is short by more than one image each
        assert plan.waves * plan.images - n < plan.waves


@pytest.mark.parametrize("c,dtype", [(8, torch.bfloat16), (8, torch.float32),
                                     (32, torch.bfloat16)])
def test_gn_plan_rereads_exactly_where_an_image_exceeds_one_wave(c, dtype):
    """The re-read route (one image per wave on every SM, chunks larger
    than their shared memory) begins at the first image larger than the
    SMs' resident capacity, which the re-read plan's resident pixels give."""
    w, sms = 1024, 132
    cap = fk._gn_plan(1, 4096, w, c, dtype, sms).resident_pix
    edge = sms * cap // w
    for h in range(edge - 6, edge + 7):
        plan = fk._gn_plan(2, h, w, c, dtype, sms)
        _check_layout(plan, sms)
        assert (plan.reread_pix > 0) == (h * w > sms * cap), h
        if plan.reread_pix:
            assert (plan.images, plan.chunks, plan.resident_pix) == (1, sms, cap)
            assert plan.bytes_read > 2 * h * w * c * plan.elem
        else:
            assert plan.bytes_read == 2 * h * w * c * plan.elem
        assert (_coverage(plan) == 1).all(), h


@pytest.mark.parametrize("n,h,w,c,dtype", [(1, 2048, 2048, 8, torch.bfloat16),
                                           (2, 1024, 1024, 8, torch.float32)])
def test_gn_plan_chip_smoke_reread_cases(n, h, w, c, dtype):
    plan = fk._gn_plan(n, h, w, c, dtype, 132)
    assert plan.reread_pix > 0 and plan.images == 1 and plan.waves == n
    assert plan.bytes_read > n * h * w * c * plan.elem
    assert (_coverage(plan) == 1).all()


@pytest.mark.parametrize("n,h,w,c,dtype,vec", [
    (1, 8, 32, 4, torch.bfloat16, 1),   # C % 8 != 0: W*C = 128, K1-eligible at 4 groups
    (1, 8, 32, 4, torch.float32, 4),    # one float32 vector holds the pixel
    (2, 5, 5, 66, torch.bfloat16, 1),   # K2-eligible, slab not a multiple of 16 bytes
    (3, 8, 16, 24, torch.bfloat16, 1),  # three vectors per pixel: 3 does not divide 32
    (8, 64, 64, 12, torch.float32, 1),
])
def test_gn_plan_channels_that_do_not_fill_vectors(n, h, w, c, dtype, vec):
    plan = fk._gn_plan(n, h, w, c, dtype, 132)
    assert plan.vec == vec
    _check_layout(plan, 132)
    assert (_coverage(plan) == 1).all()


def test_gn_plan_unaligned_input_reads_elements():
    assert fk._gn_plan(8, 64, 64, 64, torch.bfloat16, 132).vec == 8
    plan = fk._gn_plan(8, 64, 64, 64, torch.bfloat16, 132, False)
    assert plan.vec == 1 and plan.threads == 512
    _check_layout(plan, 132)


def test_gn_plan_small_images_are_one_chunk():
    """An image below 16 KiB is one chunk: its block needs no handshake."""
    for h, w, c in [(32, 32, 8), (16, 16, 16), (8, 8, 32), (4, 4, 64)]:
        plan = fk._gn_plan(8, h, w, c, torch.bfloat16, 132)
        assert (plan.chunks, plan.images, plan.grid) == (1, 8, 8)


def test_gn_plan_rejects_more_than_1024_channels():
    with pytest.raises(ValueError, match="1024 channels"):
        fk._gn_plan(1, 4, 4, 2048, torch.float32, 132)


def test_gn_workspace_is_per_stream_and_grows_zeroed(monkeypatch):
    monkeypatch.setattr(fk, "_GN_WORK", {})
    dev = torch.device("cpu")
    a, slots = fk._gn_workspace(dev, 1, 8, 100)
    assert slots == 8 and a.numel() == 108 and not a.any()
    assert fk._gn_workspace(dev, 1, 5, 60)[0] is a  # one stream, one workspace
    b, _ = fk._gn_workspace(dev, 2, 8, 100)
    assert b is not a  # never shared with another stream
    a[:8] = 7  # counters of the old buffer do not carry over: a grown one starts at 0
    c, slots = fk._gn_workspace(dev, 1, 9, 100)
    assert c is not a and slots == 12 and c.numel() == 112 and not c.any()
    d, slots = fk._gn_workspace(dev, 1, 2, 500)
    assert slots == 12 and d.numel() == 512


def test_gn_workspace_under_its_lock_loses_no_growth(monkeypatch):
    """Threads asking for workspaces of random sizes on two streams, as the
    wrapper does (under _GN_WORK_LOCK): each stream's final workspace
    holds the most any call asked for, which a lost update would break."""
    monkeypatch.setattr(fk, "_GN_WORK", {})
    dev, asked, errors = torch.device("cpu"), {}, []
    old = sys.getswitchinterval()

    def worker(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(200):
                stream, n, part = int(r.integers(2)), int(r.integers(1, 70)), int(r.integers(400))
                with fk._GN_WORK_LOCK:
                    work, slots = fk._gn_workspace(dev, stream, n, part)
                    assert slots >= n and work.numel() - slots >= part
                    got = asked.setdefault(stream, [0, 0])
                    got[0], got[1] = max(got[0], n), max(got[1], part)
        except AssertionError as e:
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    for stream, (n, part) in asked.items():
        work, slots = fk._GN_WORK[(None, stream)]
        assert slots >= n and work.numel() - slots >= part


@pytest.mark.parametrize("name", ["gn_silu_flat", "gn_silu_nhwc"])
@pytest.mark.parametrize("shape,groups", [((2, 16, 16, 8), 8), ((1, 8, 32, 4), 4),
                                          ((2, 5, 5, 66), 2)])
def test_gn_wrappers_on_cpu_are_the_plain_version(rng, name, shape, groups):
    fk.reset_launch_counts()
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2 + 0.5)
    s = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    for t in (x, x.bfloat16()):
        want = fk.gn_silu_plain(t, s, b, num_groups=groups)
        assert torch.equal(getattr(fk, name)(t, s, b, num_groups=groups), want)
    assert fk.LAUNCHES[name] == 0
