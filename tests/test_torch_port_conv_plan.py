"""The bf16 conv kernel's launch plan (``fused_kernels._conv_plan``) on the
CPU: every (image, tile, output-channel tile) item is walked exactly once
by exactly one block, the dynamic shared memory fits one H100 block, the
grid is min(items, SMs x blocks per SM) whatever K is, and K only orders
a block's walk. Also: the ctypes signatures of every C entry point match
the prototypes in the CUDA sources. The kernel itself runs only on the
card (chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu_torch.ops import _build
from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

# (Cin, Cout) of every conv of LightweightUNet's encoder and bottleneck
# blocks, each a shape the conv kernel takes (the model runs it at the
# blocks of 64 channels and more)
UNET_PAIRS = [(1, 8), (8, 8), (8, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
              (64, 128), (128, 128)]
SIZES = [(512, 512), (64, 64), (32, 32), (4, 4), (2, 2), (6, 6)]
IMAGES = (1, 2, 4, 8)
SMS = (132, 8)
BATCH = 8


def _plans(cin, cout):
    for h, w in SIZES:
        for k in IMAGES:
            for sms in SMS:
                yield (h, w, k, sms), fk._conv_plan(BATCH, h, w, cin, cout, k, sms)


@pytest.mark.parametrize("cin,cout", UNET_PAIRS)
def test_conv_plan_walks_every_item_once(cin, cout):
    for (h, w, k, sms), plan in _plans(cin, cout):
        tiles = -(-h // 8) * -(-w // 8)
        assert plan.tiles == tiles and plan.co_tiles == -(-cout // 64)
        assert plan.items == BATCH * tiles * plan.co_tiles
        walked = np.concatenate([np.arange(r.start, r.stop)
                                 for r in map(plan.block_range, range(plan.grid))])
        assert all(len(plan.block_range(b)) >= 1 for b in range(plan.grid))
        np.testing.assert_array_equal(walked, np.arange(plan.items))
        img, tile, ct = plan.decode(walked)
        key = (ct * BATCH + img) * tiles + tile
        assert img.min() >= 0 and img.max() < BATCH and tile.max() < tiles
        assert ct.max() < plan.co_tiles
        np.testing.assert_array_equal(np.sort(key), np.arange(plan.items)), (h, w, k, sms)


@pytest.mark.parametrize("cin,cout", UNET_PAIRS)
def test_conv_plan_shared_memory_and_grid(cin, cout):
    grids = {}
    for (h, w, k, sms), plan in _plans(cin, cout):
        assert 0 < plan.smem <= fk.BLOCK_SHARED_MAX
        assert plan.blocks_per_sm >= 1
        assert plan.blocks_per_sm * (plan.smem + 1024) <= 233_472  # one SM's shared memory
        assert plan.grid == min(plan.items, sms * plan.blocks_per_sm)
        grids.setdefault((h, w, sms), set()).add(plan.grid)
    assert all(len(g) == 1 for g in grids.values())  # K never changes the grid


@pytest.mark.parametrize("cin,cout", UNET_PAIRS)
def test_conv_plan_keeps_the_weight_slice_resident(cin, cout):
    """Up to 128 input channels one weight window covers Cin: the block
    stages its slice once per output-channel tile and keeps it."""
    plan = fk._conv_plan(BATCH, 64, 64, cin, cout, 1, 132)
    assert plan.windows == 1 and 16 * plan.kc >= cin and plan.kc in (1, 2, 4, 8)
    assert plan.kc == 1 or 8 * plan.kc < cin  # the smallest power of two that covers Cin


@pytest.mark.parametrize("images", IMAGES)
def test_conv_plan_k_orders_images_of_a_tile_in_a_row(images):
    """Item order: output-channel tile, then groups of K images, then tile,
    then the image within the group: the K images of a tile come in a row."""
    plan = fk._conv_plan(BATCH, 32, 32, 64, 128, images, 132)
    img, tile, ct = plan.decode(np.arange(plan.items))
    runs = np.arange(plan.items) // images
    for r in np.unique(runs)[:40]:
        sel = runs == r
        assert len(set(tile[sel])) == 1 and len(set(ct[sel])) == 1
        assert list(img[sel]) == list(range(img[sel][0], img[sel][0] + images))
    assert all(ct[i] <= ct[i + 1] for i in range(plan.items - 1))


def test_conv_plan_streams_weights_above_128_input_channels():
    plan = fk._conv_plan(2, 16, 16, 256, 64, 1, 132)
    assert (plan.kc, plan.windows) == (8, 2)
    assert plan.smem <= fk.BLOCK_SHARED_MAX


def test_conv_plan_rejects_a_batch_that_k_does_not_divide():
    with pytest.raises(ValueError, match="not divisible"):
        fk._conv_plan(6, 8, 8, 64, 64, 4, 132)


def test_conv_plan_items_below_sms():
    """Batch 8, K = 8 at 8x32x32x128->128: 256 items over a grid of one
    block per SM; at 8x4x4x64->64, 8 items and a grid of 8."""
    plan = fk._conv_plan(8, 32, 32, 128, 128, 8, 132)
    assert (plan.items, plan.blocks_per_sm, plan.grid) == (256, 1, 132)
    plan = fk._conv_plan(8, 4, 4, 64, 64, 8, 132)
    assert (plan.items, plan.grid) == (8, 8)


_C_TYPES = {"const void*": _build.ctypes.c_void_p, "void*": _build.ctypes.c_void_p,
            "int": _build.ctypes.c_int, "float": _build.ctypes.c_float,
            "long long": _build.ctypes.c_longlong, "double": _build.ctypes.c_double}


def _c_prototypes(source: Path) -> dict:
    """name -> ctypes argument types of every extern "C" int function."""
    text = source.read_text()
    text = text[text.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", text, flags=re.M):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            types.append(_C_TYPES[p.rsplit(" ", 1)[0].replace(" *", "*")])
        out[name] = types
    return out


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_prototypes(lib):
    assert _c_prototypes(_build.CSRC / f"{lib}.cu") == _build.SIGNATURES[lib]


def test_bf16_conv_on_cpu_is_the_plain_version(rng):
    """On the CPU both conv wrappers compute the plain version in bf16 and
    launch nothing."""
    fk.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 24)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((3, 3, 24, 16)).astype(np.float32) * 0.1)
    s, b = torch.ones(16), torch.zeros(16)
    want = fk.conv3x3_gn_silu_plain(x, w, s, b, num_groups=8)
    assert torch.equal(fk.conv3x3_gn_silu(x, w, s, b, num_groups=8), want)
    assert torch.equal(fk.conv3x3_gn_silu_batched(x, w, s, b, num_groups=8, images=2), want)
    assert fk.LAUNCHES["conv3x3_gn_silu"] == fk.LAUNCHES["conv3x3_gn_silu_batched"] == 0
