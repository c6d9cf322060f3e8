"""How the port's dispatchers route a CPU tensor, against the JAX package.

With ``use_pallas=None`` off the TPU, both JAX dispatchers take the XLA
composition, so the JAX model computes the same function on the CPU with
``pallas_gn`` / ``fused_blocks`` as without them. The port's dispatchers
do the same with ``use_kernel=None`` on a CPU tensor, and so does the
port's model with ``kernels=True``, the JAX model's two knobs; a forced
``use_kernel=True`` there is the kernel's plain version (JAX runs the
kernel in interpret mode). Then the bf16 serving path of both packages on
the production weights, through their engines."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.modelio import lightweight_unet_params_from_onnx as jax_reader
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.serve import InferenceEngine as JaxEngine
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.modelio import load_lightweight_unet
from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
from image_enhancement_deglaring_tpu_torch.ops.conv_blocks import conv2d, group_norm, silu
from image_enhancement_deglaring_tpu_torch.serve import InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")
# the JAX model's knobs that LightweightUNet(kernels=True) stands for
KNOBS = dict(pallas_gn=True, fused_blocks="auto")

# bf16 engine against bf16 engine, uint8 frames at 32x32 on best_model.onnx.
# The two packages round bf16 at other places (XLA fuses and keeps f32
# where PyTorch's ops store bf16), so their frames differ by a few levels:
# 46.58 dB, at most 6 levels apart, read on XLA's and PyTorch's CPU
# runtimes, knobs on or off alike. The gate leaves 2.5 dB below that; a
# fault in the model or the engine (a wrong weight, a missing SiLU, a
# swapped skip) costs far more than that.
BF16_ENGINE_PSNR_DB = 44.0


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def _rand(rng, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_knobs_on_cpu_equal_knobs_off_bit_for_bit(dtype):
    """``kernels`` changes nothing on the CPU, in either dtype: every site
    takes the composition, as in the JAX model."""
    x = torch.from_numpy(np.random.default_rng(1).random((2, 32, 32, 1)).astype(np.float32))
    outs = []
    for knobs in (dict(kernels=True), {}):
        model = LightweightUNet(dtype=dtype, generator=torch.Generator().manual_seed(5), **knobs)
        fk.reset_launch_counts()
        with torch.inference_mode():
            outs.append(model(x))
        assert set(fk.LAUNCHES.values()) == {0}
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 8, 16, 8), (2, 4, 4, 64)])
def test_gn_dispatch_on_cpu(shape):
    """None: the composition, bit for bit; True: the plain version of the
    kernel the shape rules pick (K1 for the first shape, K2 for the
    second), bit for bit, which is another function."""
    rng = np.random.default_rng(2)
    c = shape[-1]
    x, s, b = _rand(rng, *shape, s=2.0) + 0.5, _rand(rng, c), _rand(rng, c)
    comp = silu(group_norm(x, s, b, num_groups=8))
    plain = fk.gn_silu_plain(x, s, b, num_groups=8)
    torch.testing.assert_close(fk.fused_group_norm_silu(x, s, b, num_groups=8), comp,
                               rtol=0, atol=0)
    torch.testing.assert_close(fk.fused_group_norm_silu(x, s, b, num_groups=8, use_kernel=True),
                               plain, rtol=0, atol=0)
    assert not torch.equal(comp, plain)  # single-pass variance: other bits


@pytest.mark.parametrize("images_per_step", [None, 2])
def test_conv_dispatch_on_cpu(images_per_step):
    """None: the composition, bit for bit; True: K3's (or K4's) plain
    version, bit for bit; bf16, where the plain version widens the conv."""
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 8, 8, 32).bfloat16()
    w, s, b = _rand(rng, 3, 3, 32, 64, s=0.1), _rand(rng, 64), _rand(rng, 64)
    kw = dict(num_groups=8, images_per_step=images_per_step)
    comp = silu(group_norm(conv2d(x, w, padding=1), s, b, num_groups=8))
    plain = fk.conv3x3_gn_silu_plain(x, w, s, b, num_groups=8)
    fk.reset_launch_counts()
    torch.testing.assert_close(fk.fused_conv3x3_gn_silu(x, w, s, b, **kw), comp, rtol=0, atol=0)
    torch.testing.assert_close(fk.fused_conv3x3_gn_silu(x, w, s, b, use_kernel=True, **kw),
                               plain, rtol=0, atol=0)
    assert not torch.equal(comp, plain)
    assert set(fk.LAUNCHES.values()) == {0}


@pytest.fixture(scope="module")
def frames32():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:32, 0:32] / 32
    base = 0.6 + 0.25 * np.sin(2 * np.pi * (xx + 2 * yy))[None]
    return (np.clip(base + 0.08 * rng.standard_normal((4, 32, 32)), 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def bf16_frames(frames32):
    """uint8 frames of each package's bf16 engine, knobs off and on."""
    params = jax_reader(ONNX)
    out = {}
    for key, knobs in (("off", {}), ("on", KNOBS)):
        jeng = JaxEngine(JaxUNet(dtype=jnp.bfloat16, **knobs).apply, params, image_size=32,
                         max_batch_size=4, compute_dtype=jnp.bfloat16, warmup=False)
        model = load_lightweight_unet(ONNX, dtype=torch.bfloat16, device="cpu",
                                      kernels=key == "on")
        eng = InferenceEngine(model, image_size=32, max_batch_size=4,
                              compute_dtype=torch.bfloat16, device="cpu", warmup=False)
        try:
            out[key] = (jeng.infer_batch(frames32), eng.infer_batch(frames32))
        finally:
            eng.stop()
    return out


@pytest.mark.parametrize("knobs", ["off", "on"])
def test_bf16_engine_matches_jax_bf16_engine(bf16_frames, frames32, knobs):
    """The port's bf16 InferenceEngine against the JAX package's bf16 one
    on best_model.onnx at 32x32, uint8 out: at least BF16_ENGINE_PSNR_DB
    apart. With the knobs on, both packages compute the composition on the
    CPU, so each gives its knobs-off frames bit for bit."""
    want, got = bf16_frames[knobs]
    assert got.shape == want.shape == frames32.shape and got.dtype == np.uint8
    p = _psnr(got, want)
    assert p >= BF16_ENGINE_PSNR_DB, (p, int(np.abs(got.astype(int) - want).max()))
    np.testing.assert_array_equal(want, bf16_frames["off"][0])
    np.testing.assert_array_equal(got, bf16_frames["off"][1])
