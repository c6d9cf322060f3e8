"""The port's dec1 tail (K5, ``ops.dec1``) against the JAX package on the CPU:
its plain version and its wrapper on CPU tensors against the Pallas kernel
``fused_dec1_output`` run in interpret mode, the composition against
``dec1_output_xla``, the entry contract (C == num_groups, the tile_h
fallback), K5 on the production model's dec1 activations against the JAX
model, and the bench entry. The CUDA kernel is held against the plain
version on the card by chip_smoke.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import lax

from image_enhancement_deglaring_tpu.modelio import lightweight_unet_params_from_onnx as jax_reader
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.ops import pallas_dec1 as jdec1
from image_enhancement_deglaring_tpu_torch.modelio import load_lightweight_unet
from image_enhancement_deglaring_tpu_torch.ops import dec1
from image_enhancement_deglaring_tpu_torch.tools import dec1_slice_bench

C = 8
# (B, H, W, tile_h values, seed): the shapes and tilings of tests/test_pallas.py
CASES = {"2x64x128": (2, 64, 128, (16,), 3), "1x48x128": (1, 48, 128, (48, 7, 16), 4)}


def _case(key):
    b, h, w, _, seed = CASES[key]
    rng = np.random.default_rng(seed)

    def f(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    xu, xs = f(b, h, w, C), f(b, h, w, C)
    weights = (f(3, 3, C, C, s=.2), f(3, 3, C, C, s=.2), f(3, 3, C, C, s=.2),
               f(C), f(C), f(C), f(C), f(1, 1, C, 1, s=.3), f(1))
    return xu, xs, weights


def _t(a):
    return torch.from_numpy(np.array(a))


class _WidenedDotLax:
    """``jax.lax`` with a dot_general that widens bfloat16 operands to
    float32 first. XLA's CPU runtime has no bf16 x bf16 -> f32 dot, which
    the TPU kernel's convs use; the widened dot forms the same products
    (exact in float32) and sums them in float32, as the TPU's matrix unit
    does, and every other line of the kernel runs as written."""

    def __getattr__(self, name):
        return getattr(lax, name)

    @staticmethod
    def dot_general(a, b, *args, **kwargs):
        a = a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a
        b = b.astype(jnp.float32) if b.dtype == jnp.bfloat16 else b
        kwargs["precision"] = lax.Precision.HIGHEST
        return lax.dot_general(a, b, *args, **kwargs)


def _jax_kernel(xu, xs, weights, tile_h, dtype=jnp.float32):
    cf = [jnp.asarray(a.transpose(0, 3, 1, 2)).astype(dtype) for a in (xu, xs)]
    return np.asarray(jdec1.fused_dec1_output(*cf, *weights, tile_h=tile_h, interpret=True))


@pytest.mark.parametrize("key,tile_h", [(k, th) for k, v in CASES.items() for th in v[3]])
def test_dec1_f32_matches_pallas_kernel(key, tile_h):
    """Plain version and CPU wrapper vs the TPU kernel in interpret mode, at
    tests/test_pallas.py's tolerance."""
    xu, xs, weights = _case(key)
    want = _jax_kernel(xu, xs, weights, tile_h)
    args = (_t(xu), _t(xs), *map(_t, weights))
    plain = dec1.dec1_output_plain(*args)
    got = dec1.fused_dec1_output(*args, tile_h=tile_h)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


# chip_smoke.py's bf16 gate of K5 against its plain version: the largest
# |error|, the mean |error|, and at most 1 % of the outputs beyond 1e-3
BF16_MAX, BF16_MEAN, BF16_BEYOND = 0.03, 1e-4, (1e-3, 0.01)


def _breaks_bf16_gate(err):
    thr, share = BF16_BEYOND
    return err.max() > BF16_MAX or err.mean() > BF16_MEAN or (err > thr).mean() > share


@pytest.mark.parametrize("key", list(CASES))
def test_dec1_bf16_plain_rounds_like_pallas_kernel(monkeypatch, key):
    """In bfloat16 the plain version rounds where the TPU kernel does (h1, a1
    and h2 in bf16, statistics from the unrounded f32 sums, a2 and the 1x1
    conv in f32). Both sides sum the same exact products in another order,
    so a stored value can land one bf16 ulp away and move a few outputs: it
    passes chip_smoke.py's gate. Two rounding faults fail it: the
    composition's rounding (statistics of the rounded h1/h2, a2 and the
    output in bf16) and no bf16 rounding of h1, a1 and h2 at all."""
    monkeypatch.setattr(jdec1, "lax", _WidenedDotLax())
    xu, xs, weights = _case(key)
    tile_h = CASES[key][3][-1]
    want = _jax_kernel(xu, xs, weights, tile_h, jnp.bfloat16)
    args = (_t(xu).bfloat16(), _t(xs).bfloat16(), *map(_t, weights))
    err = np.abs(dec1.fused_dec1_output(*args, tile_h=tile_h).numpy() - want)
    assert not _breaks_bf16_gate(err), (err.max(), err.mean(), (err > 1e-3).mean())
    unrounded = (_t(xu).bfloat16().float(), _t(xs).bfloat16().float(),
                 *(_t(w).bfloat16().float() for w in weights[:3]), *map(_t, weights[3:]))
    for fault in (dec1.dec1_output_composition(*args).numpy()[..., 0],
                  dec1.dec1_output_plain(*unrounded).numpy()):
        err = np.abs(fault - want)
        assert _breaks_bf16_gate(err), (err.max(), err.mean(), (err > 1e-3).mean())


def test_dec1_composition_matches_xla():
    xu, xs, weights = _case("2x64x128")
    want = np.asarray(jdec1.dec1_output_xla(jnp.asarray(xu), jnp.asarray(xs), *weights))
    got = dec1.dec1_output_composition(_t(xu), _t(xs), *map(_t, weights))
    assert got.shape == want.shape == (2, 64, 128, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_dec1_rejects_grouped_gn():
    """C != num_groups raises in both packages, before any device dispatch."""
    args = dict(wa=np.zeros((3, 3, C, C), np.float32), wb=np.zeros((3, 3, C, C), np.float32),
                w2=np.zeros((3, 3, C, C), np.float32), g1_scale=np.ones(C, np.float32),
                g1_bias=np.zeros(C, np.float32), g2_scale=np.ones(C, np.float32),
                g2_bias=np.zeros(C, np.float32), w_out=np.zeros((1, 1, C, 1), np.float32),
                b_out=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="num_groups"):
        jdec1.fused_dec1_output(jnp.zeros((1, C, 16, 16)), jnp.zeros((1, C, 16, 16)),
                                num_groups=4, **args)
    targs = {k: _t(v) for k, v in args.items()}
    for device in ("cpu", "meta"):
        x = torch.zeros(1, 16, 16, C, device=device)
        with pytest.raises(ValueError, match="num_groups"):
            dec1.fused_dec1_output(x, x, num_groups=4, **targs)


@pytest.mark.parametrize("h,tile_h,want", [
    (512, 64, 64), (64, 16, 16), (48, 16, 16), (48, 48, 48),
    (48, 7, 48),    # not a divisor: one whole-image tile
    (40, 20, 40),   # a divisor but not a multiple of 8: one tile
    (20, 20, 20),   # the whole image is always a valid tile
    (32, 64, 32),
])
def test_effective_tile_h_follows_the_jax_fallback(h, tile_h, want):
    assert dec1.effective_tile_h(h, tile_h) == want


def test_dec1_on_production_activations_matches_jax_model():
    """The slice: the port's f32 LightweightUNet on best_model.onnx at 32x32;
    dec1's two inputs, caught by a forward pre-hook, go through
    fused_dec1_output (its plain version on the CPU) and give the JAX model's
    float32 output within the forward parity bound of
    tests/test_torch_port_slice.py."""
    import os

    onnx = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "deploy", "models", "best_model.onnx")
    x = np.random.default_rng(0).random((2, 32, 32, 1)).astype(np.float32)
    params = jax_reader(onnx)
    want = np.asarray(jax.jit(JaxUNet(pallas_gn=True, fused_blocks="auto").apply)(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)}, jnp.asarray(x)))
    model = load_lightweight_unet(onnx, dtype=torch.float32, device="cpu", kernels=True)
    caught = {}
    hook = model.dec1.register_forward_pre_hook(lambda _m, a: caught.__setitem__("dec1", a))
    try:
        with torch.inference_mode():
            tail = model(torch.from_numpy(x))
            got = dec1.fused_dec1_output(*caught["dec1"], **dec1.dec1_output_args(model))
    finally:
        hook.remove()
    assert got.shape == (2, 32, 32) and dec1.LAUNCHES["dec1_output"] == 0
    np.testing.assert_allclose(got.numpy(), want[..., 0], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), tail.numpy()[..., 0], rtol=1e-3, atol=2e-4)


def test_dec1_slice_bench_runs_on_cpu(capsys):
    assert dec1_slice_bench.main(["--device", "cpu", "--batch", "1", "--size", "32"]) == 0
    out = capsys.readouterr().out
    assert "composition slice" in out and "K5 fused slice" in out
    assert "input transposes NHWC->NCHW: none" in out
    r = dec1_slice_bench.run(batch=1, size=32, device="cpu")
    assert r["device"] == "cpu" and r["finite"]
    # bf16 composition vs K5's rounding: within the bf16 bound of the tail
    assert 0 < r["max_abs_err"] < 0.1


def test_dec1_output_args_are_contiguous_float32():
    """The weights K5's wrapper hands the kernel as they are: float32 and
    contiguous (dec1's conv1 halves are copied once here, not in every
    call), so a call on the card launches the kernel's three kernels and no
    copy."""
    import os

    onnx = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "deploy", "models", "best_model.onnx")
    model = load_lightweight_unet(onnx, dtype=torch.bfloat16, device="cpu")
    args = dec1.dec1_output_args(model)
    assert args.pop("num_groups") == C
    for name, t in args.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), name
    np.testing.assert_array_equal(
        torch.cat([args["wa"], args["wb"]], dim=2).numpy(), model.dec1.conv1.detach().numpy())


def test_dec1_output_bench_needs_a_card():
    """tools/dec1_output_bench.py, run by path, fails without a CUDA device
    and prints no timing."""
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "image_enhancement_deglaring_tpu_torch", "tools",
                          "dec1_output_bench.py")
    out = subprocess.run([sys.executable, script], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1 and "no CUDA device" in out.stderr
    assert "device" not in out.stdout
