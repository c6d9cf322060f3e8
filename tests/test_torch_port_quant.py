"""int8 weights and int8 activations of the port against the JAX package,
on the CPU.

- ``quantize_params_int8`` (per tensor and per output channel) and
  ``dequantize_params_int8``: int8 values, scales and widened weights
  equal to JAX's bit for bit on seeded trees of all three families (width
  4; LightweightUNet at 8), the up-conv axis rule and OptimizedUNet's HWIO
  ``upconvN/conv`` included.
- ``fake_quant_act_int8``: equal to JAX's bit for bit in float32, within
  one bfloat16 ulp in bfloat16 (both round once from the same float32
  product; XLA's CPU bf16 convert and torch's may differ on a tie).
- ``scales_from_act_stats``, ``merge_act_stats`` and ``subset_act_scales``
  on the same statistics: equal. ``calibrate_act_scales`` end to end on a
  LightweightUNet at features 8, 32x32: rtol 1e-6 + atol 1e-7 on the
  scales. The activations it takes maxima of are the float32 forwards of
  two packages, which agree to ~3e-6 here (conv summation order); a scale
  is max|x| * 1.05 / 127, so 1e-7 is 1.2e-5 of activation, the 2e-5 bound
  of ``tests/test_torch_import.py`` for the two float32 forwards.
- The ``act_scales`` forward, every site and ``HOT_SITES_512``, on JAX's
  scales, in lockstep with JAX's (each site's activation within 1e-5, the
  int8 codes equal but at rounding ties, the output within 1e-5; see the
  test); ``act_scales=None`` and the "calib" mode leave the forward bit
  for bit as it was; ``remat`` with ``act_scales`` raises; the quantized
  forward's SNR >= 20 dB (JAX's gate).
- ``InferenceEngine(quantize="int8")`` in float32: within one uint8 level
  of JAX's int8 engine (the f32 engines' gate,
  ``tests/test_torch_port_serve.py``); >= 45 dB against the unquantized
  engine on deploy/models/best_model.onnx at 128x128 (JAX's gate,
  ``tests/test_serve.py``); its quantized leaves int8; ``reload_params``
  quantizes again; other modes raise ValueError; ``create_server`` reports
  the mode in ``model_info``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.models import calibrate_act_scales as jax_calibrate
from image_enhancement_deglaring_tpu.models.model_utils import (
    dequantize_params_int8 as jax_dequantize,
)
from image_enhancement_deglaring_tpu.models.model_utils import quantize_params_int8 as jax_quantize
from image_enhancement_deglaring_tpu.ops import quant as jax_quant
from image_enhancement_deglaring_tpu.serve.engine import InferenceEngine as JaxEngine
from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
from image_enhancement_deglaring_tpu_torch.modelio import export_jax_params, load_jax_params
from image_enhancement_deglaring_tpu_torch.models import (
    LightweightUNet,
    calibrate_act_scales,
    dequantize_params_int8,
    quantize_params_int8,
)
from image_enhancement_deglaring_tpu_torch.ops import quant
from image_enhancement_deglaring_tpu_torch.serve import http_server
from image_enhancement_deglaring_tpu_torch.serve.engine import InferenceEngine
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from tests.torch_port_weights import seeded_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")
SIZE = 32
WIDTHS = {"lightweight": 8, "optimized": 4, "enhanced": 4}
ACT_ATOL = 1e-5
SCALE_RTOL, SCALE_ATOL = 1e-6, 1e-7
F32_LEVELS = 1
PSNR_GATE_DB = 45.0
SNR_GATE_DB = 20.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(jax.tree_util.tree_map(
        lambda a: np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy(), tree)).items()}


def _assert_equal_trees(got, want):
    g, w = _flat_np(got), _flat_np(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (k, g[k].dtype, w[k].dtype)
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _inputs(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 1)).astype(np.float32)


# ------------------------------------------------------------- quantizers


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("arch", ["lightweight", "optimized", "enhanced"])
def test_quantize_and_dequantize_equal_jax(arch, per_channel):
    params, _ = seeded_tree(arch, 0, WIDTHS[arch])
    jq, js = jax_quantize(params, per_channel=per_channel)
    q, s = quantize_params_int8(params, per_channel=per_channel)
    _assert_equal_trees(q, jq)
    _assert_equal_trees(s, js)
    int8 = [k for k, v in _flat_np(q).items() if v.dtype == np.int8]
    assert len(int8) == sum(np.ndim(v) >= 2 for v in _flat_np(params).values()) > 0
    _assert_equal_trees(dequantize_params_int8(q, s), jax_dequantize(jq, js))


def test_per_channel_axis_rule_upconv_and_optimized_hwio():
    """The ConvTranspose weights (Cin, Cout, 2, 2) under ``upconv`` take one
    scale per Cout (axis 1); OptimizedUNet's ``upconvN/conv`` is an HWIO
    kernel and keeps the last axis."""
    params, _ = seeded_tree("lightweight", 1, 8)
    _, s = quantize_params_int8(params, per_channel=True)
    cin, cout = params["upconv4"]["weight"].shape[:2]
    assert tuple(s["upconv4"]["weight"].shape) == (1, cout, 1, 1)
    assert tuple(s["enc1"]["conv1"].shape) == (1, 1, 1, 8)
    assert float(s["enc1"]["gn1_scale"]) == 1.0
    opt, _ = seeded_tree("optimized", 1, 4)
    _, s = quantize_params_int8(opt, per_channel=True)
    f = opt["upconv4"]["conv"].shape[-1]
    assert tuple(s["upconv4"]["conv"].shape) == (1, 1, 1, f)


# ------------------------------------------------------------ fake quant


def test_fake_quant_equals_jax_f32_and_bf16_within_one_ulp():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    # scales from the maximum, a tighter one that clips, and ties at .5
    scale = (np.abs(x).max(axis=(0, 1, 2)) / 127.0 * rng.uniform(0.5, 1.2, 16)).astype(np.float32)
    x[0, 0, 0] = (np.arange(16) - 7.5) * scale  # exact half steps
    got = quant.fake_quant_act_int8(torch.from_numpy(x), torch.from_numpy(scale))
    want = np.asarray(jax_quant.fake_quant_act_int8(jnp.asarray(x), jnp.asarray(scale)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)

    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = quant.fake_quant_act_int8(xb, torch.from_numpy(scale))
    want = jax_quant.fake_quant_act_int8(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                         jnp.asarray(scale))
    assert got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert (np.abs(g - w) <= ulp).all()


def test_fake_quant_error_bound_and_clip():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32))
    scale = x.abs().amax(dim=(0, 1, 2)) / 127.0
    err = (quant.fake_quant_act_int8(x, scale) - x).abs()
    assert bool((err <= scale * 0.5 + 1e-7).all())
    y = quant.fake_quant_act_int8(torch.tensor([[[[10.0, -10.0]]]]), torch.tensor([0.01, 0.01]))
    np.testing.assert_allclose(y.numpy(), [[[[1.27, -1.27]]]], rtol=1e-5)


def test_scale_helpers_equal_jax():
    rng = np.random.default_rng(7)
    tree = {"enc1": {"a1": rng.random(8, np.float32), "a2": rng.random(8, np.float32)},
            "p1": rng.random(8, np.float32), "u1": rng.random(8, np.float32)}
    other = jax.tree_util.tree_map(lambda a: rng.random(a.shape, np.float32), tree)
    as_t = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)  # noqa: E731
    merged = quant.merge_act_stats(as_t(tree), as_t(other))
    _assert_equal_trees(merged, jax_quant.merge_act_stats(tree, other))
    assert quant.merge_act_stats(None, merged) is merged
    for margin in (1.0, 1.05):
        _assert_equal_trees(quant.scales_from_act_stats(merged, margin=margin),
                            jax_quant.scales_from_act_stats(_flat_tree(merged), margin=margin))
    assert quant.HOT_SITES_512 == jax_quant.HOT_SITES_512
    assert quant.subset_act_scales(tree, ("enc1", "u1")).keys() == {"enc1", "u1"}


def _flat_tree(tree):
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


# ---------------------------------------------- calibration and act_scales


@pytest.fixture(scope="module")
def unet():
    """(JAX model, its params as numpy, the port's model on them), features 8."""
    jm = JaxUNet(features_start=8)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))["params"])
    model = LightweightUNet(features_start=8, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params)
    return jm, params, model.eval()


@pytest.fixture(scope="module")
def calibrated(unet):
    jm, params, model = unet
    batches = [_inputs(2, 1), _inputs(2, 11)]
    return jax_calibrate(jm, params, batches), calibrate_act_scales(model, batches)


def test_calibration_matches_jax(calibrated):
    want, got = (_flat_np(t) for t in calibrated)
    blocks = {"enc1", "enc2", "enc3", "enc4", "bottleneck", "dec4", "dec3", "dec2", "dec1"}
    assert set(calibrated[1]) == blocks | {"p1", "p2", "p3", "p4", "u4", "u3", "u2", "u1"}
    assert got.keys() == want.keys() and len(got) == 26
    worst = max(float(np.max(np.abs(got[k] - want[k]) / want[k])) for k in want)
    print(f"calibrate_act_scales: largest relative difference {worst:.3g}")
    for k in want:
        assert got[k].shape == want[k].shape and (got[k] > 0).all()
        np.testing.assert_allclose(got[k], want[k], rtol=SCALE_RTOL, atol=SCALE_ATOL, err_msg=k)


@pytest.mark.parametrize("sites", ["all", "hot"])
def test_act_scales_forward_matches_jax(unet, calibrated, sites, monkeypatch):
    """The port's quantized forward in lockstep with JAX's (eager): at each
    site the port quantizes its own activation, which must be within 1e-5
    of JAX's, then goes on from JAX's quantized tensor. Their int8 codes
    must agree wherever the activation is farther from a rounding tie
    (x / s at k + 0.5) than the two activations are apart; a value that
    close may round either way (one step), and one such flip moves the
    output by up to ~5e-2 here, far beyond any float32 summation order.
    The output then agrees within 1e-5."""
    from image_enhancement_deglaring_tpu_torch.models import unet as port_unet

    jm, params, model = unet
    scales = calibrated[0]
    if sites == "hot":
        scales = jax_quant.subset_act_scales(scales, jax_quant.HOT_SITES_512)
    x = _inputs(2, 2)

    jax_sites = []
    jax_fq = jax_quant.fake_quant_act_int8

    def record_jax(t, scale):
        y = jax_fq(t, scale)
        jax_sites.append((np.asarray(t), np.asarray(scale), np.asarray(y)))
        return y

    monkeypatch.setattr(jax_quant, "fake_quant_act_int8", record_jax)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), act_scales=scales))
    monkeypatch.undo()

    port_sites = []

    def lockstep(t, scale):
        port_sites.append((t.numpy().copy(), quant.fake_quant_act_int8(t, scale).numpy()))
        return torch.from_numpy(jax_sites[len(port_sites) - 1][2].copy())

    monkeypatch.setattr(port_unet, "fake_quant_act_int8", lockstep)
    with torch.no_grad():
        got = model(torch.from_numpy(x), act_scales=jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.asarray(a)), scales)).numpy()
    assert len(port_sites) == len(jax_sites) == len(_flat_np(scales))
    flips = 0
    for (xj, s, yj), (xp, yp) in zip(jax_sites, port_sites):
        assert np.abs(xp - xj).max() <= ACT_ATOL
        band = np.abs(xp - xj).max(axis=(0, 1, 2)) / s
        r = xj / s
        near_tie = np.abs(r - np.floor(r) - 0.5) <= band
        moved = yp != yj
        assert not (moved & ~near_tie).any()
        assert (np.abs(np.rint(yp / s) - np.rint(yj / s))[moved] == 1).all()
        flips += int(moved.sum())
    err = float(np.abs(got - want).max())
    print(f"act_scales forward ({sites} sites, {len(jax_sites)}): max |port - jax| {err:.3g} in "
          f"lockstep; {flips} int8 codes one step apart at rounding ties")
    assert err <= ACT_ATOL


def test_act_scales_forward_snr(unet, calibrated):
    """All 26 sites quantized: the output stays within 20 dB SNR of the
    exact forward (JAX's gate, ``tests/test_quant_act.py``)."""
    _, _, model = unet
    x = torch.from_numpy(_inputs(2, 3))
    with torch.no_grad():
        exact = model(x)
        got = model(x, act_scales=calibrated[1])
    snr = 10 * np.log10(float(exact.square().mean() / (got - exact).square().mean()))
    print(f"act_scales forward, all sites: SNR {snr:.2f} dB against the exact forward")
    assert snr >= SNR_GATE_DB


def test_act_scales_none_and_calib_leave_the_forward_unchanged(unet):
    _, _, model = unet
    x = torch.from_numpy(_inputs(1, 4))
    with torch.no_grad():
        a = model(x)
        b = model(x, act_scales=None)
        c, stats = model(x, act_scales="calib")
    assert torch.equal(a, b) and torch.equal(a, c)
    assert set(stats["enc1"]) == {"a1", "a2"} and stats["u1"].shape == (8,)


def test_remat_with_act_scales_raises():
    model = LightweightUNet(features_start=4, remat=True)
    with pytest.raises(ValueError, match="remat"):
        model(torch.zeros(1, 16, 16, 1), act_scales="calib")


# ------------------------------------------------------------ int8 engine


def test_int8_engine_matches_jax_int8_engine(unet):
    jm, params, model = unet
    kw = dict(image_size=SIZE, max_batch_size=4, warmup=False, quantize="int8")
    jax_engine = JaxEngine(jm.apply, params, compute_dtype=jnp.float32, **kw)
    engine = InferenceEngine(model, compute_dtype=torch.float32, device="cpu", **kw)
    leaves = _flat_np(engine._int8[1])
    assert leaves["enc1/conv1"].dtype == np.int8 and leaves["upconv4/weight"].dtype == np.int8
    _assert_equal_trees(engine._int8[1], jax_engine._params["q"])
    x = (np.random.default_rng(8).random((4, SIZE, SIZE)) * 255).astype(np.uint8)
    diff = np.abs(engine.infer_batch(x).astype(int) - jax_engine.infer_batch(x).astype(int))
    print(f"int8 engines f32: max |port - jax| {diff.max()} levels, {int((diff > 0).sum())} "
          f"of {diff.size} pixels differ")
    assert diff.max() <= F32_LEVELS


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) / 255 - b.astype(np.float64) / 255) ** 2)
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


def test_int8_engine_fidelity_on_production_weights_and_reload():
    model, params = load_model_for_eval(ONNX, device="cpu")
    kw = dict(image_size=128, max_batch_size=2, compute_dtype=torch.float32, warmup=False,
              device="cpu")
    f32 = InferenceEngine(model, **kw)
    q8 = InferenceEngine(model, quantize="int8", **kw)
    x = (np.random.default_rng(9).random((2, 128, 128)) * 255).astype(np.uint8)
    want = f32.infer_batch(x)
    psnr = _psnr(q8.infer_batch(x), want)
    print(f"int8 engine on best_model.onnx at 128x128: {psnr:.2f} dB against f32")
    assert psnr >= PSNR_GATE_DB

    # reload_params quantizes the new weights: halving every kernel halves
    # every int8 scale, and the answers follow the new weights
    halved = jax.tree_util.tree_map(lambda a: a * np.float32(0.5) if a.ndim >= 2 else a, params)
    old_scales = _flat_np(q8._int8[2])
    q8.reload_params(halved)
    new_scales = _flat_np(q8._int8[2])
    for k, v in new_scales.items():
        if v.size > 1:
            np.testing.assert_array_equal(v, old_scales[k] * np.float32(0.5), err_msg=k)
    np.testing.assert_array_equal(export_jax_params(q8._model)["enc1"]["conv1"],
                                  halved["enc1"]["conv1"])
    fresh = InferenceEngine(q8._model, quantize="int8", **kw)
    np.testing.assert_array_equal(q8.infer_batch(x), fresh.infer_batch(x))
    assert _psnr(q8.infer_batch(x), want) < PSNR_GATE_DB


def test_engine_refuses_other_quantize_modes():
    with pytest.raises(ValueError, match="int4"):
        InferenceEngine(LightweightUNet(features_start=4), quantize="int4", device="cpu",
                        warmup=False)


def test_create_server_int8_reports_it_and_tiles_unquantized():
    server = http_server.create_server(ONNX, quantize="int8", device="cpu", warmup=False,
                                       image_size=SIZE, mode="both", tile_overlap=8,
                                       compute_dtype=torch.float32)
    assert server.model_info["quantize"] == "int8"
    assert server.engine.quantize == "int8"
    assert server.tiler.model is server.engine._model
    assert all(p.dtype == torch.float32 for p in server.tiler.model.parameters())
    plain = http_server.create_server(ONNX, device="cpu", warmup=False, image_size=SIZE,
                                      compute_dtype=torch.float32)
    assert plain.model_info["quantize"] == "none" and plain.engine._int8 is None
