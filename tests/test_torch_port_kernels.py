"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode, at the
tolerances of tests/test_pallas.py; plus the dispatch rules (images_per_step
included), the forced-call errors and the launch counters. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from image_enhancement_deglaring_tpu.ops import pallas_kernels as jpk
from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk


def _gn_inputs(rng, shape):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    return x, rng.standard_normal(c).astype(np.float32), rng.standard_normal(c).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,groups", [
    ((2, 16, 16, 8), 8),   # enc1 geometry: W*C lane-aligned at low C
    ((1, 8, 8, 64), 8),    # dec4 geometry
    ((2, 8, 16, 8), 4),
    ((1, 8, 32, 4), 4),    # C % 8 != 0, W*C = 128: the kernel's element-by-element plan
])
def test_gn_silu_flat_matches_pallas_flat(rng, shape, groups):
    x, s, b = _gn_inputs(rng, shape)
    n, h, w, c = shape
    want = jpk._fused_gn_silu_flat(jnp.asarray(x).reshape(n, h, w * c), jnp.asarray(s),
                                   jnp.asarray(b), w=w, num_groups=groups, eps=1e-5,
                                   tile_h=jpk._pick_tile_h(h, w * c), interpret=True)
    got = fk.gn_silu_flat(_t(x), _t(s), _t(b), num_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(shape),
                               rtol=1e-5, atol=1e-5)


def test_gn_silu_flat_bf16_matches_pallas_flat(rng):
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jpk._fused_gn_silu_flat(xb.reshape(2, 16, 128), jnp.ones(8), jnp.zeros(8), w=16,
                                   num_groups=8, eps=1e-5, tile_h=16, interpret=True)
    got = fk.gn_silu_flat(_t(x).bfloat16(), torch.ones(8), torch.zeros(8), num_groups=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)).reshape(x.shape), atol=0.06)


@pytest.mark.parametrize("shape,groups", [
    ((2, 4, 4, 64), 8),    # dec4 of a 32x32 image: h < 8, the NHWC path
    ((1, 6, 6, 64), 8),
    ((3, 4, 4, 16), 4),
])
def test_gn_silu_nhwc_matches_pallas_nhwc(rng, shape, groups):
    x, s, b = _gn_inputs(rng, shape)
    want = jpk._fused_gn_silu_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                     num_groups=groups, eps=1e-5, interpret=True)
    got = fk.gn_silu_nhwc(_t(x), _t(s), _t(b), num_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,cout,groups", [
    ((2, 8, 8, 16), 32, 8),
    ((1, 8, 8, 32), 64, 8),    # enc4 conv1 geometry, narrowed
    ((3, 4, 4, 8), 8, 8),
])
def test_conv3x3_gn_silu_matches_pallas_conv(rng, shape, cout, groups):
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.1
    s = rng.standard_normal(cout).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = jpk._fused_conv_gn_silu_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                          jnp.asarray(b), num_groups=groups, eps=1e-5,
                                          interpret=True)
    got = fk.conv3x3_gn_silu(_t(x), _t(w), _t(s), _t(b), num_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_conv3x3_gn_silu_bf16_rounds_weights_like_pallas_conv(rng):
    """In bfloat16 the TPU kernel rounds the float32 weights to bfloat16
    before the conv; the plain version computes the same function."""
    x = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    w = rng.standard_normal((3, 3, 32, 64)).astype(np.float32) * 0.1
    s = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jpk._fused_conv_gn_silu_pallas(xb, jnp.asarray(w), jnp.asarray(s), jnp.asarray(b),
                                          num_groups=8, eps=1e-5, interpret=True)
    got = fk.conv3x3_gn_silu(_t(x).bfloat16(), _t(w), _t(s), _t(b), num_groups=8)
    rounded = fk.conv3x3_gn_silu(_t(x).bfloat16(), _t(w).bfloat16().float(), _t(s), _t(b),
                                 num_groups=8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, rounded)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=0.06)


@pytest.mark.parametrize("images", [2, 4])
def test_conv3x3_gn_silu_batched_matches_pallas_batched(rng, images):
    """K4 (K images per conv block) vs the TPU's batched-grid kernel in
    interpret mode, at tests/test_pallas.py's tolerance."""
    x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32) * 0.1
    s = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = jpk._fused_conv_gn_silu_batched(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                           jnp.asarray(b), num_groups=8, eps=1e-5,
                                           images=images, interpret=True)
    got = fk.conv3x3_gn_silu_batched(_t(x), _t(w), _t(s), _t(b), num_groups=8, images=images)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_conv3x3_gn_silu_batched_bf16_matches_pallas_batched(rng):
    """bfloat16: both round the weights to bf16 and the output once; the
    bound is that of the K3 bf16 test and of tests/test_pallas.py's bf16
    GroupNorm test (0.06, a few bf16 ulps of outputs up to ~4)."""
    x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32) * 0.1
    s = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = jpk._fused_conv_gn_silu_batched(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                                           jnp.asarray(s), jnp.asarray(b), num_groups=8,
                                           eps=1e-5, images=2, interpret=True)
    got = fk.conv3x3_gn_silu_batched(_t(x).bfloat16(), _t(w), _t(s), _t(b), num_groups=8,
                                     images=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=0.06)


@pytest.mark.parametrize("images_per_step", [None, 1, 2, 4])
def test_conv_dispatcher_images_per_step_matches_jax(rng, images_per_step):
    """The forced dispatchers with images_per_step: both packages give the
    same function (K3 for None or <= 1, K4 above)."""
    x = rng.standard_normal((4, 8, 8, 64)).astype(np.float32)
    w = rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.1
    s = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = jpk.fused_conv3x3_gn_silu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                     jnp.asarray(b), num_groups=8, use_pallas=True,
                                     images_per_step=images_per_step)
    got = fk.fused_conv3x3_gn_silu(_t(x), _t(w), _t(s), _t(b), num_groups=8, use_kernel=True,
                                   images_per_step=images_per_step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("images_per_step,route", [
    (None, "conv3x3_gn_silu"), (1, "conv3x3_gn_silu"), (0, "conv3x3_gn_silu"),
    (2, "conv3x3_gn_silu_batched"), (4, "conv3x3_gn_silu_batched")])
def test_conv_dispatcher_images_per_step_routes(monkeypatch, images_per_step, route):
    """On a device tensor (a meta tensor stands for one) the kernel the
    dispatcher picks; on a CPU tensor, as JAX off the TPU, no kernel."""
    calls = []
    for name in ("conv3x3_gn_silu", "conv3x3_gn_silu_batched"):
        monkeypatch.setattr(fk, name, lambda *a, _n=name, **k: calls.append((_n, k)))
    for device in ("meta", "cpu"):
        fk.fused_conv3x3_gn_silu(torch.zeros(4, 4, 4, 8, device=device),
                                 torch.zeros(3, 3, 8, 64, device=device),
                                 torch.ones(64, device=device), torch.zeros(64, device=device),
                                 num_groups=8, images_per_step=images_per_step)
    assert [c[0] for c in calls] == [route]
    if route == "conv3x3_gn_silu_batched":
        assert calls[0][1]["images"] == images_per_step


def test_conv_dispatcher_rejects_bad_images_per_step(rng):
    """batch % images_per_step != 0 raises in both packages, with the same
    word in the message; the K4 wrapper raises on its own too."""
    x = rng.standard_normal((3, 8, 8, 64)).astype(np.float32)
    w = rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.1
    with pytest.raises(ValueError, match="images_per_step"):
        jpk.fused_conv3x3_gn_silu(jnp.asarray(x), jnp.asarray(w), jnp.ones(64), jnp.zeros(64),
                                  num_groups=8, use_pallas=True, images_per_step=2)
    with pytest.raises(ValueError, match="images_per_step"):
        fk.fused_conv3x3_gn_silu(_t(x), _t(w), torch.ones(64), torch.zeros(64), num_groups=8,
                                 use_kernel=True, images_per_step=2)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="not divisible"):
            fk.conv3x3_gn_silu_batched(torch.zeros(3, 8, 8, 64, device=device), _t(w),
                                       torch.ones(64), torch.zeros(64), num_groups=8, images=2)


def test_conv_dispatcher_forced_rejects_bad_groups(rng):
    x = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    w = rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.1
    with pytest.raises(ValueError, match="num_groups"):
        jpk.fused_conv3x3_gn_silu(jnp.asarray(x), jnp.asarray(w), jnp.ones(64), jnp.zeros(64),
                                  num_groups=5, use_pallas=True)
    with pytest.raises(ValueError, match="num_groups"):
        fk.fused_conv3x3_gn_silu(_t(x), _t(w), torch.ones(64), torch.zeros(64),
                                 num_groups=5, use_kernel=True)


def test_gn_dispatcher_forced_rejects_ineligible_shape(rng):
    x = rng.standard_normal((1, 4, 4, 10)).astype(np.float32)
    with pytest.raises(ValueError, match="no Pallas"):
        jpk.fused_group_norm_silu(jnp.asarray(x), jnp.ones(10), jnp.zeros(10), num_groups=2,
                                  use_pallas=True)
    with pytest.raises(ValueError, match="no fused"):
        fk.fused_group_norm_silu(_t(x), torch.ones(10), torch.zeros(10), num_groups=2,
                                 use_kernel=True)


@pytest.mark.parametrize("shape,groups,route", [
    ((1, 8, 16, 8), 8, "gn_silu_flat"),
    ((2, 64, 64, 8), 8, "gn_silu_flat"),
    ((2, 4, 4, 64), 8, "gn_silu_nhwc"),
    ((1, 8, 5, 64), 8, "gn_silu_nhwc"),   # W*C = 320 is not lane-aligned
    ((1, 4, 4, 16), 8, "composition"),
])
def test_gn_dispatch_routes_like_jax(monkeypatch, shape, groups, route):
    """Same eligibility rules as the JAX dispatcher on the TPU, for a device
    tensor (a meta tensor stands for one); a CPU tensor takes the
    composition, as JAX's does off the TPU."""
    jx = jnp.zeros(shape)
    c = shape[-1]
    jax_route = ("gn_silu_flat" if jpk._flat_eligible(jx, groups)
                 else "gn_silu_nhwc" if c % groups == 0 and c >= 64 else "composition")
    assert jax_route == route
    calls = []
    for name in ("gn_silu_flat", "gn_silu_nhwc"):
        monkeypatch.setattr(fk, name, lambda *a, _n=name, **k: calls.append(_n) or a[0])
    for device in ("meta", "cpu"):
        fk.fused_group_norm_silu(torch.zeros(shape, device=device), torch.ones(c, device=device),
                                 torch.zeros(c, device=device), num_groups=groups)
    assert calls == ([] if route == "composition" else [route])


@pytest.mark.parametrize("cout,groups,fused", [(64, 8, True), (128, 8, True), (32, 8, False),
                                                (48, 8, False)])
def test_conv_dispatch_rule(monkeypatch, cout, groups, fused):
    """The JAX rule on a device tensor (meta stands for one); a CPU tensor
    takes the composition whatever Cout is, as JAX's does off the TPU."""
    calls = []
    monkeypatch.setattr(fk, "conv3x3_gn_silu", lambda *a, **k: calls.append(1))
    for device in ("meta", "cpu"):
        fk.fused_conv3x3_gn_silu(torch.zeros(1, 4, 4, 8, device=device),
                                 torch.zeros(3, 3, 8, cout, device=device),
                                 torch.ones(cout, device=device),
                                 torch.zeros(cout, device=device), num_groups=groups)
    assert calls == ([1] if fused else [])


def test_cpu_wrappers_leave_launch_counts_at_zero(rng):
    fk.reset_launch_counts()
    x, s, b = _gn_inputs(rng, (1, 8, 8, 64))
    fk.gn_silu_flat(_t(x), _t(s), _t(b), num_groups=8)
    fk.gn_silu_nhwc(_t(x), _t(s), _t(b), num_groups=8)
    fk.conv3x3_gn_silu(_t(x), torch.zeros(3, 3, 64, 64), _t(s), _t(b), num_groups=8)
    fk.conv3x3_gn_silu_batched(_t(x), torch.zeros(3, 3, 64, 64), _t(s), _t(b), num_groups=8,
                               images=1)
    assert fk.LAUNCHES == {"gn_silu_flat": 0, "gn_silu_nhwc": 0, "conv3x3_gn_silu": 0,
                           "conv3x3_gn_silu_batched": 0}


@pytest.mark.parametrize("name", ["gn_silu_flat", "gn_silu_nhwc", "conv3x3_gn_silu",
                                  "conv3x3_gn_silu_batched", "fused_dec1_output"])
def test_wrappers_raise_off_cpu_and_cuda(name):
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never computed by the plain version."""
    from image_enhancement_deglaring_tpu_torch.ops import dec1

    if name == "fused_dec1_output":
        x = torch.empty(1, 16, 16, 8, device="meta")
        w3, v = torch.zeros(3, 3, 8, 8), torch.zeros(8)
        with pytest.raises(ValueError, match="meta"):
            dec1.fused_dec1_output(x, x, w3, w3, w3, v, v, v, v, torch.zeros(1, 1, 8, 1),
                                   torch.zeros(1))
        return
    x = torch.empty(1, 8, 16, 64, device="meta")
    args = (x, torch.zeros(3, 3, 64, 64)) if name.startswith("conv") else (x,)
    kw = {"images": 1} if name == "conv3x3_gn_silu_batched" else {}
    with pytest.raises(ValueError, match="meta"):
        getattr(fk, name)(*args, torch.ones(64), torch.zeros(64), num_groups=8, **kw)
