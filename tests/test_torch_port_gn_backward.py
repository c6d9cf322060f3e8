"""The differentiable GroupNorm+SiLU (``fused_kernels.gn_silu_train``) on CPU
tensors, where it runs the training pair's plain versions: gradcheck in
float64, its gradients against ``jax.grad`` of the JAX package's
GroupNorm+SiLU composition, the statistics it saves against float64, and
how a model's GroupNorm+SiLU call routes under autograd. The CUDA kernels
are held against the composition on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.ops import conv_blocks as jcb
from image_enhancement_deglaring_tpu_torch.ops import conv_blocks as cb
from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

# (N, H, W, C, groups): per-channel groups as at 8 channels and 8 groups,
# two channels a group, and the bottleneck's 128 channels in 8 groups
SHAPES = [(2, 8, 8, 8, 8), (2, 6, 10, 16, 8), (1, 4, 4, 128, 8)]


def _inputs(rng, n, h, w, c):
    x = (rng.standard_normal((n, h, w, c)) * 2 + 0.5).astype(np.float32)
    s = (rng.standard_normal(c) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(c) * 0.5).astype(np.float32)
    dy = rng.standard_normal((n, h, w, c)).astype(np.float32)
    return x, s, b, dy


def _port_grads(x, s, b, dy, groups, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st, bt = torch.from_numpy(s).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = fk.gn_silu_train(xt, st, bt, num_groups=groups)
    assert type(y.grad_fn).__name__ == "_GnSiluTrainBackward"
    grads = torch.autograd.grad(y, (xt, st, bt), torch.from_numpy(dy).to(dtype))
    assert grads[0].dtype == dtype and grads[1].dtype == grads[2].dtype == torch.float32
    return [g.float().numpy() for g in grads]


def _jax_grads(x, s, b, dy, groups, dtype):
    def f(x, s, b):
        return jcb.silu(jcb.group_norm(x, s, b, num_groups=groups))

    _, vjp = jax.vjp(f, jnp.asarray(x).astype(dtype), jnp.asarray(s), jnp.asarray(b))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy).astype(dtype))]


def _rel_max(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n,h,w,c,groups", SHAPES)
def test_gn_silu_train_gradcheck_float64(n, h, w, c, groups):
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(n, h, w, c, generator=g, dtype=torch.float64) * 2 + 0.5).requires_grad_()
    s = (torch.randn(c, generator=g, dtype=torch.float64) * 0.5 + 1).requires_grad_()
    b = (torch.randn(c, generator=g, dtype=torch.float64) * 0.5).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, s, b: fk.gn_silu_train(x, s, b, num_groups=groups), (x, s, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,groups", SHAPES)
def test_gn_silu_train_grads_match_jax(rng, n, h, w, c, groups, dtype):
    """dx, dgamma and dbeta against ``jax.vjp`` of the JAX composition on the
    same inputs. In bf16 the composition rounds the normalized value and
    its SiLU to bf16 and differentiates in bf16, while the pair keeps
    float32 inside and rounds dx once: both lie within about a bf16 step of
    the float32 gradients, the pair the closer."""
    x, s, b, dy = _inputs(rng, n, h, w, c)
    if dtype == "bfloat16":  # both sides read the same bf16 values
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        dy = np.array(jnp.asarray(dy).astype(jnp.bfloat16).astype(jnp.float32))
    port = _port_grads(x, s, b, dy, groups, getattr(torch, dtype))
    want = _jax_grads(x, s, b, dy, groups, getattr(jnp, dtype))
    if dtype == "float32":
        for got, ref in zip(port, want):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
        return
    truth = _jax_grads(x, s, b, dy, groups, jnp.float32)
    for got, ref, exact in zip(port, want, truth):
        assert _rel_max(got, ref) < 0.03
        assert _rel_max(got, exact) <= max(_rel_max(ref, exact), 0.004)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,groups", SHAPES)
def test_gn_silu_train_saved_stats_match_float64(rng, n, h, w, c, groups, dtype):
    """The saved (mean, rstd) per (image, group) against float64 statistics
    of the same input, and the forward's output against the float64
    function rounded once."""
    x, s, b, _ = _inputs(rng, n, h, w, c)
    xt = torch.from_numpy(x).to(dtype)
    out, stats = fk.gn_silu_train_fwd(xt, torch.from_numpy(s), torch.from_numpy(b),
                                      num_groups=groups)
    assert stats.shape == (n, groups, 2) and stats.dtype == torch.float32
    x64 = xt.double().reshape(n, h * w, groups, c // groups)
    mean = x64.mean(dim=(1, 3))
    rstd = torch.rsqrt(x64.var(dim=(1, 3), correction=0) + 1e-5)
    torch.testing.assert_close(stats[..., 0].double(), mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(stats[..., 1].double(), rstd, rtol=1e-6, atol=0)
    want = cb.silu(cb.group_norm(xt.double(), torch.from_numpy(s).double(),
                                 torch.from_numpy(b).double(), num_groups=groups))
    torch.testing.assert_close(out, want.to(dtype), rtol=2e-6 if dtype == torch.float32 else 0,
                               atol=2e-6 if dtype == torch.float32 else 0.01)


@pytest.fixture
def calls(monkeypatch):
    """Records which implementation each GroupNorm+SiLU call reached."""
    seen = []
    train, flat = fk.gn_silu_train, fk.gn_silu_flat
    monkeypatch.setattr(fk, "gn_silu_train",
                        lambda *a, **k: seen.append("train") or train(*a, **k))
    monkeypatch.setattr(fk, "gn_silu_flat", lambda *a, **k: seen.append("K1") or flat(*a, **k))
    fk.reset_launch_counts()
    return seen


def _call(shape, groups, kernels, requires_grad=True, dtype=torch.float32):
    c = shape[-1]
    x = torch.randn(shape, dtype=dtype).requires_grad_(requires_grad)
    s, b = torch.ones(c, requires_grad=requires_grad), torch.zeros(c)
    return cb._gn_silu_fn(groups, 1e-5, kernels)(x, s, b)


@pytest.mark.parametrize("kernels", [False, True])
def test_grad_mode_on_a_device_tensor_takes_the_training_pair(monkeypatch, calls, kernels):
    """``_routes_to_kernels`` patched, a CPU tensor stands for a device one."""
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    out = _call((2, 16, 16, 8), 8, kernels)
    assert calls == ["train"] and type(out.grad_fn).__name__ == "_GnSiluTrainBackward"
    assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 0}


@pytest.mark.parametrize("kernels,route", [(True, ["K1"]), (False, [])])
def test_grad_off_routes_as_before(monkeypatch, calls, kernels, route):
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    with torch.no_grad():
        _call((2, 16, 16, 8), 8, kernels)
    _call((2, 16, 16, 8), 8, kernels, requires_grad=False)  # grad mode, nothing to train
    assert calls == route * 2
    assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 0}


@pytest.mark.parametrize("kernels", [False, True])
def test_vmap_takes_the_composition_and_counts(monkeypatch, calls, kernels):
    """Under ``torch.func.vmap`` with per-trial gamma and beta, as the sweep's
    trial groups run: the composition, one fallback per call, and the
    gradients reach every trial's parameters."""
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    fn = cb._gn_silu_fn(8, 1e-5, kernels)
    x = torch.randn(3, 2, 8, 8, 16)
    s = (torch.rand(3, 16) + 0.5).requires_grad_()
    b = torch.randn(3, 16, requires_grad=True)
    out = torch.func.vmap(fn)(x, s, b)
    want = torch.stack([cb.silu(cb.group_norm(x[k], s[k], b[k], num_groups=8))
                        for k in range(3)])
    torch.testing.assert_close(out, want)
    out.square().sum().backward()
    assert s.grad.abs().sum() > 0 and b.grad.abs().sum() > 0
    assert calls == [] and fk.TRAIN_FALLBACKS == {"transform": 1, "shape": 0}


@pytest.mark.parametrize("shape,groups,dtype", [((1, 2, 2, 2048), 8, torch.float32),
                                                ((1, 4, 4, 16), 8, torch.float64)])
def test_unsupported_shapes_take_the_composition_and_count(monkeypatch, calls, shape, groups,
                                                           dtype):
    """More channels than a block's threads, or a dtype the kernels do not
    take: the composition, counted as a shape fallback."""
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    out = _call(shape, groups, False, dtype=dtype)
    assert calls == [] and type(out.grad_fn).__name__ != "_GnSiluTrainBackward"
    assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 1}


@pytest.mark.parametrize("kernels", [False, True])
def test_cpu_default_stays_the_composition(calls, kernels):
    """Without the patch a CPU tensor keeps the composition under autograd,
    so the JAX-parity tests of the models and the trainer run what they ran."""
    out = _call((2, 16, 16, 8), 8, kernels)
    assert calls == [] and type(out.grad_fn).__name__ != "_GnSiluTrainBackward"
    assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 0}
    assert not any(fk.LAUNCHES.values())


def test_training_pair_on_cpu_launches_nothing(rng):
    fk.reset_launch_counts()
    x, s, b, dy = _inputs(rng, 1, 8, 8, 16)
    _port_grads(x, s, b, dy, 8, torch.float32)
    assert fk.LAUNCHES["gn_silu_train_fwd"] == fk.LAUNCHES["gn_silu_train_bwd"] == 0


@pytest.mark.parametrize("name", ["gn_silu_train_fwd", "gn_silu_train_bwd"])
def test_training_pair_refuses_devices_other_than_cpu_and_cuda(name):
    x = torch.empty(1, 8, 16, 8, device="meta")
    s, b = torch.ones(8), torch.zeros(8)
    args = (x, s, b) if name.endswith("fwd") else (x, x, s, b, torch.zeros(1, 8, 2))
    with pytest.raises(ValueError, match="meta"):
        getattr(fk, name)(*args, num_groups=8)


def test_model_gradients_through_the_pair_match_the_composition(monkeypatch):
    """LightweightUNet's first-step gradients with every GroupNorm+SiLU site
    routed to the training pair (its plain versions here) against the
    composition's, float32."""
    from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
    from image_enhancement_deglaring_tpu_torch.ops.metrics import l1_loss

    gen = torch.Generator().manual_seed(3)
    x, y = torch.rand(2, 32, 32, 1, generator=gen), torch.rand(2, 32, 32, 1, generator=gen)
    grads = []
    for routed in (False, True):
        model = LightweightUNet(generator=torch.Generator().manual_seed(5))
        with monkeypatch.context() as m:
            if routed:
                m.setattr(fk, "_routes_to_kernels", lambda t: True)
            fk.reset_launch_counts()
            l1_loss(model(x), y).backward()
            assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 0}
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, want in grads[0].items():
        torch.testing.assert_close(grads[1][k], want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
