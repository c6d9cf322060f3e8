"""EnhancedUNet's BatchNorm+ReLU training pair (``fused_kernels.bn_act_train``).

On the CPU it runs its plain versions: gradcheck in float64, its output
and gradients against autograd through the model's float32 composition
for each epilogue (none, ReLU, add+ReLU), one channel and 512, a bf16
input, the running statistics against flax's rule, the mesh's sums hook
with the batch split in two, and how a BatchNorm call routes. Eval mode
and the CPU keep the composition bit for bit.

Tests marked ``card`` hold the CUDA kernels against the plain versions at
the 47 sites' shapes and skip without a card. The file imports no JAX, so
they run on the card with
``python3 -m pytest tests/test_torch_port_bn_backward.py -m card --noconftest``.
"""

import pytest
import torch

from image_enhancement_deglaring_tpu_torch.models import enhanced_unet as eu
from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk

EPILOGUES = [None, "relu", "add_relu"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests are small, and the suite runs in workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda")


def _inputs(shape, dtype=torch.float32, seed=0, device="cpu", residual=False):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    s = torch.randn(c, generator=g) * 0.5 + 1
    b = torch.randn(c, generator=g) * 0.5
    r = torch.randn(shape, generator=g) if residual else None
    dy = torch.randn(shape, generator=g)
    return [None if t is None else t.to(device) for t in (x, s, b, r, dy)]


def _bn(c, s, b, device="cpu"):
    bn = eu.BatchNorm(c, device=device)
    with torch.no_grad():
        bn.scale.copy_(s)
        bn.bias.copy_(b)
    return bn


def _act(epilogue):
    return None if epilogue is None else "relu"


def _grads(fn, x, s, b, r, dy):
    """Output, dx, dgamma, dbeta (and dr) of ``fn(x, s, b, r)``."""
    x = x.detach().clone().requires_grad_()
    s, b = s.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    r = None if r is None else r.detach().clone().requires_grad_()
    y = fn(x, s, b, r)
    return (y,) + torch.autograd.grad(y, [x, s, b] + ([r] if r is not None else []), dy)


def _composition(epilogue, c):
    """The model's float32 composition (the CPU route) with parameters s, b."""
    def fn(x, s, b, r):
        bn = eu.BatchNorm(c)
        del bn.scale, bn.bias
        bn.scale, bn.bias = s, b
        return bn(x, True, act=_act(epilogue), residual=r)
    return fn


def _pair(epilogue, running=None):
    def fn(x, s, b, r):
        return fk.bn_act_train(x, s, b, act=_act(epilogue), residual=r, running=running)
    return fn


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_gradcheck_float64(epilogue):
    x, s, b, r, _ = _inputs((2, 3, 4, 5), torch.float64, seed=1, residual=epilogue == "add_relu")
    s, b = s.double(), b.double()
    r = None if r is None else r.double().requires_grad_()
    args = (x.requires_grad_(), s.requires_grad_(), b.requires_grad_())
    fn = _pair(epilogue)
    if r is None:
        assert torch.autograd.gradcheck(lambda x, s, b: fn(x, s, b, None), args)
    else:
        assert torch.autograd.gradcheck(fn, args + (r,))


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape,dtype", [((2, 6, 10, 16), torch.float32),
                                         ((4, 8, 8, 1), torch.float32),
                                         ((2, 3, 3, 512), torch.float32),
                                         ((2, 6, 10, 16), torch.bfloat16)])
def test_pair_matches_the_composition(epilogue, shape, dtype):
    """Output, dx, dgamma, dbeta and the residual's gradient of the pair's
    plain versions against autograd through the model's composition. A bf16
    input rounds dx to bf16 on both sides."""
    x, s, b, r, dy = _inputs(shape, dtype, seed=shape[-1], residual=epilogue == "add_relu")
    got = _grads(_pair(epilogue), x, s, b, r, dy)
    want = _grads(_composition(epilogue, shape[-1]), x, s, b, r, dy)
    assert got[0].dtype == torch.float32 and got[1].dtype == dtype
    for k, (g, w) in enumerate(zip(got, want)):
        tol = 1e-2 if (k == 1 and dtype == torch.bfloat16) else 2e-5
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=tol * float(w.float().abs().max()))


def test_running_statistics_follow_flax():
    """momentum * old + (1 - momentum) * batch, with the batch's biased
    variance, against float64 statistics; the same buffers as the
    composition's."""
    x, s, b, _, _ = _inputs((3, 5, 7, 8), seed=3)
    old = (torch.linspace(-1, 1, 8), torch.linspace(0.5, 2, 8))
    running = tuple(t.clone() for t in old)
    fk.bn_act_train(x, s, b, act="relu", running=running)
    x64 = x.double().reshape(-1, 8)
    want_mean = 0.9 * old[0].double() + 0.1 * x64.mean(0)
    want_var = 0.9 * old[1].double() + 0.1 * x64.var(0, correction=0)
    torch.testing.assert_close(running[0].double(), want_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(running[1].double(), want_var, rtol=1e-6, atol=1e-6)
    bn = _bn(8, s, b)
    bn.mean.copy_(old[0])
    bn.var.copy_(old[1])
    bn(x, True, act="relu")
    torch.testing.assert_close(running[0], bn.mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(running[1], bn.var, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_split_batch_through_the_sums_hook_equals_the_whole_batch(epilogue):
    """The mesh's hook with no second rank: each half's B1 and B3 sums plus
    the other half's, then B2 and B4, give the whole batch's output and dx
    on each half; dgamma and dbeta stay each half's own, and add up to the
    whole batch's."""
    x, s, b, r, dy = _inputs((4, 5, 6, 8), seed=4, residual=epilogue == "add_relu")
    act = _act(epilogue)
    out, stats = fk.bn_act_train_fwd_plain(x, s, b, act=act, residual=r)
    whole = fk.bn_act_train_bwd_plain(x, dy, s, b, stats, act=act,
                                      out=out if r is not None else None)
    halves = [slice(0, 2), slice(2, 4)]
    other = {"fwd": [fk.bn_sums_plain(x[h]) for h in halves]}
    parts = []
    for k, h in enumerate(halves):
        rh = None if r is None else r[h]
        o, st = fk.bn_act_train_fwd_plain(
            x[h], s, b, act=act, residual=rh, sums_hook=lambda t, k=k: (t + other["fwd"][1 - k], 2))
        torch.testing.assert_close(o, out[h], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(st, stats, rtol=1e-5, atol=1e-6)
        parts.append((h, o, st))
    oh = [o if r is not None else None for _, o, _ in parts]
    other["bwd"] = [fk.bn_bwd_sums_plain(x[h], dy[h], s, b, st, act=act, out=o)
                    for (h, _, st), o in zip(parts, oh)]
    dg = db = 0
    for k, ((h, o, st), ob) in enumerate(zip(parts, oh)):
        dx, dr, g, bb = fk.bn_act_train_bwd_plain(
            x[h], dy[h], s, b, st, act=act, out=ob,
            sums_hook=lambda t, k=k: (t + other["bwd"][1 - k], 2))
        torch.testing.assert_close(dx, whole[0][h], rtol=1e-4, atol=1e-5)
        if r is not None:
            torch.testing.assert_close(dr, whole[1][h])
        dg, db = dg + g, db + bb
    torch.testing.assert_close(dg, whole[2], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(db, whole[3], rtol=1e-5, atol=1e-4)


def test_apply_and_backward_apply_give_the_same_bits_from_the_same_sums():
    """B2 and B4 are explicitly rounded: from given sums and statistics the
    plain versions are a function of their inputs, as the kernels are."""
    x, s, b, r, dy = _inputs((2, 4, 4, 8), seed=5, residual=True)
    sums = fk.bn_sums_plain(x)
    a = fk.bn_apply_plain(x, sums, s, b, count=32, act="relu", residual=r)
    again = fk.bn_apply_plain(x.clone(), sums.clone(), s, b, count=32, act="relu", residual=r)
    assert all(torch.equal(p, q) for p, q in zip(a, again))
    out, stats = a
    mean, var, rstd = fk._bn_channel_stats(sums, 32, 1e-5, torch.float32)
    assert torch.equal(stats, torch.stack([mean, rstd], -1))
    bs = fk.bn_bwd_sums_plain(x, dy, s, b, stats, act="relu", out=out)
    dx, dr = fk.bn_bwd_apply_plain(x, dy, s, b, stats, bs, count=32, act="relu", out=out)
    torch.testing.assert_close(dr, torch.where(out > 0, dy, 0.0), rtol=0, atol=0)
    assert dx.dtype == x.dtype and dr.dtype == torch.float32


@pytest.mark.parametrize("bad", [dict(act="gelu"), dict(act=None, residual=True)])
def test_epilogue_arguments_are_checked(bad):
    x, s, b, r, _ = _inputs((1, 2, 2, 4), seed=6, residual=True)
    kw = dict(bad)
    if kw.pop("residual", False):
        kw["residual"] = r
    with pytest.raises(ValueError, match="epilogue|residual"):
        fk.bn_act_train(x, s, b, **kw)
    with pytest.raises(ValueError, match="epilogue"):
        _bn(4, s, b)(x, True, **kw)


# --------------------------------------------------------------- routing


@pytest.fixture
def calls(monkeypatch):
    """Records each call that reached the training pair."""
    seen = []
    pair = fk.bn_act_train
    monkeypatch.setattr(fk, "bn_act_train", lambda *a, **k: seen.append("pair") or pair(*a, **k))
    fk.reset_launch_counts()
    return seen


def _module_call(shape=(2, 4, 4, 8), dtype=torch.float32, epilogue="relu", requires_grad=True):
    x, s, b, r, _ = _inputs(shape, dtype, seed=7, residual=epilogue == "add_relu")
    bn = _bn(shape[-1], s, b).requires_grad_(requires_grad)
    return bn(x.requires_grad_(requires_grad), True, act=_act(epilogue), residual=r)


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_grad_mode_on_a_device_tensor_takes_the_pair(monkeypatch, calls, epilogue):
    """``_routes_to_kernels`` patched, a CPU tensor stands for a device one."""
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    out = _module_call(epilogue=epilogue)
    assert calls == ["pair"] and type(out.grad_fn).__name__ == "_BnActTrainBackward"
    assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 0}


def test_grad_off_and_nothing_to_train_keep_the_composition(monkeypatch, calls):
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    with torch.no_grad():
        _module_call()
    _module_call(requires_grad=False)
    assert calls == [] and fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 0}


def test_cpu_default_keeps_the_composition(calls):
    """Without the patch a CPU tensor keeps the composition under autograd,
    so the JAX-parity tests of the model and the trainer run what they ran."""
    out = _module_call()
    assert calls == [] and type(out.grad_fn).__name__ != "_BnActTrainBackward"
    assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 0}
    assert not any(fk.LAUNCHES.values())


def test_vmap_takes_the_composition_and_counts(monkeypatch, calls):
    """Under ``torch.func.vmap`` with per-trial gamma and beta, as the sweep's
    trial groups run: the composition, one fallback per call, and the
    gradients reach every trial's parameters."""
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    x = torch.randn(3, 2, 4, 4, 8)
    s = (torch.rand(3, 8) + 0.5).requires_grad_()
    b = torch.randn(3, 8, requires_grad=True)
    r = torch.randn(3, 2, 4, 4, 8)
    mean, var = torch.zeros(3, 8), torch.ones(3, 8)

    def fn(x, s, b, r, mean, var):
        bn = eu.BatchNorm(8)
        del bn.scale, bn.bias
        bn.scale, bn.bias, bn.mean, bn.var = s, b, mean, var
        return bn(x, True, act="relu", residual=r)

    out = torch.func.vmap(fn)(x, s, b, r, mean, var)
    out.square().sum().backward()
    assert s.grad.abs().sum() > 0 and b.grad.abs().sum() > 0
    assert calls == [] and fk.TRAIN_FALLBACKS == {"transform": 1, "shape": 0}
    assert (mean != 0).all() and (var != 1).all()  # each trial's statistics moved
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: False)
    want = torch.stack([_composition("add_relu", 8)(x[k], s[k], b[k], r[k]) for k in range(3)])
    torch.testing.assert_close(out, want)


@pytest.mark.parametrize("shape,dtype", [((1, 2, 2, 2048), torch.float32),
                                         ((1, 4, 4, 16), torch.float64)])
def test_unsupported_shapes_take_the_composition_and_count(monkeypatch, calls, shape, dtype):
    """More channels than the kernels take, or a dtype they do not take."""
    monkeypatch.setattr(fk, "_routes_to_kernels", lambda x: True)
    out = _module_call(shape, dtype)
    assert calls == [] and type(out.grad_fn).__name__ != "_BnActTrainBackward"
    assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 1}


def test_eval_and_the_cpu_keep_the_composition_bit_for_bit():
    """Eval mode, and training on the CPU, compute what the model computed
    before the epilogues moved into BatchNorm: the affine, then the sum
    with the residual and the ReLU as separate ops."""
    x, s, b, r, _ = _inputs((2, 4, 4, 8), seed=8, residual=True)
    bn = _bn(8, s, b)
    with torch.no_grad():
        bn.mean.copy_(torch.linspace(-0.5, 0.5, 8))
        bn.var.copy_(torch.linspace(0.5, 1.5, 8))
        y = (x.float() - bn.mean) * (torch.rsqrt(bn.var + bn.eps) * bn.scale) + bn.bias
        assert torch.equal(bn(x, False), y)
        assert torch.equal(bn(x, False, act="relu"), torch.relu(y))
        assert torch.equal(bn(x, False, act="relu", residual=r), torch.relu(y + r))
        assert torch.equal(bn(x, False, act="relu", residual=r), torch.relu(r + y))
        mean, var = x.float().mean((0, 1, 2)), x.float().var((0, 1, 2), correction=0)
    yt = bn(x, True, act="relu", residual=r)
    torch.testing.assert_close(
        yt, torch.relu((x - mean) * (torch.rsqrt(var + bn.eps) * s) + b + r), rtol=1e-5,
        atol=1e-5)


def test_model_gradients_through_the_pair_match_the_composition(monkeypatch):
    """EnhancedUNet's first-step loss, gradients and running statistics with
    every BatchNorm routed to the pair (its plain versions here) against the
    composition's, float32, the same dropout draws: the norm of all
    gradients' difference, each leaf's, and each running statistic's. Left
    out of the leaves: those whose gradient is nought but for rounding,
    since BatchNorm right after them cancels them (the attention gates' 1x1
    biases; enc1's 1x1 shortcut from one channel, whose output BatchNorm
    normalizes whatever its scale)."""
    from image_enhancement_deglaring_tpu_torch.models import EnhancedUNet
    from image_enhancement_deglaring_tpu_torch.ops.metrics import l1_loss

    gen = torch.Generator().manual_seed(3)
    x, y = torch.rand(4, 64, 64, 1, generator=gen), torch.rand(4, 64, 64, 1, generator=gen)
    runs = []
    for routed in (False, True):
        model = EnhancedUNet(init_features=4, generator=torch.Generator().manual_seed(5))
        with monkeypatch.context() as m:
            if routed:
                m.setattr(fk, "_routes_to_kernels", lambda t: True)
            fk.reset_launch_counts()
            loss = l1_loss(model(x, train=True, generator=torch.Generator().manual_seed(9)), y)
            loss.backward()
            assert fk.TRAIN_FALLBACKS == {"transform": 0, "shape": 0}
        runs.append((float(loss), {k: p.grad for k, p in model.named_parameters()},
                     dict(model.named_buffers())))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-6 * abs(runs[0][0])

    def gap(a, b):
        return float((a - b).norm() / b.norm())

    grads = runs[0][1]
    total = sum(float((runs[1][1][k] - g).norm()) ** 2 for k, g in grads.items())
    assert (total / sum(float(g.norm()) ** 2 for g in grads.values())) ** 0.5 < 1e-5
    nought = ("w_g_bias", "w_x_bias", "psi_bias", "enc1.shortcut_conv")
    for k, want in grads.items():
        if not k.endswith(nought):
            assert gap(runs[1][1][k], want) < 1e-4, k
    for k, want in runs[0][2].items():
        assert gap(runs[1][2][k], want) < 1e-5, k


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    x = torch.empty(1, 2, 2, 8, device="meta")
    s = torch.ones(8)
    with pytest.raises(ValueError, match="meta"):
        fk.bn_sums(x)
    with pytest.raises(ValueError, match="meta"):
        fk.bn_bwd_sums(x, x, s, s, torch.zeros(8, 2))


# ------------------------------------------------------------------ card


def _card_sites():
    """(side, channels, epilogue, input dtype) of the step's 47 sites."""
    sites = [(512, 16, "relu", torch.bfloat16), (512, 16, None, torch.bfloat16)]
    for level in range(5):
        side, w = 512 >> level, 16 << level
        sites += [(side, w, "relu", torch.float32), (side, w, None, torch.float32),
                  (side, w, "add_relu", torch.float32), (side, w // 2, None, torch.float32),
                  (side, w // 2, "add_relu", torch.float32), (side, 1, None, torch.float32)]
    return sites + [(16, 512, "relu", torch.float32)]


@pytest.mark.card
@pytest.mark.parametrize("side,c,epilogue,dtype", _card_sites())
def test_kernels_match_plain_at_the_sites(card, side, c, epilogue, dtype):
    """B1-B4 at a site's shape (batch 2) against their plain versions: B1
    and B3's sums to rounding, B2 and B4 bit for bit from the same sums;
    each launch twice bit for bit."""
    x, s, b, r, dy = _inputs((2, side, side, c), dtype, seed=c, device=card,
                             residual=epilogue == "add_relu")
    act, rows = _act(epilogue), 2 * side * side
    sums = fk.bn_sums(x)
    assert torch.equal(sums, fk.bn_sums(x))
    torch.testing.assert_close(sums, fk.bn_sums_plain(x), rtol=1e-5,
                               atol=1e-5 * float(sums.abs().max()))
    running = (torch.zeros(c, device=card), torch.ones(c, device=card))
    running_p = tuple(t.clone() for t in running)
    out, stats = fk.bn_apply(x, sums, s, b, count=rows, act=act, residual=r, running=running)
    out_p, stats_p = fk.bn_apply_plain(x, sums, s, b, count=rows, act=act, residual=r,
                                       running=running_p)
    assert torch.equal(out, out_p) and torch.equal(stats, stats_p)
    assert all(torch.equal(p, q) for p, q in zip(running, running_p))
    o = out if r is not None else None
    bs = fk.bn_bwd_sums(x, dy, s, b, stats, act=act, out=o)
    assert torch.equal(bs, fk.bn_bwd_sums(x, dy, s, b, stats, act=act, out=o))
    bs_p = fk.bn_bwd_sums_plain(x, dy, s, b, stats, act=act, out=o)
    torch.testing.assert_close(bs, bs_p, rtol=1e-4, atol=1e-5 * float(bs_p.abs().max()))
    dx, dr = fk.bn_bwd_apply(x, dy, s, b, stats, bs, count=rows, act=act, out=o)
    dx_p, dr_p = fk.bn_bwd_apply_plain(x, dy, s, b, stats, bs, count=rows, act=act, out=o)
    assert torch.equal(dx, dx_p) and (dr is None or torch.equal(dr, dr_p))


@pytest.mark.card
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_pair_on_the_card_twice_bit_for_bit(card, epilogue):
    """The differentiable pair twice on the same inputs: the same output,
    gradients and running statistics, bit for bit, launching B1-B4 once
    each per call."""
    x, s, b, r, dy = _inputs((4, 64, 64, 32), seed=11, device=card,
                             residual=epilogue == "add_relu")
    fk.reset_launch_counts()
    outs = []
    for _ in range(2):
        running = (torch.zeros(32, device=card), torch.ones(32, device=card))
        outs.append(_grads(_pair(epilogue, running), x, s, b, r, dy) + running)
    assert all(torch.equal(p, q) for p, q in zip(*outs))
    assert {k: fk.LAUNCHES[k] for k in ("bn_train_stats", "bn_train_apply", "bn_train_bwd_sums",
                                        "bn_train_bwd_apply")} == dict.fromkeys(
        ("bn_train_stats", "bn_train_apply", "bn_train_bwd_sums", "bn_train_bwd_apply"), 2)
