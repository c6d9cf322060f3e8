"""The port's OptimizedUNet and EnhancedUNet, their BatchNorm, importers,
evaluation loader and utilities, LightweightUNet's ``remat`` and the new
NHWC ops, against the JAX package on the CPU.

Weights come from a seeded JAX init carried over with ``load_jax_params``
(EnhancedUNet's ``batch_stats`` with them), or from an ``.onnx`` that the
JAX package's own writer writes here. Tolerances:

- f32 eval forwards: rtol 1e-3, atol 2e-4 (the JAX model tests' torch
  parity tolerance; read: <= 2e-6);
- BatchNorm in training, against ``flax.linen.BatchNorm(momentum=0.9)``:
  output, running mean and running variance rtol 1e-5, atol 1e-6 (read:
  <= 5e-7 absolute);
- one stateful EnhancedUNet step against JAX's, dropout out of the path in
  both: loss rel 1e-5, BatchNorm statistics rtol 1e-4 / atol 1e-6,
  parameters within 2 * lr with at most 1 % of the elements beyond 1e-5
  (Adam's first step moves a parameter by about lr * sign(g), so a
  gradient near 0 whose sign differs between the packages moves it by up
  to 2 * lr; the same rule as the trainer's tests);
- importers, pooling, upsampling, counting and pruning: equal.
"""

import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.cli import evaluate as jax_eval_cli
from image_enhancement_deglaring_tpu.eval import load_model_for_eval as jax_load_model_for_eval
from image_enhancement_deglaring_tpu.modelio import detect_model_arch as jax_detect_model_arch
from image_enhancement_deglaring_tpu.modelio import (
    enhanced_unet_params_from_onnx as jax_enhanced_from_onnx,
)
from image_enhancement_deglaring_tpu.modelio import (
    optimized_unet_params_from_onnx as jax_optimized_from_onnx,
)
from image_enhancement_deglaring_tpu.modelio.onnx_writer import (
    export_enhanced_unet,
    export_optimized_unet,
)
from image_enhancement_deglaring_tpu.models import EnhancedUNet as JaxEnhanced
from image_enhancement_deglaring_tpu.models import OptimizedUNet as JaxOptimized
from image_enhancement_deglaring_tpu.models import model_utils as jax_model_utils
from image_enhancement_deglaring_tpu.models import enhanced_unet as jax_enhanced_module
from image_enhancement_deglaring_tpu.ops import conv_blocks as jax_ops
from image_enhancement_deglaring_tpu.train.loop import TrainState as JaxState
from image_enhancement_deglaring_tpu.train.loop import make_optimizer as jax_optimizer
from image_enhancement_deglaring_tpu.train.loop import make_train_step as jax_train_step
from image_enhancement_deglaring_tpu_torch.cli import evaluate as eval_cli
from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1
from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
from image_enhancement_deglaring_tpu_torch.modelio import (
    detect_model_arch,
    enhanced_unet_params_from_onnx,
    export_jax_batch_stats,
    export_jax_params,
    load_jax_params,
    optimized_unet_params_from_onnx,
)
from image_enhancement_deglaring_tpu_torch.models import (
    BatchNorm,
    EnhancedUNet,
    LightweightUNet,
    OptimizedUNet,
    count_parameters,
    get_model_size_mb,
    prune_params,
)
from image_enhancement_deglaring_tpu_torch.ops import conv_blocks as ops
from image_enhancement_deglaring_tpu_torch.train import TrainState, make_optimizer, make_train_step
from image_enhancement_deglaring_tpu_torch.train.checkpoint import save_checkpoint
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from tests.test_torch_port_eval import _close_printed, _metric_lines

OPT_SIZE, ENH_SIZE = 32, 64  # 2^4 and 2^5 pixels: each family's smallest side
WIDTH = 4
LR, WD = 2e-3, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _stats(rng, tree):
    """Non-trivial running statistics of the shapes of ``tree``."""
    from image_enhancement_deglaring_tpu_torch.utils.pytree import unflatten_tree

    return unflatten_tree({
        k: (rng.random(v.shape) + 0.5 if k.endswith("var") else rng.normal(0, 0.1, v.shape))
        .astype(np.float32) for k, v in flatten_tree(tree).items()})


@pytest.fixture(scope="module")
def families():
    """{family: (jax model, params, batch_stats or None, port class, size)}
    at width 4: the port's seeded init as the JAX tree (a JAX init costs a
    whole-model CPU compile; the trees' layout is held against JAX's by
    every apply below and by test_published_widths_parameter_counts), and
    EnhancedUNet's running statistics made non-trivial so that the eval
    forward reads them."""
    rng = np.random.default_rng(3)
    out = {}
    for family, jcls, cls, size in (("optimized", JaxOptimized, OptimizedUNet, OPT_SIZE),
                                    ("enhanced", JaxEnhanced, EnhancedUNet, ENH_SIZE)):
        init = cls(init_features=WIDTH, generator=torch.Generator().manual_seed(1))
        stats = (_stats(rng, export_jax_batch_stats(init)) if family == "enhanced" else None)
        out[family] = (jcls(init_features=WIDTH), export_jax_params(init), stats, cls, size)
    return out


def _port(cls, params, stats=None, **kw):
    m = cls(init_features=WIDTH, generator=torch.Generator().manual_seed(0), **kw)
    load_jax_params(m, params, stats)
    return m


def _jax_apply(jm, params, stats, x):
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    return np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))


def _inputs(size, n=2, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 1)).astype(np.float32)


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 9, 2)])
def test_pool_and_upsample_equal_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(ops.max_pool_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_ops.max_pool_2x2(x)))
    np.testing.assert_array_equal(ops.upsample_nearest_2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_ops.upsample_nearest_2x(x)))


def test_dilated_conv_equals_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=2, dilation=2).numpy()
    want = np.asarray(jax_ops.conv2d(x, w, padding=2, dilation=2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- models


@pytest.mark.parametrize("family", ["optimized", "enhanced"])
def test_eval_forward_equals_jax_on_carried_weights(families, family):
    jm, params, stats, cls, size = families[family]
    model = _port(cls, params, stats).eval()
    assert sum(p.numel() for p in model.parameters()) == jax_model_utils.count_parameters(params)
    x = _inputs(size)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = _jax_apply(jm, params, stats, x)
    print(f"{family} f32 eval forward: max |port - jax| {np.abs(got - want).max():.3g}")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    # the carried trees come back unchanged
    for k, v in flatten_tree(export_jax_params(model)).items():
        np.testing.assert_array_equal(v, flatten_tree(params)[k], err_msg=k)
    if stats is not None:
        back = flatten_tree(export_jax_batch_stats(model))
        assert back.keys() == flatten_tree(stats).keys()


def test_published_widths_parameter_counts():
    """init_features 16: the JAX models' parameter counts; EnhancedUNet has
    a 512-channel bottleneck."""
    for jcls, cls, size in ((JaxOptimized, OptimizedUNet, 32), (JaxEnhanced, EnhancedUNet, 32)):
        shapes = jax.eval_shape(jcls().init, jax.random.PRNGKey(0),
                                jnp.zeros((1, size, size, 1)))["params"]
        assert sum(p.numel() for p in cls().parameters()) == \
            jax_model_utils.count_parameters(shapes), cls.__name__
    assert EnhancedUNet().bottleneck_conv2.shape == (3, 3, 512, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_update_equals_flax(dtype):
    """One train-mode call on 2 x 2 x 3 pixels per channel: the output and
    the running mean AND variance equal flax's, which folds the biased batch
    variance into its running average; torch's BatchNorm2d folds the
    unbiased one, which differs here by a factor of 12/11."""
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, (2, 2, 3, 5)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, 5).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 5).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 5).astype(np.float32)
    var0 = rng.random(5).astype(np.float32) + 0.5
    xj = jnp.asarray(x, dtype)
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean0, "var": var0}}, xj,
                         mutable=["batch_stats"])
    port = BatchNorm(5)
    load_jax_params(port, {"scale": scale, "bias": bias}, {"mean": mean0, "var": var0})
    got = port(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype)),
               train=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # flax promotes
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if dtype == "float32":
        torch_bn = torch.nn.BatchNorm2d(5, momentum=0.1, eps=1e-5)
        torch_bn.running_mean.copy_(torch.from_numpy(mean0))
        torch_bn.running_var.copy_(torch.from_numpy(var0))
        torch_bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert not np.allclose(torch_bn.running_var.numpy(), port.var.numpy(), rtol=1e-3)
        np.testing.assert_allclose(torch_bn.running_mean.numpy(), port.mean.numpy(),
                                   rtol=1e-5, atol=1e-6)


class _NoDropout(flax_nn.Module):
    """Dropout out of the JAX model's path, for this test's step only."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


def test_stateful_step_equals_jax_without_dropout(families, monkeypatch):
    jm, params, stats, _, size = families["enhanced"]
    rng = np.random.default_rng(5)
    y = rng.random((2, size, size, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.2, y.shape), 0, 1).astype(np.float32)
    monkeypatch.setattr(jax_enhanced_module.nn, "Dropout", _NoDropout)
    opt = jax_optimizer(LR, WD)
    jstate = JaxState(params=jax.tree_util.tree_map(jnp.asarray, params),
                      opt_state=opt.init(params), step=jnp.zeros((), jnp.int32),
                      model_state={"batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)})
    jstate, jloss = jax_train_step(jm.apply, opt, stateful=True)(jstate, jnp.asarray(x),
                                                                 jnp.asarray(y))
    model = _port(EnhancedUNet, params, stats, dropout_rate=0.0)
    state = TrainState(model=model, optimizer=make_optimizer(model, LR, WD))
    state, loss = make_train_step(stateful=True)(state, torch.from_numpy(x), torch.from_numpy(y))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want_bs = flatten_tree(_np(jstate.model_state["batch_stats"]))
    got_bs = flatten_tree(export_jax_batch_stats(model))
    assert got_bs.keys() == want_bs.keys()
    for k in want_bs:
        np.testing.assert_allclose(got_bs[k], want_bs[k], rtol=1e-4, atol=1e-6, err_msg=k)
    jp, tp = flatten_tree(_np(jstate.params)), flatten_tree(export_jax_params(model))
    diffs = np.concatenate([np.abs(jp[k] - tp[k]).ravel() for k in jp])
    beyond = int((diffs > 1e-5).sum())
    print(f"stateful step: params max |diff| {diffs.max():.3g}, {beyond} of {diffs.size} "
          f"beyond 1e-5")
    assert diffs.max() <= 2 * LR and beyond <= 1e-2 * diffs.size


def test_dropout_draws_from_the_generator():
    """In training the published rate drops about 20 % of the elements of
    each site, the same seed gives the same output, and eval mode draws
    nothing."""
    model = EnhancedUNet(init_features=WIDTH, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_inputs(ENH_SIZE))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            out = model(x, train=True, generator=gen)
        return out, gen.get_state()

    (a, sa), (b, sb), (c, _) = run(1), run(1), run(2)
    assert torch.equal(a, b) and torch.equal(sa, sb) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(1)
    before = gen.get_state()
    with torch.no_grad():
        model(x, generator=gen)
    assert torch.equal(gen.get_state(), before)
    from image_enhancement_deglaring_tpu_torch.models.enhanced_unet import dropout

    kept = dropout(torch.ones(200_000), 0.2, True, torch.Generator().manual_seed(3))
    share = float((kept == 0).float().mean())
    assert abs(share - 0.2) < 5 * np.sqrt(0.2 * 0.8 / 200_000)
    assert torch.allclose(kept[kept != 0], torch.tensor(1.25))
    with pytest.raises(ValueError, match="generator"):
        dropout(torch.ones(4), 0.2, True, None)


def test_remat_gradients_equal_no_remat():
    x = torch.from_numpy(_inputs(32, seed=6))
    grads = []
    for remat in (False, True):
        model = LightweightUNet(features_start=4, remat=remat,
                                generator=torch.Generator().manual_seed(0))
        model(x).square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=0, msg=n)
    with pytest.raises(ValueError, match="act_scales"):
        LightweightUNet(features_start=4, remat=True)(x, act_scales={})
    # without remat the int8 activation sites run (ROADMAP Queue 1 item 10):
    # an empty scales dict quantizes no site
    model = LightweightUNet(features_start=4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(model(x, act_scales={}), model(x))


def test_model_utils_equal_jax(families):
    params = families["enhanced"][1]
    assert count_parameters(params) == jax_model_utils.count_parameters(params)
    assert get_model_size_mb(params) == jax_model_utils.get_model_size_mb(params)
    assert get_model_size_mb(jax.tree_util.tree_map(torch.from_numpy, params)) == \
        get_model_size_mb(params)
    # pruning on a few leaves of each rank (JAX prunes eagerly, a compile per shape)
    params = {"enc1": params["enc1"], "upconv1": params["upconv1"]}
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    want = flatten_tree(_np(jax_model_utils.prune_params(params, 0.3)))
    for tree in (prune_params(params, 0.3), prune_params(tparams, 0.3)):
        got = flatten_tree(tree)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    ties = np.ones((4, 4), np.float32)  # every magnitude tied: still exactly k zeros
    assert int((prune_params({"w": ties}, 0.25)["w"] == 0).sum()) == 4


# ------------------------------------------------------ importers, eval


@pytest.fixture(scope="module")
def artifacts(families, tmp_path_factory):
    """Each family as an .onnx of the JAX writer, a flat .npz and the
    port's checkpoint directory."""
    root = tmp_path_factory.mktemp("families")
    paths = {}
    for family, (_, params, stats, _, _) in families.items():
        if family == "enhanced":
            paths[(family, "onnx")] = export_enhanced_unet(params, stats, str(root / "e.onnx"))
            flat = flatten_tree({"params": params, "batch_stats": stats})
            model_state = {"batch_stats": stats}
        else:
            paths[(family, "onnx")] = export_optimized_unet(params, str(root / "o.onnx"))
            flat, model_state = flatten_tree(params), None
        paths[(family, "npz")] = str(root / f"{family}.npz")
        np.savez(paths[(family, "npz")], **flat)
        paths[(family, "ckpt")] = save_checkpoint(str(root / f"{family}_ckpt"), params=params,
                                                  model_state=model_state)
    return paths


@pytest.mark.parametrize("family", ["optimized", "enhanced"])
def test_onnx_importers_equal_jax(artifacts, families, family):
    path = artifacts[(family, "onnx")]
    assert detect_model_arch(path) == jax_detect_model_arch(path) == family
    if family == "enhanced":
        got, want = enhanced_unet_params_from_onnx(path), jax_enhanced_from_onnx(path)
        got, want = {"p": got[0], "s": got[1]}, {"p": want[0], "s": want[1]}
    else:
        got, want = optimized_unet_params_from_onnx(path), jax_optimized_from_onnx(path)
    got, want = flatten_tree(got), flatten_tree(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # and they are the weights the file was written from
    params = families[family][1]
    for k, v in flatten_tree(params).items():
        np.testing.assert_allclose(got[f"p/{k}" if family == "enhanced" else k], v, rtol=1e-6)


@pytest.mark.parametrize("family,kind", [(f, k) for f in ("optimized", "enhanced")
                                         for k in ("onnx", "npz", "ckpt")])
def test_load_model_for_eval_every_family_equals_jax(artifacts, families, family, kind):
    path = artifacts[(family, kind)]
    # the JAX loader reads orbax directories: it takes the same weights'
    # .npz where the port reads its own checkpoint directory
    jm_apply, jparams = jax_load_model_for_eval(
        artifacts[(family, "npz")] if kind == "ckpt" else path)
    model, params = load_model_for_eval(path, device="cpu")
    assert type(model) is families[family][3] and not model.training
    assert flatten_tree(params).keys() == flatten_tree(_np(jparams)).keys()
    x = _inputs(families[family][4], seed=7)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jm_apply)({"params": jparams}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_enhanced_needs_its_batch_stats(artifacts, families, tmp_path):
    params = families["enhanced"][1]
    np.savez(tmp_path / "bare.npz", **flatten_tree(params))
    ckpt = save_checkpoint(str(tmp_path / "bare"), params=params)
    for path in (str(tmp_path / "bare.npz"), ckpt):
        with pytest.raises(ValueError, match="batch_stats"):
            load_model_for_eval(path, model_arch="enhanced", device="cpu")
    with pytest.raises(ValueError, match="does not match"):  # a family's tree in another
        load_model_for_eval(artifacts[("enhanced", "npz")], model_arch="optimized",
                            device="cpu")


def test_cli_evaluate_optimized_equals_jax_cli(artifacts, tmp_path, capsys):
    generate_synthetic_sd1(str(tmp_path / "sd"), n_train=0, n_val=4, size=OPT_SIZE, seed=1)
    onnx = tmp_path / "m.onnx"
    onnx.write_bytes(open(artifacts[("optimized", "onnx")], "rb").read())
    argv = ["--data_dir", str(tmp_path / "sd" / "val"), "--model_path", str(onnx),
            "--model", "optimized", "--batch_size", "4", "--image_size", str(OPT_SIZE),
            "--num_workers", "0"]
    jax_eval_cli.main(argv)
    want = capsys.readouterr().out
    os.remove(tmp_path / "evaluation_results.txt")
    eval_cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    _close_printed(_metric_lines(got), _metric_lines(want))
    assert "Model type: ONNX" in (tmp_path / "evaluation_results.txt").read_text()


def test_group_norm_statistics_on_the_cpu_hold_float64_accuracy():
    """A 256^2 x 8-channel group: the CPU's float32 statistics accumulate in
    float64 (``stat_mean``), so the normalized output stays within 2e-6 of
    a float64 reference; summed in float32 in torch's CPU order they moved
    it by ~3e-4 (an OptimizedUNet enc2 site, read against the H100)."""
    rng = np.random.default_rng(8)
    x = (rng.normal(0.1, 0.3, (2, 256, 256, 32)) + rng.normal(0, 0.05, (1, 256, 256, 1)))
    x = x.astype(np.float32)
    xd = x.astype(np.float64).reshape(2, 256, 256, 4, 8)
    mean = xd.mean(axis=(1, 2, 4), keepdims=True)
    var = ((xd - mean) ** 2).mean(axis=(1, 2, 4), keepdims=True)
    want = ((xd - mean) / np.sqrt(var + 1e-5)).reshape(x.shape)
    got = ops.group_norm(torch.from_numpy(x), torch.ones(32), torch.zeros(32), num_groups=4)
    assert float(np.abs(got.numpy() - want).max()) <= 2e-6
    t = torch.from_numpy(x)
    np.testing.assert_allclose(ops.stat_mean(t, (1, 2)).numpy(),
                               x.astype(np.float64).mean(axis=(1, 2), keepdims=True), rtol=1e-6)
