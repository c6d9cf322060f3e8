"""The port's trainer against the JAX package's, on the CPU.

The same weights (a seeded init, in both packages through their common
parameter tree) and the same seeded batches go through the JAX
``make_train_step`` and the port's step.
Tolerances, as read on the CPU (XLA's and PyTorch's CPU runtimes):

- f32 loss: relative 1e-5 (read: <= 2e-6);
- f32 gradients after the clip: within 2e-6 + 1e-4 x the leaf's largest
  magnitude (read: <= 1.5e-7 absolute, largest gradient 0.36);
- the optimizer alone, fed JAX's clipped gradients from the carried-over
  optax state: parameters within 5e-7 (read: 1.2e-7; optax applies
  ``p - lr * (adam + wd * p)``, torch ``p * (1 - lr * wd) - lr * adam``,
  equal in exact arithmetic and apart in the last bits);
- f32 parameters after 3 whole steps: within 3e-4, and at most 0.05 % of
  the elements beyond 1e-5 (read: 3.0e-5, 20 of 486,409). Adam's first
  steps turn rounding into sign flips: where |g| is near eps, the update
  is about lr * sign(g), so a gradient near 0 whose sign differs between
  the packages moves a parameter by up to 2 * lr;
- train_model, 2 epochs of 2 steps with augmentation: each epoch's
  losses, PSNR and SSIM relative 1e-4, the best epoch equal, the best
  parameters within 2 * lr with at most 1 % of the elements beyond 1e-5
  (read: 1.8e-4 and 191 of 486,409, in the deep layers, whose small
  gradients flip sign first);
- one bf16 step: loss relative 1e-3 (read: 3.3e-4) and, per parameter
  leaf, a gradient cosine >= 0.95 (read: >= 0.975). The packages round
  bf16 at other places; the JAX step also sums the output bias's gradient
  in bf16 (-0.0625 against the f32 -0.642; the port's reads -0.645), so
  the bias leaf is held by the sign its cosine gives, not by its size.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_enhancement_deglaring_tpu.data import make_dataloaders as jax_loaders
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.ops import metrics as jax_metrics
from image_enhancement_deglaring_tpu.train import ReduceLROnPlateau as JaxPlateau
from image_enhancement_deglaring_tpu.train.loop import TrainState as JaxState
from image_enhancement_deglaring_tpu.train.loop import make_optimizer as jax_optimizer
from image_enhancement_deglaring_tpu.train.loop import make_train_step as jax_train_step
from image_enhancement_deglaring_tpu.train.loop import make_val_step as jax_val_step
from image_enhancement_deglaring_tpu.train.loop import train_model as jax_train_model
from image_enhancement_deglaring_tpu.utils import ExperimentLogger as JaxLogger
from image_enhancement_deglaring_tpu.utils.pytree import load_npz_tree as jax_load_npz
from image_enhancement_deglaring_tpu_torch.cli import sweep as sweep_cli
from image_enhancement_deglaring_tpu_torch.cli import train as port_cli
from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1, make_dataloaders
from image_enhancement_deglaring_tpu_torch.modelio import (
    export_jax_opt_state,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.ops import dec1
from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
from image_enhancement_deglaring_tpu_torch.ops import metrics
from image_enhancement_deglaring_tpu_torch.parallel import make_mesh
from image_enhancement_deglaring_tpu_torch.train import (
    ReduceLROnPlateau,
    TrainState,
    clip_grad_norm_,
    make_optimizer,
    make_train_step,
    make_val_step,
    train_model,
)
from image_enhancement_deglaring_tpu_torch.train.checkpoint import restore_checkpoint
from image_enhancement_deglaring_tpu_torch.utils import ExperimentLogger, flatten_tree

SIZE, BATCH = 32, 4
LR, WD = 2e-3, 1e-4
CLIP = 0.5  # below the init's gradient norm (0.87), so the clip acts

# one JAX model, optimizer and compiled step per module (whole-model CPU
# compiles are seconds each, and are made on first use, not at import); the
# initial weights are the port's seeded init, which costs no JAX compile
_JM = JaxUNet()
_JOPT = jax_optimizer(LR, WD, CLIP)
_JSTEP = jax_train_step(_JM.apply, _JOPT)
_JPARAMS = export_jax_params(LightweightUNet(generator=torch.Generator().manual_seed(0)))


@jax.jit
def _jax_loss_and_grads(params, x, y):
    def loss_fn(p):
        return jax_metrics.l1_loss(_JM.apply({"params": p}, x), y)

    return jax.value_and_grad(loss_fn)(params)


@jax.jit
def _jax_clip(grads):
    tx = optax.clip_by_global_norm(CLIP)
    return tx.update(grads, tx.init(grads))[0]


def _jax_state(params=_JPARAMS, opt=_JOPT):
    """A fresh JAX TrainState on a copy of ``params`` (the step donates it)."""
    params = jax.tree_util.tree_map(jnp.array, params)
    return JaxState(params=params, opt_state=opt.init(params), step=jnp.zeros((), jnp.int32))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _batches(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = rng.random((n, BATCH, SIZE, SIZE, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.2, y.shape), 0, 1).astype(np.float32)
    return x, y


def _port_model(dtype=torch.float32, params=None):
    m = LightweightUNet(dtype=dtype)
    load_jax_params(m, _np_tree(_JPARAMS if params is None else params))
    return m


def _optax_names(tree) -> dict:
    """optax state leaves by their "/"-joined path (the port's leaf names)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k)))) for k in path]
        out["/".join(parts)] = np.asarray(leaf)
    return out


def _jax_clipped_grads(params, x, y):
    loss, g = _jax_loss_and_grads(params, jnp.asarray(x), jnp.asarray(y))
    return float(loss), flatten_tree(_np_tree(_jax_clip(g)))



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run small tensors, several test processes at once: one
    intra-op thread each keeps torch's thread pools from oversubscribing
    the cores (the results here do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ metrics


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    p = rng.random((3, 20, 24, 1)).astype(np.float32) * 1.2 - 0.1
    t = rng.random((3, 20, 24, 1)).astype(np.float32)
    tp, tt = torch.from_numpy(p), torch.from_numpy(t)
    assert float(metrics.l1_loss(tp, tt)) == pytest.approx(
        float(jax_metrics.l1_loss(p, t)), rel=1e-6)
    assert float(metrics.psnr(tp[0, ..., 0], tt[0, ..., 0])) == pytest.approx(
        float(jax_metrics.psnr(p[0, ..., 0], t[0, ..., 0])), rel=1e-5)
    assert float(metrics.ssim(tp[1, ..., 0], tt[1, ..., 0])) == pytest.approx(
        float(jax_metrics.ssim(p[1, ..., 0], t[1, ..., 0])), abs=1e-5)
    for layout in (lambda a: a, lambda a: a.transpose(0, 3, 1, 2), lambda a: a[..., 0]):
        ps, ss = metrics.batched_psnr_ssim(torch.from_numpy(layout(p)), torch.from_numpy(layout(t)))
        jps, jss = jax_metrics.batched_psnr_ssim(layout(p), layout(t))
        np.testing.assert_allclose(ps.numpy(), np.asarray(jps), rtol=1e-5)
        np.testing.assert_allclose(ss.numpy(), np.asarray(jss), atol=1e-5)


def test_ssim_refuses_images_smaller_than_its_window():
    with pytest.raises(ValueError, match="win_size"):
        metrics.ssim(torch.zeros(6, 9), torch.zeros(6, 9))
    with pytest.raises(ValueError, match="single-channel"):
        metrics.batched_psnr_ssim(torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 3))


def test_reduce_lr_on_plateau_torch_semantics():
    for cls in (ReduceLROnPlateau, JaxPlateau):  # the same sequence in both packages
        s = cls(1.0, factor=0.5, patience=2)
        assert s.step(1.0) == 1.0
        assert s.step(0.5) == 1.0
        assert s.step(0.5) == 1.0
        assert s.step(0.51) == 1.0
        assert s.step(0.52) == 0.5
        assert s.step(0.49996) == 0.5
        assert s.num_bad_epochs == 1
        assert s.step(0.4999) == 0.5
        assert s.num_bad_epochs == 0 and s.best == 0.4999
        state = s.state_dict()
        s2 = cls(7.0)
        s2.load_state_dict(state)
        assert s2.state_dict() == state


# ------------------------------------------------------------- the step


def test_f32_gradients_after_the_clip_match_jax():
    x, y = _batches(1, seed=5)
    jloss, jg = _jax_clipped_grads(_JPARAMS, x[0], y[0])
    model = _port_model()
    loss = metrics.l1_loss(model(torch.from_numpy(x[0])), torch.from_numpy(y[0]))
    loss.backward()
    with torch.no_grad():
        norm = float(clip_grad_norm_(list(model.parameters()), CLIP))
    assert norm > CLIP  # the clip acted
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    tg = {n.replace(".", "/"): p.grad.numpy() for n, p in model.named_parameters()}
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0,
                                   atol=2e-6 + 1e-4 * float(np.abs(jg[k]).max()), err_msg=k)
    total = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64)))) for g in tg.values()))
    assert total == pytest.approx(CLIP, rel=1e-5)


def test_clip_follows_optax_rule_below_and_at_the_bound():
    """Below max_norm the gradients stay as they are; torch's own
    clip_grad_norm_ would scale them by max_norm / (norm + 1e-6)."""
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.tensor([0.3, 0.4, 0.0, 0.0])  # norm 0.5
    g0 = p.grad.clone()
    clip_grad_norm_([p], 1.0)
    assert torch.equal(p.grad, g0)
    clip_grad_norm_([p], 0.25)
    g = optax.clip_by_global_norm(0.25).update(jnp.asarray(g0.numpy()), None)[0]
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(g))


def test_f32_steps_match_jax():
    x, y = _batches(3, seed=7)
    jstate = _jax_state()
    model = _port_model()
    state = TrainState(model=model, optimizer=make_optimizer(model, LR, WD, CLIP))
    step = make_train_step()
    for i in range(3):
        jstate, jloss = _JSTEP(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]))
        state, loss = step(state, torch.from_numpy(x[i]), torch.from_numpy(y[i]))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5), i
    assert state.step == 3 == int(jstate.step)
    jp = flatten_tree(_np_tree(jstate.params))
    tp = flatten_tree(export_jax_params(model))
    diffs = np.concatenate([np.abs(jp[k] - tp[k]).ravel() for k in jp])
    beyond = int((diffs > 1e-5).sum())
    print(f"f32 params after 3 steps: max |diff| {diffs.max():.3g}, {beyond} of {diffs.size} "
          f"beyond 1e-5")
    assert diffs.max() <= 3e-4
    assert beyond <= 5e-4 * diffs.size


def test_optimizer_alone_matches_optax_from_the_carried_state():
    """JAX's state after one step carried into torch AdamW, fed JAX's
    clipped gradients of a second batch: the update equals optax's to f32
    round-off, and so does the state it leaves."""
    x, y = _batches(2, seed=11)
    jstate, _ = _JSTEP(_jax_state(), jnp.asarray(x[0]), jnp.asarray(y[0]))
    _, g = _jax_loss_and_grads(jstate.params, jnp.asarray(x[1]), jnp.asarray(y[1]))
    updates, new_opt = jax.jit(_JOPT.update)(g, jstate.opt_state, jstate.params)
    want = flatten_tree(_np_tree(optax.apply_updates(jstate.params, updates)))
    _, clipped = _jax_clipped_grads(jstate.params, x[1], y[1])

    model = _port_model(params=jstate.params)
    opt = make_optimizer(model, 1.0, WD, CLIP)  # the LR comes from the state
    load_jax_opt_state(opt, model, _optax_names(jstate.opt_state))
    assert opt.param_groups[0]["lr"] == pytest.approx(LR)
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(clipped[n.replace(".", "/")].copy())
    opt.step()
    got = flatten_tree(export_jax_params(model))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-7, err_msg=k)
    names = _optax_names(new_opt)
    exported = export_jax_opt_state(opt, model)
    assert exported.keys() == names.keys()
    for k in names:  # moments to f32 round-off, the counts and the LR exactly
        np.testing.assert_allclose(exported[k], names[k], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(names[k]).max()), err_msg=k)


@pytest.mark.parametrize("clip", [CLIP, 0.0])
def test_opt_state_carry_round_trip(clip):
    """optax state -> torch AdamW -> optax leaves, unchanged bit for bit,
    with the clip in the chain and without it. The state is optax's after
    two updates with seeded gradients."""
    opt_j = jax_optimizer(LR, WD, clip)
    rng = np.random.default_rng(13)
    jstate = _jax_state(opt=opt_j)
    opt_state = jstate.opt_state
    update = jax.jit(opt_j.update)  # one compile, not one per eager op
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(0, 1e-2, a.shape).astype(np.float32)),
            jstate.params)
        _, opt_state = update(g, opt_state, jstate.params)
    names = _optax_names(opt_state)
    assert int(names["count"]) == 2
    model = _port_model()
    opt = make_optimizer(model, 0.1, WD, clip)
    load_jax_opt_state(opt, model, opt_state)  # the NamedTuple form itself
    out = export_jax_opt_state(opt, model, clip=clip > 0)
    assert out.keys() == names.keys()
    for k in names:
        np.testing.assert_array_equal(out[k], names[k], err_msg=k)
        assert out[k].dtype == names[k].dtype, k
    narrow = LightweightUNet(features_start=4)  # the same names, other shapes
    with pytest.raises(ValueError, match="shape"):
        load_jax_opt_state(make_optimizer(narrow, 0.1, WD, clip), narrow, names)
    with pytest.raises(ValueError, match="not a parameter of the optimizer"):
        load_jax_opt_state(opt, narrow, names)


def test_val_step_matches_jax_with_a_padded_batch():
    x, y = _batches(1, seed=17)
    xb = np.concatenate([x[0][:2], np.zeros((2, SIZE, SIZE, 1), np.float32)])
    yb = np.concatenate([y[0][:2], np.zeros((2, SIZE, SIZE, 1), np.float32)])
    mask = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    model = _port_model()
    for with_metrics in (True, False):
        jout = jax_val_step(_JM.apply, with_metrics=with_metrics)(
            _JPARAMS, {}, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(mask))
        out = make_val_step(with_metrics=with_metrics)(
            model, torch.from_numpy(xb), torch.from_numpy(yb), torch.from_numpy(mask))
        for got, want, name in zip(out[:3], jout[:3], ("loss", "psnr", "ssim")):
            assert np.isfinite(float(got)), name
            assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6), name
        np.testing.assert_allclose(out[3].numpy(), np.asarray(jout[3]), atol=1e-5)


def test_bf16_step_close_to_jax():
    x, y = _batches(1, seed=19)
    jm = JaxUNet(dtype=jnp.bfloat16)

    def loss_fn(p):
        return jax_metrics.l1_loss(jm.apply({"params": p}, jnp.asarray(x[0])), jnp.asarray(y[0]))

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(_JPARAMS)
    jg = flatten_tree(_np_tree(jg))
    model = _port_model(torch.bfloat16)
    loss = metrics.l1_loss(model(torch.from_numpy(x[0])), torch.from_numpy(y[0]))
    loss.backward()
    rel = abs(float(loss.detach()) - float(jloss)) / float(jloss)
    cos = {}
    for n, p in model.named_parameters():
        assert p.grad.dtype == torch.float32  # through the cast to the f32 parameter
        a, b = p.grad.numpy().ravel().astype(np.float64), jg[n.replace(".", "/")].ravel()
        cos[n] = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    worst = min(cos, key=cos.get)
    print(f"bf16 step: loss rel diff {rel:.3g}; lowest gradient cosine {cos[worst]:.4f} ({worst})")
    assert rel <= 1e-3
    assert cos[worst] >= 0.95


# -------------------------------------------------------------- the loop


def _sd1(tmp_path, n=12):
    d = tmp_path / "sd1"
    generate_synthetic_sd1(str(d), n_train=n, n_val=0, size=SIZE, seed=0)
    return str(d / "train")


def _history(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "train_loss" in r]


def test_train_model_two_epochs_matches_jax(tmp_path):
    """train_model over 2 epochs (2 steps each, optimized augmentation) on
    8 + 4 synthetic images from the same init_params (tolerances in the
    module docstring)."""
    data = _sd1(tmp_path)
    kw = dict(batch_size=BATCH, val_split=1 / 3, seed=42, image_size=SIZE, num_workers=0,
              augment="optimized")
    jt, jv = jax_loaders(data, **kw)
    tt, tv = make_dataloaders(data, **kw)
    assert (tt.num_samples, tv.num_samples) == (8, 4) == (jt.num_samples, jv.num_samples)
    common = dict(epochs=2, lr=LR, weight_decay=WD, validation_metrics_every=1, seed=42,
                  progress=False, handle_preemption=False, init_params=_np_tree(_JPARAMS))
    jlog = JaxLogger(str(tmp_path / "jax_logs"))
    jbest, _, jval, _ = jax_train_model(_JM, jt, jv, output_dir=str(tmp_path / "jax"),
                                        logger=jlog, **common)
    tlog = ExperimentLogger(str(tmp_path / "port_logs"))
    tbest, _, tval, state = train_model(LightweightUNet(), tt, tv, device="cpu",
                                        output_dir=str(tmp_path / "port"), logger=tlog,
                                        **common)
    jh, th = _history(tmp_path / "jax_logs"), _history(tmp_path / "port_logs")
    assert len(jh) == len(th) == 2
    for a, b in zip(jh, th):
        for key in ("train_loss", "val_loss", "val_psnr", "val_ssim"):
            assert b[key] == pytest.approx(a[key], rel=1e-4), (a["epoch"], key)
    assert tlog.summary["best_epoch"] == jlog.summary["best_epoch"]
    assert tval == pytest.approx(jval, rel=1e-4)
    assert state.step == 4
    jb, tb = flatten_tree(_np_tree(jbest)), flatten_tree(tbest)
    diffs = np.concatenate([np.abs(jb[k] - tb[k]).ravel() for k in jb])
    beyond = int((diffs > 1e-5).sum())
    print(f"best params after 4 steps: max |diff| {diffs.max():.3g}, {beyond} of {diffs.size} "
          f"beyond 1e-5")
    assert diffs.max() <= 2 * LR  # one Adam sign flip
    assert beyond <= 1e-2 * diffs.size
    for name in ("best_model", "loss_plot.png"):
        assert os.path.exists(tmp_path / "port" / name)


def test_cli_train_writes_artifacts_that_load_into_the_jax_model(tmp_path):
    data = _sd1(tmp_path)
    out = tmp_path / "run"
    port_cli.main(["--data_dir", data, "--output_dir", str(out), "--epochs", "1",
                   "--batch_size", "4", "--image_size", str(SIZE), "--num_workers", "0",
                   "--validation_metrics_every", "1", "--device", "cpu"])
    for name in ("best_model", "final_model", "model_weights.npz", "logs/metrics.jsonl"):
        assert os.path.exists(out / name), name
    tree = jax_load_npz(str(out / "model_weights.npz"))
    x, _ = _batches(1, seed=23)
    want = np.asarray(jax.jit(_JM.apply)({"params": tree}, jnp.asarray(x[0])))
    model = LightweightUNet()
    load_jax_params(model, tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x[0])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    item, meta = restore_checkpoint(str(out / "best_model"))
    assert meta["model_arch"] == "lightweight" and meta["epoch"] == 0
    assert {"lr_state", "step", "rng", "epochs_without_improvement"} <= meta.keys()
    assert "opt_state" in item


class _GuardAfter:
    """A preemption guard whose flag turns on at its ``after + 1``-th read:
    the loop reads it after every step and at every epoch's end."""

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


def test_resume_and_preemption_continue_exactly(tmp_path):
    """An epoch-boundary resume and a mid-epoch preemption resume both end
    where an uninterrupted run does, bit for bit."""
    data = _sd1(tmp_path)
    kw = dict(batch_size=BATCH, val_split=1 / 3, seed=42, image_size=SIZE, num_workers=0)
    common = dict(lr=LR, weight_decay=WD, progress=False, device="cpu",
                  init_params=_np_tree(_JPARAMS))

    def run(name, epochs, **extra):
        tl, vl = make_dataloaders(data, **kw)
        return train_model(LightweightUNet(), tl, vl, epochs=epochs,
                           output_dir=str(tmp_path / name), **{**common, **extra})

    _, _, full_val, full = run("full", 2, handle_preemption=False)
    run("a", 1, save_every=1, handle_preemption=False)
    _, _, val_b, resumed = run("b", 2, handle_preemption=False,
                               resume_from=str(tmp_path / "a" / "checkpoint_epoch_1"))
    guard = _GuardAfter(3)  # reads: step, step, epoch end, then step 1 of epoch 2
    run("c", 2, preempt_guard=guard)
    assert guard.preempt_checkpoint is not None
    meta = restore_checkpoint(guard.preempt_checkpoint)[1]
    assert meta["mid_epoch"] and meta["epoch"] == 1 and meta["epoch_step"] == 1
    _, _, val_c, preempted = run("c", 2, handle_preemption=False,
                                 resume_from=guard.preempt_checkpoint)
    want = flatten_tree(export_jax_params(full.model))
    for state in (resumed, preempted):
        assert state.step == full.step == 4
        got = flatten_tree(export_jax_params(state.model))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert val_b == val_c == full_val


def test_early_stop_after_patience(tmp_path, capsys):
    """With lr 0 the val loss never improves after the first epoch: patience
    1 stops the run after its second epoch."""
    data = _sd1(tmp_path)
    tl, vl = make_dataloaders(data, batch_size=BATCH, val_split=1 / 3, seed=42,
                              image_size=SIZE, num_workers=0)
    _, _, _, state = train_model(LightweightUNet(), tl, vl, epochs=5, lr=0.0, patience=1,
                                 output_dir=str(tmp_path / "run"), progress=False,
                                 device="cpu", handle_preemption=False)
    assert state.step == 4
    assert "Early stopping triggered after 1 epochs" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [
    (["--distributed", "--method", "wandb"], "does not compose with --distributed"),
    (["--num_processes", "2"], "require --distributed"),
])
def test_cli_refuses_unported_flags_naming_their_queue_item(flags, item):
    """cli.train and cli.sweep take --distributed and --n_devices now
    (tests/test_torch_port_distributed.py, tests/test_torch_port_sweep_mesh.py);
    the sweep CLI refuses what the JAX CLI refuses before it reads any data."""
    with pytest.raises(SystemExit, match=item):
        sweep_cli.main(["--data_dir", "unused", "--device", "cpu", *flags])


def test_cli_and_train_model_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["--data_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_model(LightweightUNet(), [], [], epochs=1, output_dir=str(tmp_path))
    # a mesh's device is CUDA unless the CPU is asked for, and the mesh
    # owns the device: another one named beside it raises
    with pytest.raises(RuntimeError, match="CUDA"):
        train_model(LightweightUNet(), [], [], epochs=1, mesh=make_mesh())
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        train_model(LightweightUNet(), [], [], epochs=1, mesh=make_mesh(), device="cpu")


# -------------------------------------------------- the kernels' grad guard


def _guard_calls():
    x = torch.randn(2, 8, 8, 8)
    w = torch.randn(3, 3, 8, 8)
    g, b = torch.ones(8), torch.zeros(8)
    return {
        "gn_silu_flat": (lambda x: fk._gn_silu_launch("gn_silu_flat", x, g, b, 8, 1e-5), x),
        "gn_silu_nhwc": (lambda x: fk._gn_silu_launch("gn_silu_nhwc", x, g, b, 8, 1e-5), x),
        "conv3x3_gn_silu": (lambda x: fk._conv_launch("conv3x3_gn_silu", x, w, g, b, 8, 1e-5, 1),
                            x),
        "conv3x3_gn_silu_batched": (
            lambda x: fk._conv_launch("conv3x3_gn_silu_batched", x, w, g, b, 8, 1e-5, 2), x),
        "fused_dec1_output": (
            lambda x: dec1._launch(x, x, w, w, w, g, b, g, b, torch.ones(1, 1, 8, 1),
                                   torch.zeros(1), eps=1e-5, tile_h=8), x),
    }


@pytest.mark.parametrize("name", ["gn_silu_flat", "gn_silu_nhwc", "conv3x3_gn_silu",
                                  "conv3x3_gn_silu_batched", "fused_dec1_output"])
def test_kernel_launch_refuses_autograd(name):
    """Every kernel's launch path (the route a CUDA tensor takes) raises under
    grad mode when an argument requires grad; under no_grad it passes the
    guard and stops only at the device check, as there is no card here."""
    launch, x = _guard_calls()[name]
    with pytest.raises(RuntimeError, match="forward-only"):
        launch(x.clone().requires_grad_(True))
    with torch.no_grad(), pytest.raises(ValueError, match="want cpu or cuda"):
        launch(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="want cpu or cuda"):
        launch(x)  # nothing requires grad


def test_plain_routes_still_differentiate():
    """On the CPU the kernel sites compute their plain versions, which are
    plain torch: a model with the knobs on and its routes forced to the
    kernels trains, every parameter getting a finite gradient."""
    from unittest import mock

    model = LightweightUNet(features_start=8, pallas_gn=True, fused_blocks=True)
    x, y = _batches(1, seed=29)
    with mock.patch.object(fk, "_routes_to_kernels", lambda t: True):
        metrics.l1_loss(model(torch.from_numpy(x[0])), torch.from_numpy(y[0])).backward()
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        assert float(p.grad.abs().max()) > 0, n
