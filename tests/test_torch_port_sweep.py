"""The port's sweep layer (``parallel.sweep``, ``utils.config``,
``cli.sweep``) against the JAX package's, on the CPU: the samplers, the
lock-step trial group, halving, the resident epochs, EnhancedUNet's
stateful group, the W&B paths and the CLI. ``run_sweep`` end to end and
resume are in tests/test_torch_port_sweep_resume.py.

The JAX side runs with ``mesh=None`` on one CPU device. Tolerances:

- the samplers and ``hyperband_rungs``: equal bit for bit (the same numpy
  draws from the same ``default_rng`` state);
- one group of 4 trials (distinct lr/wd) from JAX's init over 3 steps:
  per-trial losses rel 1e-5 (read: <= 1.2e-6), parameters within 2 * lr
  (one Adam sign flip, see tests/test_torch_port_train.py) with at most 1 %
  of them beyond 1e-5 (read: 7.5e-5 and 0.004 %); validation rel 1e-5;
- a group of one against the trainer's step (``make_step_body`` +
  ``ClippedAdamW``), and the resident epoch against the per-step one:
  equal bit for bit, as they run the same eager ops in the same order
  (EnhancedUNet's too: losses, dropout stream, BatchNorm statistics and
  parameters). Halving's survivors against the same trials in a group that
  kept all four (the JAX package's mask mode): losses rtol 1e-6 (the JAX
  test's), each parameter leaf within 1e-6 of its largest magnitude
  (read: losses equal, parameters 2.4e-7 apart: grouped convs of 2 and of
  4 trials round the survivors' gradients differently).
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.parallel import sweep as jax_sweep
from image_enhancement_deglaring_tpu.utils import config as jax_config
from image_enhancement_deglaring_tpu_torch.cli import sweep as port_cli
from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1
from image_enhancement_deglaring_tpu_torch.modelio import (
    export_jax_batch_stats,
    export_jax_params,
    load_jax_params,
)
from image_enhancement_deglaring_tpu_torch.models import (
    EnhancedUNet,
    LightweightUNet,
    get_model_size_mb,
)
from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch
from image_enhancement_deglaring_tpu_torch.parallel import (
    SearchSpace,
    Trial,
    VmappedTrialGroup,
    WandbSweepMirror,
    hyperband_rungs,
    make_mesh,
    run_sweep,
    run_sweep_from_config,
    run_wandb_agent_sweep,
    sample_random,
    sample_tpe,
)
from image_enhancement_deglaring_tpu_torch.train import TrainState, make_optimizer
from image_enhancement_deglaring_tpu_torch.train.loop import make_step_body
from image_enhancement_deglaring_tpu_torch.train.resident import batch_val_cache, cache_on_device
from image_enhancement_deglaring_tpu_torch.utils import config as port_config
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from image_enhancement_deglaring_tpu_torch.utils.pytree import load_npz_tree
from tests.loaders import ArrayLoader

SIZE = 16
CPU = 1 << 34  # a resident cache's budget on the CPU
LOSS_REL, PARAM_SHARE = 1e-5, 0.01
CFG = [(1e-3, 1e-5), (3e-3, 1e-4), (5e-4, 1e-6), (8e-3, 5e-4)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run small tensors, several test processes at once: one
    intra-op thread each keeps torch's thread pools from oversubscribing
    the cores (module scope: the module's fixtures train too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(0)
    y = rng.random((16, SIZE, SIZE, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.1, y.shape), 0, 1).astype(np.float32)
    return x, y


def _tiny(dtype=torch.float32):
    return LightweightUNet(features_start=2, num_groups=2, dtype=dtype,
                           generator=torch.Generator().manual_seed(0))


def _trials(cfg=CFG, bs=8):
    return [Trial(trial_id=i, batch_size=bs, lr=lr, wd=wd) for i, (lr, wd) in enumerate(cfg)]


def _group(model=None, cfg=CFG, bs=8, **kw):
    return VmappedTrialGroup(model or _tiny(), _trials(cfg, bs), seed=0, device="cpu", **kw)


def _fields(trials):
    return [(t.trial_id, t.batch_size, t.lr, t.wd) for t in trials]


def _history(pkg):
    """The JAX test's synthetic TPE history (low lr ~1e-3 is good), with
    two diverged trials."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(20):
        lr = float(np.exp(rng.uniform(np.log(1e-4), np.log(1e-2))))
        t = pkg.Trial(trial_id=i, batch_size=int(rng.choice((4, 8, 16))), lr=lr, wd=1e-5)
        t.val_losses = [float("nan")] if i in (3, 11) else [abs(np.log(lr) - np.log(1e-3))]
        out.append(t)
    return out


@pytest.mark.parametrize("case", ["random", "tpe", "tpe_fallback", "rungs"])
def test_samplers_and_rungs_equal_jax_bit_for_bit(case):
    if case == "rungs":
        for args in ((10, 50, 3), (10, 9, 3), (1, 3, 2), (2, 2, 2), (1, 100, 4)):
            assert hyperband_rungs(*args) == jax_sweep.hyperband_rungs(*args)
        for bad in ((0, 50, 3), (10, 50, 1)):
            with pytest.raises(ValueError) as e_port:
                hyperband_rungs(*bad)
            with pytest.raises(ValueError) as e_jax:
                jax_sweep.hyperband_rungs(*bad)
            assert str(e_port.value) == str(e_jax.value)
        return
    space = SearchSpace(batch_sizes=(4, 8, 16))
    jspace = jax_sweep.SearchSpace(batch_sizes=(4, 8, 16))
    r_port, r_jax = np.random.default_rng(7), np.random.default_rng(7)
    if case == "random":
        got, want = sample_random(r_port, 50, space, 3), jax_sweep.sample_random(r_jax, 50, jspace,
                                                                                 3)
    else:
        hist_port, hist_jax = _history(sys.modules[Trial.__module__]), _history(jax_sweep)
        if case == "tpe_fallback":  # fewer than 4 finite trials: random, ids continue
            hist_port, hist_jax = hist_port[:5], hist_jax[:5]
            for t in hist_port[:4] + hist_jax[:4]:
                t.val_losses = [float("nan")]
        got = sample_tpe(r_port, 12, space, hist_port)
        want = jax_sweep.sample_tpe(r_jax, 12, jspace, hist_jax)
    assert _fields(got) == _fields(want)
    assert r_port.bit_generator.state == r_jax.bit_generator.state


def test_group_steps_match_jax(toy):
    """Four trials from JAX's init, 3 shared batches: losses, parameters,
    and both validation forms."""
    x, y = toy
    jg = jax_sweep.VmappedTrialGroup(JaxUNet(features_start=2, num_groups=2),
                                     [jax_sweep.Trial(i, 8, lr, wd)
                                      for i, (lr, wd) in enumerate(CFG)], seed=0)
    model = LightweightUNet(features_start=2, num_groups=2)
    load_jax_params(model, jax.tree_util.tree_map(lambda a: np.array(a[0]), jg.params))
    pg = _group(model)
    assert not pg.stateful and pg.lrs.shape == (4,)
    for s, (i0, i1) in enumerate(((0, 8), (8, 16), (4, 12))):
        xb, yb = x[i0:i1], y[i0:i1]
        jg.params, jg.model_state, jg.opt_state, jl = jg._train_step(
            jg.params, jg.model_state, jg.opt_state, jg.lrs, jg.wds, jnp.asarray(xb),
            jnp.asarray(yb), jax.random.PRNGKey(0))
        pl = pg._train_step(torch.from_numpy(xb), torch.from_numpy(yb)).numpy()
        np.testing.assert_allclose(pl, np.asarray(jl), rtol=LOSS_REL, err_msg=f"step {s}")
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jg.params))
    beyond = total = 0
    for name, w in want.items():
        d = np.abs(pg.params[name.replace("/", ".")].numpy() - w)
        for k, (lr, _) in enumerate(CFG):
            assert d[k].max() <= 2 * lr, (name, k, d[k].max())
        beyond, total = beyond + int((d > 1e-5).sum()), total + d.size
    assert beyond <= PARAM_SHARE * total, (beyond, total)

    ragged = ArrayLoader(x[:10], y[:10], 4, ragged_tail=True)
    want_val = jg.val_epoch(ragged)
    np.testing.assert_allclose(pg.val_epoch(ragged), want_val, rtol=LOSS_REL)
    data = cache_on_device(ArrayLoader(x[:10], y[:10], 10), device="cpu", device_bytes=CPU)
    np.testing.assert_allclose(pg.val_epoch_resident(batch_val_cache(data, 4), data.n), want_val,
                               rtol=LOSS_REL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_of_one_equals_the_trainer_step(toy, dtype):
    """clip (acting: 0.5 is below the init's gradient norm) + AdamW on the
    stacked state equals ClippedAdamW's step, and the bf16 group keeps
    float32 master parameters."""
    x, y = toy
    g = _group(_tiny(dtype), cfg=[(3e-3, 1e-4)], clip_grad_norm=0.5)
    m = _tiny(dtype)
    state = TrainState(model=m, optimizer=make_optimizer(m, 3e-3, 1e-4, 0.5))
    body = make_step_body()
    xb = torch.from_numpy(x[:8]).to(dtype)
    for _ in range(3):
        got = g._train_step(xb, torch.from_numpy(y[:8]))
        state, want = body(state, xb, torch.from_numpy(y[:8]))
        assert got.item() == want.item()
    for name, p in m.named_parameters():
        assert g.params[name].dtype == torch.float32
        assert torch.equal(g.params[name][0], p.detach()), name


def test_enhanced_group_is_stateful(tmp_path):
    """EnhancedUNet at 64^2: BatchNorm statistics move inside the vmapped
    forward and come back out per trial; a group of one equals the stateful
    trainer step bit for bit (dropout masks and statistics included) for
    the same generator state; identical trials stay identical; halving keeps the
    statistics aligned; the snapshot bundles them under JAX names."""
    rng = np.random.default_rng(7)
    y = rng.random((4, 64, 64, 1)).astype(np.float32)
    x = torch.from_numpy(np.clip(y + rng.normal(0, 0.1, y.shape), 0, 1).astype(np.float32))
    y = torch.from_numpy(y)

    def enhanced():
        return EnhancedUNet(init_features=2, generator=torch.Generator().manual_seed(0))

    one = VmappedTrialGroup(enhanced(), _trials([(1e-3, 1e-5)], 4), seed=0, device="cpu")
    assert one.stateful and "enc1.bn1.mean" in one.model_state
    m = enhanced()
    state = TrainState(model=m, optimizer=make_optimizer(m, 1e-3, 1e-5, 1.0),
                       generator=torch.Generator().manual_seed(5))
    one.generator.manual_seed(5)
    body = make_step_body(stateful=True)
    for _ in range(2):
        got = one._train_step(x, y)
        state, want = body(state, x, y)
        assert got.item() == want.item()
    assert torch.equal(one.generator.get_state(), state.generator.get_state())
    for name, b in m.named_buffers():
        assert torch.equal(one.model_state[name][0], b), name
    for name, p in m.named_parameters():
        assert torch.equal(one.params[name][0], p.detach()), name

    g = VmappedTrialGroup(enhanced(), _trials([(1e-3, 1e-5)] * 2, 4), seed=0, device="cpu")
    stats0 = {k: v.clone() for k, v in g.model_state.items()}
    losses = g.train_epoch(ArrayLoader(x.numpy(), y.numpy(), 4), 0)
    assert np.isfinite(losses).all() and losses[0] == losses[1]
    assert any(not torch.allclose(g.model_state[k], v) for k, v in stats0.items())
    for tree in (g.params, g.model_state):
        for k, v in tree.items():
            assert torch.equal(v[0], v[1]), k
    assert np.isfinite(g.val_epoch(ArrayLoader(x.numpy(), y.numpy(), 4))).all()
    g.keep([1])
    assert all(v.shape[0] == 1 for v in g.model_state.values())
    snap = g.snapshot_of(0)
    assert set(snap) == {"params", "batch_stats"}
    assert flatten_tree(snap["batch_stats"]).keys() == flatten_tree(
        export_jax_batch_stats(m)).keys()
    assert flatten_tree(snap["params"]).keys() == flatten_tree(export_jax_params(m)).keys()


def test_mask_halving_matches_compact(toy):
    """Halving gathers the survivors into a smaller group; the survivors
    train on as under the JAX package's mask mode, where the dropped slots
    keep training beside them (here: a group that keeps all four)."""
    x, y = toy
    loader = ArrayLoader(x, y, 8)
    cfg = [(1e-3 * (i + 1), 1e-5) for i in range(4)]
    gc, gm = _group(cfg=cfg), _group(cfg=cfg)
    for g in (gc, gm):
        g.train_epoch(loader, 0)
    gc.keep([2, 0])
    assert [t.trial_id for t in gc.trials] == [2, 0] and gc.lrs.shape == (2,)
    live = [2, 0]
    np.testing.assert_allclose(gm.train_epoch(loader, 1)[live], gc.train_epoch(loader, 1),
                               rtol=1e-6)
    vc, vm = gc.val_epoch(loader), gm.val_epoch(loader)
    np.testing.assert_allclose(vm[live], vc, rtol=1e-6)
    gc.step_schedulers(vc)
    gm.step_schedulers(vm)
    np.testing.assert_array_equal(gm.lrs.numpy()[live], gc.lrs.numpy())
    for i, s in enumerate(live):
        for a, b in zip(flatten_tree(gm.snapshot_of(s)).values(),
                        flatten_tree(gc.snapshot_of(i)).values()):
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("case", ["one_plateaus", "all_plateau"])
def test_early_stop_patience_retires_and_compacts(tmp_path, toy, monkeypatch, case):
    """tests/test_sweep.py's two patience cases on the port: a trial whose
    val loss stops improving retires after ``patience`` stale epochs and
    still wins best-trial selection; every trial plateauing retires the
    whole group (keep([])). Each retirement shrinks the stacked state."""
    sweep_mod = sys.modules[VmappedTrialGroup.__module__]
    monkeypatch.setattr(VmappedTrialGroup, "train_epoch",
                        lambda self, loader, epoch: np.zeros(len(self.trials)))
    sizes = []

    def fake_val(self, loader):
        sizes.append({int(v.shape[0]) for v in (*self.params.values(), self.lrs, self.wds)})
        if case == "all_plateau":
            return np.full(len(self.trials), 0.3)
        # trial 0 plateaus at the overall-best loss; trial 1 keeps
        # improving but never catches up
        return np.array([0.1 if t.trial_id == 0 else 0.5 - 0.02 * len(t.val_losses)
                         for t in self.trials])

    monkeypatch.setattr(VmappedTrialGroup, "val_epoch", fake_val)
    epochs = 6 if case == "one_plateaus" else 8
    result = sweep_mod.run_sweep(_tiny, _loaders(*toy), n_trials=2, max_epochs=epochs,
                                 min_iter=epochs, eta=2, method="random", seed=0,
                                 output_dir=str(tmp_path), space=SearchSpace(batch_sizes=(8,)),
                                 early_stop_patience=2, device="cpu")
    by_id = {t["trial_id"]: t for t in result["trials"]}
    if case == "all_plateau":
        assert sizes == [{2}] * 3
        for t in result["trials"]:
            assert t["stopped_at"] == 3 and t["epochs_run"] == 3
        assert result["best"]["best_val_loss"] == pytest.approx(0.3)
        return
    assert sizes == [{2}] * 3 + [{1}] * 3
    assert (by_id[0]["stopped_at"], by_id[0]["epochs_run"], by_id[0]["stop_reason"]) == \
        (3, 3, "patience")
    assert (by_id[1]["stopped_at"], by_id[1]["epochs_run"], by_id[1]["stop_reason"]) == \
        (None, 6, None)
    assert result["best"]["trial_id"] == 0
    assert result["best"]["best_val_loss"] == pytest.approx(0.1)
    assert (tmp_path / "best_trial_params.npz").exists()


@pytest.mark.parametrize("augment", [False, True])
def test_resident_epoch_equals_the_per_step_epoch(toy, augment):
    """shuffle=False resident epoch == the per-step epoch over the same
    sequential batches, with the same augmentation draws; identical trials
    see one shared stream."""
    x, y = toy
    cfg = [(1e-3, 1e-5)] * 2 if augment else CFG[:2]
    aug = device_augment_batch if augment else None
    g_step, g_res = _group(cfg=cfg, augment_fn=aug), _group(cfg=cfg, augment_fn=aug)
    loader = ArrayLoader(x, y, 8)
    want = g_step.train_epoch(loader, 0)
    data = cache_on_device(loader, device="cpu", device_bytes=CPU)
    got = g_res.train_epoch_resident(data, 0, shuffle=False)
    np.testing.assert_array_equal(got, want)
    for k, v in g_step.params.items():
        assert torch.equal(g_res.params[k], v), k
    if augment:
        assert got[0] == got[1]
        assert not np.allclose(got, _group(cfg=cfg).train_epoch(loader, 0))
    shuffled = g_res.train_epoch_resident(data, 1)
    assert np.isfinite(shuffled).all()


def test_config_dataclasses_equal_jax():
    for name in ("DataConfig", "TrainConfig", "EvalConfig", "ServeConfig", "SweepConfig"):
        assert (port_config.dataclasses.asdict(getattr(port_config, name)())
                == jax_config.dataclasses.asdict(getattr(jax_config, name)())), name
    argv = ["--sweep_count", "3", "--batch_sizes", "4,8", "--lr_min", "2e-4"]
    assert (port_config.from_args(port_config.SweepConfig, argv)
            == port_config.SweepConfig(sweep_count=3, batch_sizes=(4, 8), lr_min=2e-4))
    assert (port_config.dataclasses.asdict(port_config.from_args(port_config.SweepConfig, argv))
            == jax_config.dataclasses.asdict(jax_config.from_args(jax_config.SweepConfig,
                                                                  argv)))


def _loaders(x, y):
    def loader_factory(bs):
        return (ArrayLoader(x, y, bs, min_one_batch=True),
                ArrayLoader(x[:8], y[:8], bs, min_one_batch=True))
    return loader_factory


def test_run_sweep_from_config_and_refusals(tmp_path, toy):
    x, y = toy
    cfg = port_config.SweepConfig(sweep_count=2, max_epochs=1, hyperband_min_iter=1, eta=2,
                                  batch_sizes=(8,), parallel_trials=1)
    result = run_sweep_from_config(_tiny, _loaders(x, y), cfg, output_dir=str(tmp_path),
                                   method="random", device="cpu")
    assert len(result["trials"]) == 2 and result["best"] is not None
    # a mesh owns the device (sweeps over ranks are
    # tests/test_torch_port_sweep_mesh.py): another one beside it raises
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        run_sweep(_tiny, _loaders(x, y), mesh=make_mesh(device="cpu"), device="cuda")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        VmappedTrialGroup(_tiny(), _trials(), mesh=make_mesh(device="cpu"), device="cuda")
    with pytest.raises(ValueError, match="validation set is empty"):
        run_sweep(_tiny, lambda bs: ([], []), n_trials=2, max_epochs=1, min_iter=1,
                  method="random", output_dir=str(tmp_path / "e"),
                  space=SearchSpace(batch_sizes=(8,)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_sweep(_tiny, _loaders(x, y), output_dir=str(tmp_path / "c"))


class _FakeRun:
    def __init__(self, config, stop_after, kwargs):
        self.config, self.kwargs = config, kwargs
        self.summary, self.logged, self.finished = {}, [], False
        self._stop_after = stop_after

    def log(self, rec, step=None):
        self.logged.append((rec, step))

    def should_stop(self):
        return self._stop_after is not None and len(self.logged) >= self._stop_after

    def finish(self):
        self.finished = True


class _FakeWandb(types.ModuleType):
    """wandb stand-in: a sweep server (fixed proposals, one Hyperband stop)
    and the run API the mirror uses."""

    def __init__(self, proposals=(), stop_trial=None, fail_sweep=False):
        super().__init__("wandb")
        self.proposals, self.stop_trial, self.fail_sweep = list(proposals), stop_trial, fail_sweep
        self.sweeps, self.agents, self.runs = [], [], []

    def sweep(self, config, project=None, entity=None):
        if self.fail_sweep:
            raise RuntimeError("401 unauthorized")
        self.sweeps.append((config, project, entity))
        return "sw-fake-1"

    def init(self, **kwargs):
        i = len(self.runs)
        proposal = self.proposals[i] if i < len(self.proposals) else None
        run = _FakeRun(proposal, 1 if i == self.stop_trial else None, kwargs)
        run.sweep_id_at_init = os.environ.get("WANDB_SWEEP_ID")
        self.runs.append(run)
        return run

    def agent(self, sweep_id, function=None, count=None):
        self.agents.append((sweep_id, count))
        for _ in range(count):
            function()


PROPOSALS = [{"batch_size": 8, "learning_rate": 3e-3, "weight_decay": 1e-5},
             {"batch_size": 8, "learning_rate": 1e-3, "weight_decay": 5e-5},
             {"batch_size": 8, "learning_rate": 5e-4, "weight_decay": 2e-6}]


@pytest.mark.parametrize("case", ["mirror", "mirror_offline", "agent", "agent_rejoin"])
def test_wandb_paths_against_a_fake_server(tmp_path, toy, monkeypatch, case):
    x, y = toy
    monkeypatch.delenv("WANDB_SWEEP_ID", raising=False)
    space = SearchSpace(batch_sizes=(8,))
    if case.startswith("mirror"):
        fake = _FakeWandb(fail_sweep=case == "mirror_offline")
        monkeypatch.setitem(sys.modules, "wandb", fake)
        mirror = WandbSweepMirror(project="proj-x", entity="team-x")
        result = run_sweep(_tiny, _loaders(x, y), n_trials=4, max_epochs=3, min_iter=1, eta=2,
                           method="tpe", seed=0, output_dir=str(tmp_path), space=space,
                           wandb_mirror=mirror, device="cpu")
        assert len(fake.runs) == 4  # one run per trial, dropped trials included
        sweep_id = None if case == "mirror_offline" else "sw-fake-1"
        assert mirror.sweep_id == sweep_id
        if sweep_id:
            (cfg, proj, ent), = fake.sweeps
            assert cfg == jax_sweep.sweep_server_config("tpe", 1, 2, jax_sweep.SearchSpace(
                batch_sizes=(8,)))
            assert (proj, ent) == ("proj-x", "team-x")
        by_name = {r.kwargs["name"]: r for r in fake.runs}
        for t in result["trials"]:
            run = by_name[f"trial_{t['trial_id']}"]
            assert run.sweep_id_at_init == sweep_id
            assert run.kwargs["group"] == mirror.group and run.kwargs["entity"] == "team-x"
            assert run.kwargs["config"] == {"batch_size": t["batch_size"], "lr": t["lr"],
                                            "weight_decay": t["wd"]}
            assert len(run.logged) == t["epochs_run"] and run.finished
            assert run.summary["best_val_loss"] == pytest.approx(t["best_val_loss"])
            assert run.summary["final_model_size_mb"] == get_model_size_mb(
                export_jax_params(_tiny()))
        assert "WANDB_SWEEP_ID" not in os.environ
        return
    fake = _FakeWandb(PROPOSALS, stop_trial=1)
    sweep_id = "sw-existing" if case == "agent_rejoin" else None
    result = run_wandb_agent_sweep(_tiny, _loaders(x, y), n_trials=3, max_epochs=3, min_iter=1,
                                   eta=2, seed=0, output_dir=str(tmp_path), space=space,
                                   project="p", entity="e", sweep_id=sweep_id,
                                   wandb_module=fake, device="cpu")
    if sweep_id:
        assert fake.sweeps == [] and fake.agents == [("sw-existing", 3)]
    else:
        (cfg, proj, ent), = fake.sweeps
        assert cfg == jax_sweep.sweep_server_config("wandb", 1, 2, jax_sweep.SearchSpace(
            batch_sizes=(8,)))
        assert fake.agents == [("sw-fake-1", 3)]
    assert [t["lr"] for t in result["trials"]] == [p["learning_rate"] for p in PROPOSALS]
    t0, t1, t2 = result["trials"]
    assert t1["stop_reason"] == "server" and t1["epochs_run"] == 1
    assert t0["epochs_run"] == t2["epochs_run"] == 3
    saved = json.load(open(tmp_path / "sweep_results.json"))
    assert saved["sweep_id"] == result["sweep_id"] == (sweep_id or "sw-fake-1")
    assert result["best"]["best_val_loss"] == min(t["best_val_loss"] for t in result["trials"])
    assert (tmp_path / "best_trial_params.npz").exists()


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep_data")
    generate_synthetic_sd1(str(root), n_train=24, n_val=0, size=32)
    return str(root / "train")


def test_cli_sweep_on_the_cpu(tmp_path, sweep_data, capsys):
    """cli.sweep --device cpu end to end (the JAX recipe's flags), then its
    resume of the finished sweep restores every group from the journal."""
    out = str(tmp_path / "sw")
    argv = ["--data_dir", sweep_data, "--output_dir", out, "--sweep_count", "3",
            "--max_epochs", "2", "--early_stop_min_iter", "1", "--eta", "2", "--image_size",
            "32", "--method", "random", "--num_workers", "2", "--device", "cpu"]
    port_cli.main(argv)
    text = capsys.readouterr().out
    assert "restricting sweep batch sizes to (4, 8, 16)" in text
    result = json.load(open(f"{out}/sweep_results.json"))
    best = result["best"]
    assert f"Best trial: id={best['trial_id']} batch_size={best['batch_size']}" in text
    assert len(result["trials"]) == 3 and np.isfinite(best["best_val_loss"])
    tree = load_npz_tree(f"{out}/best_trial_params.npz")
    assert tree.keys() == export_jax_params(LightweightUNet()).keys()
    meta = json.loads(open(f"{out}/sweep_journal.jsonl").readline())["meta"]
    assert meta["fingerprint"]["model"] == "basic" and meta["n_trials"] == 3
    port_cli.main(argv[:2] + argv[4:] + ["--resume", out])
    assert json.load(open(f"{out}/sweep_results.json")) == result


@pytest.mark.parametrize("flags, match", [
    (["--process_id", "0"], "require --distributed"),
    (["--distributed", "--method", "wandb"], "does not compose with --distributed"),
    (["--coordinator_address", "localhost:1234"], "require --distributed"),
    (["--method", "wandb", "--device", "cpu"], "--method tpe"),
])
def test_cli_sweep_refusals(tmp_path, sweep_data, monkeypatch, flags, match):
    monkeypatch.setitem(sys.modules, "wandb", None)  # offline: no wandb to import
    with pytest.raises(SystemExit, match=match):
        port_cli.main(["--data_dir", sweep_data, "--output_dir", str(tmp_path), *flags])


def test_cli_sweep_defaults_to_cuda(tmp_path, sweep_data):
    assert port_cli.parse_args(["--data_dir", "d"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["--data_dir", sweep_data, "--output_dir", str(tmp_path)])
