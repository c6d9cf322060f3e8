"""The port's ``run_sweep`` end to end against the JAX package's, its
artifact read both ways, and its journal: preemption, resume and the
refusals, on the CPU.

Both sweeps start every group from the same weights (JAX's
``model.init(PRNGKey(seed))``, loaded into the port's factory module)
and read the same arrays (``tests/loaders.ArrayLoader``). The JAX side runs
with ``mesh=None`` on one device and ``halving="mask"``, which compiles
its group step once; the port takes both halving values and compacts
for either. Gates:

- the trial schedule (ids, batch sizes, lr, wd) equal bit for bit, and
  every epoch's val loss within rel 1e-4 (read: <= 2.1e-6);
- what ranks decide (halving drops, stop epochs and reasons, TPE's second
  wave, the best trial) equal wherever the val losses a rank compares lie
  further apart than that tolerance; the test prints the smallest such
  margin, and fails if a margin is below it (the data would then not
  decide the ranks);
- the artifact: ``best_trial_params.npz`` has the JAX file's keys and
  shapes, and each package's file, loaded into the other's model, gives
  that model's forward within 1e-5 of the writer's;
- resume: an interrupted and resumed sweep equals the uninterrupted one
  exactly (a resume replays the schedule and restores journaled groups
  without training).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.parallel import sweep as jax_sweep
from image_enhancement_deglaring_tpu.utils.pytree import load_npz_tree as jax_load_npz
from image_enhancement_deglaring_tpu_torch.modelio import load_jax_params
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.parallel import SearchSpace, run_sweep
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from image_enhancement_deglaring_tpu_torch.utils.pytree import load_npz_tree
from tests.loaders import ArrayLoader

SIZE, SEED = 16, 0
EPOCH_REL = 1e-4
# the JAX tests' sweeps (tests/test_sweep.py): random with halving at every
# epoch, and TPE's two waves
RUNS = {
    "random": dict(n_trials=4, max_epochs=3, min_iter=1, eta=2, method="random"),
    "tpe": dict(n_trials=6, max_epochs=2, min_iter=2, eta=2, method="tpe"),
}


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


def _jax_tiny():
    return JaxUNet(features_start=2, num_groups=2)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX group's starting weights (VmappedTrialGroup's own init)."""
    variables = jax.jit(_jax_tiny().init)(jax.random.PRNGKey(SEED), jnp.zeros((1, 64, 64, 1)))
    return jax.tree_util.tree_map(np.array, variables["params"])


class _Factory:
    """The port's model factory on JAX's init; counts the groups built."""

    def __init__(self, params):
        self.params, self.calls = params, 0

    def __call__(self):
        self.calls += 1
        m = LightweightUNet(features_start=2, num_groups=2)
        load_jax_params(m, self.params)
        return m


def _loaders(x, y):
    def loader_factory(bs):
        return (ArrayLoader(x, y, bs, min_one_batch=True),
                ArrayLoader(x[:8], y[:8], bs, min_one_batch=True))
    return loader_factory


def _port(jax_init, toy, out, run, **kw):
    return run_sweep(_Factory(jax_init), _loaders(*toy), seed=SEED, output_dir=str(out),
                     space=SearchSpace(batch_sizes=(8,)), device="cpu", **RUNS[run], **kw)


@pytest.fixture(scope="module")
def jax_runs(toy, tmp_path_factory):
    out = {}
    for run in RUNS:
        d = tmp_path_factory.mktemp(f"jax_{run}")
        out[run] = (jax_sweep.run_sweep(_jax_tiny, _loaders(*toy), seed=SEED, output_dir=str(d),
                                        space=jax_sweep.SearchSpace(batch_sizes=(8,)),
                                        halving="mask", **RUNS[run]), d)
    return out


def _journal_trials(path) -> list[dict]:
    with open(path) as f:
        return [t for ln in f if "group" in (rec := json.loads(ln)) for t in rec["group"]]


def _rank_margin(journal: list[dict]) -> float:
    """The smallest relative gap between two trials' val losses at the same
    epoch: every halving rank and best-trial choice compares such values
    (their running minima)."""
    by_epoch: dict = {}
    for t in journal:
        for e, v in enumerate(t["val_losses"]):
            by_epoch.setdefault(e, []).append(min(t["val_losses"][: e + 1]))
    gaps = [abs(a - b) / max(abs(a), abs(b)) for vs in by_epoch.values()
            for i, a in enumerate(vs) for b in vs[i + 1:]]
    return min(gaps) if gaps else float("inf")


@pytest.mark.parametrize("run, halving", [("random", "compact"), ("random", "mask"),
                                          ("tpe", "compact")])
def test_run_sweep_matches_jax(tmp_path, toy, jax_init, jax_runs, run, halving):
    want, jax_dir = jax_runs[run]
    got = _port(jax_init, toy, tmp_path, run, halving=halving)
    want_j = {t["trial_id"]: t for t in _journal_trials(jax_dir / "sweep_journal.jsonl")}
    got_j = {t["trial_id"]: t for t in _journal_trials(tmp_path / "sweep_journal.jsonl")}
    margin = _rank_margin(list(want_j.values()))
    print(f"{run}/{halving}: smallest rank margin {margin:.3g} (tolerance {EPOCH_REL})")
    assert margin > EPOCH_REL, "the data do not decide the ranks at this tolerance"
    fields = ("trial_id", "batch_size", "lr", "wd", "epochs_run", "stopped_at", "stop_reason")
    assert [{k: t[k] for k in fields} for t in got["trials"]] == \
        [{k: t[k] for k in fields} for t in want["trials"]]
    assert got["best"]["trial_id"] == want["best"]["trial_id"]
    for i, t in want_j.items():
        np.testing.assert_allclose(got_j[i]["val_losses"], t["val_losses"], rtol=EPOCH_REL)
    if run == "random":
        assert {t["stop_reason"] for t in got["trials"]} == {"halving", None}
    else:
        assert sorted(got_j) == list(range(6))


def test_best_params_load_both_ways(tmp_path, toy, jax_init, jax_runs):
    """Each package's best_trial_params.npz has the other's keys and
    shapes, and loaded into the other's model gives the writer's
    forward."""
    _port(jax_init, toy, tmp_path, "random")
    port_tree = jax_load_npz(str(tmp_path / "best_trial_params.npz"))
    jax_tree = load_npz_tree(str(jax_runs["random"][1] / "best_trial_params.npz"))
    shapes = {k: v.shape for k, v in flatten_tree(jax_init).items()}
    for tree in (port_tree, jax_tree):
        assert {k: np.shape(v) for k, v in flatten_tree(tree).items()} == shapes
    x = toy[0][:4]
    for tree in (port_tree, jax_tree):
        m = LightweightUNet(features_start=2, num_groups=2)
        load_jax_params(m, jax.tree_util.tree_map(np.array, tree))
        with torch.no_grad():
            port_out = m(torch.from_numpy(x)).numpy()
        jax_out = np.asarray(_jax_tiny().apply({"params": tree}, jnp.asarray(x)))
        np.testing.assert_allclose(port_out, jax_out, rtol=0, atol=1e-5)


class _TriggerAfter:
    """PreemptionGuard stand-in whose flag flips after ``n`` checks."""

    def __init__(self, n: int):
        self.n, self.calls = n, 0

    @property
    def triggered(self) -> bool:
        self.calls += 1
        return self.calls > self.n


def _kwargs(tmp_path, sub, **kw):
    return {**dict(n_trials=4, max_epochs=2, min_iter=2, eta=2, method="random", seed=0,
                   max_parallel_trials=1, space=SearchSpace(batch_sizes=(8,)),
                   output_dir=str(tmp_path / sub), device="cpu"), **kw}


@pytest.fixture(scope="module")
def uninterrupted(toy, jax_init, tmp_path_factory):
    f = _Factory(jax_init)
    a = run_sweep(f, _loaders(*toy), **_kwargs(tmp_path_factory.mktemp("full"), "a"))
    assert f.calls == 4 and a["preempted"] is False
    return a


@pytest.mark.parametrize("method", ["random", "tpe"])
def test_preempted_sweep_resumes_to_identical_result(tmp_path, toy, jax_init, method):
    """Preempt inside group 2, resume, preempt again, resume: journaled
    groups never retrain and are never re-appended; the end equals the
    uninterrupted sweep trial for trial. TPE's second wave is fitted on the
    restored history."""
    n = 6 if method == "tpe" else 4
    kw = _kwargs(tmp_path, "pre", method=method, n_trials=n)
    full = run_sweep(_Factory(jax_init), _loaders(*toy), **_kwargs(tmp_path, "full",
                                                                   method=method, n_trials=n))
    out = tmp_path / "pre"
    # guard checks per group: 1 between groups + 1 per epoch (2 epochs);
    # n=4 trips inside group 2
    f = _Factory(jax_init)
    b = run_sweep(f, _loaders(*toy), preempt_guard=_TriggerAfter(4), **kw)
    assert b["preempted"] is True and f.calls == 2 and len(b["trials"]) == 1
    assert not (out / "sweep_results.json").exists()
    f = _Factory(jax_init)
    c = run_sweep(f, _loaders(*toy), resume=True, preempt_guard=_TriggerAfter(4), **kw)
    assert c["preempted"] and f.calls == 2 and len(c["trials"]) == 2
    f = _Factory(jax_init)
    d = run_sweep(f, _loaders(*toy), resume=True, **kw)
    assert f.calls == n - 2 and d["preempted"] is False
    assert d["trials"] == full["trials"] and d["best"] == full["best"]
    with open(out / "sweep_journal.jsonl") as fh:
        assert sum("group" in json.loads(ln) for ln in fh) == n
    assert json.load(open(out / "sweep_results.json"))["best"] == full["best"]


def test_torn_journal_tail_is_dropped(tmp_path, toy, jax_init, uninterrupted):
    kw = _kwargs(tmp_path, "torn")
    run_sweep(_Factory(jax_init), _loaders(*toy), preempt_guard=_TriggerAfter(4), **kw)
    journal = tmp_path / "torn" / "sweep_journal.jsonl"
    with open(journal, "a") as f:
        f.write('{"group": [{"trial_id": 1, "batch')  # a kill mid-append
    r = run_sweep(_Factory(jax_init), _loaders(*toy), resume=True, **kw)
    assert r["trials"] == uninterrupted["trials"]
    lines = journal.read_text().splitlines()
    assert all(json.loads(ln) for ln in lines) and len(lines) == 5


@pytest.mark.parametrize("drift", ["seed", "flags", "fingerprint", "missing", "corrupt"])
def test_resume_refusals(tmp_path, toy, jax_init, drift):
    kw = _kwargs(tmp_path, "r", fingerprint={"model": "basic"})
    run_sweep(_Factory(jax_init), _loaders(*toy), preempt_guard=_TriggerAfter(4), **kw)
    journal = tmp_path / "r" / "sweep_journal.jsonl"
    if drift == "seed":
        kw["seed"], err, match = 1, ValueError, "different flags"
    elif drift == "flags":
        kw["max_epochs"], err, match = 3, ValueError, "different flags"
    elif drift == "fingerprint":
        kw["fingerprint"], err, match = {"model": "enhanced"}, ValueError, "different flags"
    elif drift == "missing":
        os.remove(journal)
        err, match = FileNotFoundError, "no sweep journal"
    else:  # a torn line that is not the last is corruption, not a kill
        lines = journal.read_text().splitlines()
        journal.write_text("\n".join([lines[0], lines[1][:20], *lines[1:]]) + "\n")
        err, match = ValueError, "corrupt sweep journal"
    with pytest.raises(err, match=match):
        run_sweep(_Factory(jax_init), _loaders(*toy), resume=True, **kw)
