"""The port's sweeps over a data mesh (``parallel.sweep`` with ``mesh=``,
``cli.sweep --n_devices / --distributed``) on the CPU: two processes joined
by Gloo (``tests/torch_port_sweep_mesh_worker.py``, started through
``parallel.distributed.launch_local``), the toy LightweightUNet (width 2,
2 groups) at 32x32 on the JAX two-host test's 16 seeded samples.

Held, against the port's one-process runs (the worker's phase functions
with ``mesh=None``) and the JAX package's over ``make_mesh(2)``:

- layout: a group of 3 trials pads to 4 slots and of 5 to 6, 2 and 3 per
  rank; ``keep(mode="compact")`` re-pads the survivors to a multiple of
  the world, ``keep(mode="mask")`` keeps every slot;
- losses: both ranks agree bit for bit; per epoch, train and validation
  losses equal one process within rtol 2e-5 (the JAX mesh-vs-one-device
  test's, tests/test_sweep_resident.py) and, for the group of 3, JAX's
  group over a 2-device mesh within rel 1e-5 (tests/test_torch_port_sweep.py's); masked
  survivors equal compacted ones within rtol 1e-6; the resident group over
  ranks equals one process within rtol 2e-5;
- ``run_sweep`` over two ranks: JAX's ``run_sweep(mesh=make_mesh(2),
  halving="mask")`` best trial and per-trial best val losses within rtol
  1e-5 (tests/test_distributed.py), and one process's; rank 0 alone
  writes the files;
- a preempted sweep whose journal is on rank 0 only resumes to the
  uninterrupted result on both ranks (rank 0 broadcasts the journal);
- ``run_wandb_agent_sweep`` with the fake server on rank 0 only: the same
  trials as one process, one registration and one agent;
- ``cli.sweep --n_devices 2 --device cpu`` gives one process's trials and
  best trial (val losses within rtol 2e-5), and the CLI refuses what the
  JAX CLI refuses.

The run and the references are computed once per test session: under
pytest-xdist the first worker to need them computes them under a file lock
in the session's shared temporary directory, and the others read them.
"""

import fcntl
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.parallel import make_mesh as jax_make_mesh
from image_enhancement_deglaring_tpu.parallel import sweep as jax_sweep
from image_enhancement_deglaring_tpu_torch.cli import sweep as sweep_cli
from image_enhancement_deglaring_tpu_torch.parallel import distributed
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from tests import torch_port_sweep_mesh_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_sweep_mesh_worker.py")
RANKS_RTOL = 2e-5    # tests/test_sweep_resident.py: a mesh against one device
JAX_REL = 1e-5       # tests/test_torch_port_sweep.py: the port's group against JAX's
SWEEP_RTOL = 1e-5    # tests/test_distributed.py: the two-host sweep
MASK_RTOL = 1e-6     # tests/test_torch_port_sweep.py: halving's survivors


def _jax_init(seed: int) -> dict:
    """The JAX group's starting weights (VmappedTrialGroup's own init)."""
    variables = jax.jit(JaxUNet(features_start=2, num_groups=2).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 1)))
    return jax.tree_util.tree_map(np.array, variables["params"])


def _jax_group(n: int, keep=None) -> dict:
    """JAX's group of ``n`` trials over a 2-device mesh, as the worker's
    ``group_run``."""
    train, val = worker.loaders(worker.BS)
    trials = [jax_sweep.Trial(i, worker.BS, *worker.CFG[i]) for i in range(n)]
    g = jax_sweep.VmappedTrialGroup(JaxUNet(features_start=2, num_groups=2), trials,
                                    mesh=jax_make_mesh(2), seed=0)
    out = {"n_phys": int(g.lrs.shape[0]), "train": [], "val": []}
    for e in range(2):
        out["train"].append(g.train_epoch(train, e).tolist())
        v = g.val_epoch(val)
        out["val"].append(v.tolist())
        g.step_schedulers(v)
    if keep is not None:  # the re-padded layout (training on it would compile again)
        g.keep(keep, mode="compact")
        out["n_phys_kept"] = int(g.lrs.shape[0])
    return out


def _jax_sweep(out_dir: str) -> dict:
    res = jax_sweep.run_sweep(lambda: JaxUNet(features_start=2, num_groups=2), worker.loaders,
                              mesh=jax_make_mesh(2), output_dir=out_dir, halving="mask",
                              space=jax_sweep.SearchSpace(batch_sizes=(8,)), **worker.SWEEP)
    return {"best_id": res["best"]["trial_id"],
            "vals": [t["best_val_loss"] for t in res["trials"]]}


def _run(root: str) -> dict:
    np.savez(os.path.join(root, "init0.npz"), **flatten_tree(_jax_init(0)))
    env = {"PATH": os.environ.get("PATH", ""), "HOME": os.environ.get("HOME", ""),
           "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
    proc = subprocess.Popen([sys.executable, WORKER, root], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # the references run here while the ranks train
        f0 = worker.Factory(os.path.join(root, "init0.npz"))
        refs = {"group3": worker.group_run(f0, 3, keep=[0, 2]),
                "group5": worker.group_run(f0, 5),
                "resident": worker.resident_run(f0),
                "sweep": worker.sweep_run(f0, os.path.join(root, "one_sweep")),
                "wandb": worker.wandb_run(f0, os.path.join(root, "one_wandb")),
                "jax_group3": _jax_group(3, keep=[0, 2]),
                "jax_sweep": _jax_sweep(os.path.join(root, "jax_sweep"))}
        log = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"the worker failed:\n{log[-4000:]}"
    ranks = [json.load(open(os.path.join(root, f"r{r}.json"))) for r in (0, 1)]
    cli = json.load(open(os.path.join(root, "cli.json")))
    return {"ranks": ranks, "refs": refs, "cli": cli, "log": log[-4000:]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 2-rank run and its references, once per session (see the module
    docstring)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if not os.environ.get("PYTEST_XDIST_WORKER"):
            return _run(str(tmp_path_factory.mktemp("sweep_mesh")))
        root = tmp_path_factory.getbasetemp().parent / "torch_port_sweep_mesh"
        root.mkdir(exist_ok=True)
        with open(root / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            done = root / "result.json"
            if not done.exists():
                done.write_text(json.dumps(_run(str(root))))
            return json.loads(done.read_text())
    finally:
        torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("phase", ["group3", "group3_mask", "group5", "resident", "sweep",
                                   "resume", "wandb"])
def test_ranks_agree(run, phase):
    r0, r1 = run["ranks"]
    if phase in ("sweep", "resume", "wandb"):  # what each rank wrote differs by design
        keys = {"sweep": ("best_id", "best_val", "vals", "trials"),
                "resume": ("preempted", "pre_trials", "resumed_matches_full"),
                "wandb": ("best_id", "best_val", "vals", "trials", "sweep_id")}[phase]
        assert {k: r0[phase][k] for k in keys} == {k: r1[phase][k] for k in keys}
    else:
        assert r0[phase] == r1[phase]


@pytest.mark.parametrize("n, slots", [(3, 4), (5, 6)])
def test_trial_axis_pads_to_a_multiple_of_the_world(run, n, slots):
    got = run["ranks"][0][f"group{n}"]
    assert got["n_phys"] == slots and got["k"] == slots // 2
    if n == 3:
        assert run["refs"]["jax_group3"]["n_phys"] == slots
    assert run["refs"][f"group{n}"]["n_phys"] == n  # one process pads nothing


def test_compact_repads_and_mask_keeps_the_slots(run):
    compact, mask = run["ranks"][0]["group3"], run["ranks"][0]["group3_mask"]
    assert (compact["n_phys_kept"], compact["k_kept"]) == (2, 1)
    assert (mask["n_phys_kept"], mask["k_kept"]) == (4, 2)
    assert run["refs"]["jax_group3"]["n_phys_kept"] == 2  # JAX re-pads the same way
    for kind in ("train", "val"):
        np.testing.assert_allclose(mask[kind][2], compact[kind][2], rtol=MASK_RTOL)
        assert mask[kind][:2] == compact[kind][:2]
    np.testing.assert_allclose(mask["snapshots"], compact["snapshots"], rtol=MASK_RTOL)


@pytest.mark.parametrize("phase", ["group3", "group5", "resident"])
def test_two_ranks_equal_one_process(run, phase):
    got, want = run["ranks"][0][phase], run["refs"][phase]
    for kind in ("train", "val"):
        assert len(got[kind]) == len(want[kind])
        for g, w in zip(got[kind], want[kind]):
            np.testing.assert_allclose(g, w, rtol=RANKS_RTOL)
    if "snapshots" in want:  # the surviving trials' weights, gathered from their ranks
        np.testing.assert_allclose(got["snapshots"], want["snapshots"], rtol=RANKS_RTOL)


def test_two_ranks_equal_jax_over_a_two_device_mesh(run):
    """The group of 3, padded to 4 slots, over its two epochs."""
    got, want = run["ranks"][0]["group3"], run["refs"]["jax_group3"]
    for kind in ("train", "val"):
        for e in range(2):
            assert _rel(got[kind][e], want[kind][e]) <= JAX_REL, (kind, e)


def test_run_sweep_over_two_ranks_equals_jax_and_one_process(run):
    got = run["ranks"][0]["sweep"]
    for want in (run["refs"]["jax_sweep"], run["refs"]["sweep"]):
        assert got["best_id"] == want["best_id"]
        np.testing.assert_allclose(got["vals"], want["vals"], rtol=SWEEP_RTOL)
    assert "forcing halving='mask'" in run["log"]


@pytest.mark.parametrize("phase", ["sweep", "wandb"])
def test_only_rank_zero_writes(run, phase):
    r0, r1 = run["ranks"]
    assert r0[phase]["wrote_results"] and r0[phase]["wrote_params"]
    assert not (r1[phase]["wrote_results"] or r1[phase]["wrote_params"]
                or r1[phase]["wrote_journal"])
    assert r0[phase]["wrote_journal"] == (phase == "sweep")


def test_resume_with_the_journal_on_rank_zero_only(run):
    r0, r1 = run["ranks"]
    for r in (r0, r1):
        assert r["resume"]["preempted"] and r["resume"]["pre_trials"] == 1
        assert r["resume"]["resumed_matches_full"]
    assert r0["resume"]["journal_local"] and not r1["resume"]["journal_local"]
    assert r0["resume"]["results_written"] and not r1["resume"]["results_written"]


def test_wandb_agent_over_two_ranks_equals_one_process(run):
    got, want = run["ranks"][0]["wandb"], run["refs"]["wandb"]
    assert got["server"] == want["server"] == {"sweeps": 1, "agents": [["sw-fake-1", 3]],
                                               "logged": [3, 1, 3]}
    assert "server" not in run["ranks"][1]["wandb"]  # rank 1 never talked to the server
    assert [t["stop_reason"] for t in got["trials"]] == [None, "server", None]
    assert got["best_id"] == want["best_id"] and got["sweep_id"] == want["sweep_id"]
    np.testing.assert_allclose(got["vals"], want["vals"], rtol=RANKS_RTOL)


def test_cli_sweep_over_two_devices_equals_one_process(run):
    one, two = run["cli"]["one"], run["cli"]["two"]
    fields = ("trial_id", "batch_size", "lr", "wd", "epochs_run", "stopped_at", "stop_reason")
    assert ([{k: t[k] for k in fields} for t in two["trials"]]
            == [{k: t[k] for k in fields} for t in one["trials"]])
    assert two["best"]["trial_id"] == one["best"]["trial_id"]
    np.testing.assert_allclose([t["best_val_loss"] for t in two["trials"]],
                               [t["best_val_loss"] for t in one["trials"]], rtol=RANKS_RTOL)


@pytest.mark.parametrize("flags, match", [
    (["--coordinator_address", "127.0.0.1:1"], "require --distributed"),
    (["--distributed", "--method", "wandb"], "does not compose with --distributed"),
    (["--distributed", "--n_devices", "2"], "--n_devices applies to single-host runs only"),
])
def test_cli_sweep_refuses_what_the_jax_cli_refuses(monkeypatch, flags, match):
    # a group of two as distributed.initialize would leave it, without one
    monkeypatch.setattr(distributed, "initialize", lambda **kw: None)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(SystemExit, match=match):
        sweep_cli.main(["--data_dir", "unused", "--device", "cpu", *flags])


def test_cli_sweep_clamps_n_devices_to_the_cards(monkeypatch, capsys):
    """More devices than the cards: the JAX CLI's message, then one device
    (here no card at all: the CUDA device raises when the sweep starts)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(distributed, "launch_local", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_cli.main(["--data_dir", "unused", "--n_devices", "2"])
    assert "requested --n_devices 2, but only 1 available; using 1" in capsys.readouterr().out

