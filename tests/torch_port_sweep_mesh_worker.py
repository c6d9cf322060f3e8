"""The port's sweeps over two ranks (``tests/test_torch_port_sweep_mesh.py``):
CPU processes joined by Gloo, started by ``parallel.distributed.launch_local``.

    python tests/torch_port_sweep_mesh_worker.py <root>

``<root>`` holds ``init0.npz``, the JAX groups' starting weights for seed
0 (the test writes it). Every rank runs the
phases below through the port's entry points and writes what it saw to
``<root>/r<rank>.json``; then this process runs ``cli.sweep`` alone and
with ``--n_devices 2`` and writes ``<root>/cli.json``. The phase functions
take ``mesh=None`` too: the test runs them in one process for the
reference. Imports torch only, and the test's shared array loader.
"""

import json
import os
import sys
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from image_enhancement_deglaring_tpu_torch.modelio import load_jax_params  # noqa: E402
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet  # noqa: E402
from image_enhancement_deglaring_tpu_torch.parallel import (  # noqa: E402
    SearchSpace,
    Trial,
    VmappedTrialGroup,
    distributed,
    run_sweep,
    run_wandb_agent_sweep,
)
from image_enhancement_deglaring_tpu_torch.train.resident import (  # noqa: E402
    batch_val_cache,
    cache_on_device,
)
from image_enhancement_deglaring_tpu_torch.utils.pytree import load_npz_tree  # noqa: E402
from tests.loaders import ArrayLoader  # noqa: E402

SIZE, BS = 32, 4
CFG = [(1e-3, 1e-5), (3e-3, 1e-4), (5e-4, 1e-6), (8e-3, 5e-4), (2e-3, 2e-5)]
CPU = 1 << 34  # a resident cache's budget on the CPU
# run_sweep over ranks: the JAX two-host test's sweep (tests/distributed_worker.py),
# at the seed of the groups' init
SWEEP = dict(n_trials=4, max_epochs=2, min_iter=1, eta=2, method="random", seed=0)
RESUME = dict(n_trials=2, max_epochs=1, min_iter=1, eta=2, method="random", seed=7,
              max_parallel_trials=1)
PROPOSALS = [{"batch_size": 8, "learning_rate": 3e-3, "weight_decay": 1e-5},
             {"batch_size": 8, "learning_rate": 1e-3, "weight_decay": 5e-5},
             {"batch_size": 8, "learning_rate": 5e-4, "weight_decay": 2e-6}]
CLI_FLAGS = ["--sweep_count", "2", "--max_epochs", "2", "--early_stop_min_iter", "1",
             "--eta", "2", "--method", "random", "--image_size", str(SIZE),
             "--num_workers", "0", "--compute_dtype", "float32", "--device", "cpu"]


def data():
    """The JAX two-host test's 16 seeded samples: 8 train, 8 val."""
    rng = np.random.default_rng(0)
    y = rng.random((16, SIZE, SIZE, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.15, y.shape), 0, 1).astype(np.float32)
    return x, y


class Factory:
    """The toy LightweightUNet (width 2, 2 groups) on the weights of an npz."""

    def __init__(self, path):
        self.params = load_npz_tree(path)

    def __call__(self):
        m = LightweightUNet(features_start=2, num_groups=2)
        load_jax_params(m, self.params)
        return m


def loaders(bs):
    x, y = data()
    return ArrayLoader(x[:8], y[:8], bs), ArrayLoader(x[8:], y[8:], bs)


def abs_sum(tree) -> float:
    from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

    return float(sum(np.abs(np.asarray(v, np.float64)).sum() for v in flatten_tree(tree).values()))


def group_run(factory, n: int, mesh=None, keep=None, mode="compact") -> dict:
    """A group of ``n`` trials of CFG: 2 epochs (train, val, schedulers), then
    with ``keep`` the survivors kept and one more epoch."""
    train, val = loaders(BS)
    g = VmappedTrialGroup(factory(), [Trial(i, BS, *CFG[i]) for i in range(n)], mesh=mesh,
                          seed=0, device="cpu")
    out = {"n_phys": g._n_phys, "k": int(g.lrs.shape[0]), "train": [], "val": []}

    def epoch(e):
        out["train"].append(g.train_epoch(train, e).tolist())
        v = g.val_epoch(val)
        out["val"].append(v.tolist())
        g.step_schedulers(v)

    epoch(0)
    epoch(1)
    if keep is not None:
        g.keep(keep, mode=mode)
        out["n_phys_kept"], out["k_kept"] = g._n_phys, int(g.lrs.shape[0])
        epoch(2)
    out["snapshots"] = [abs_sum(g.snapshot_of(i)) for i in range(len(g.trials))]
    return out


def resident_run(factory, mesh=None) -> dict:
    """A group of 4 over the resident cache (the whole set on every rank)."""
    x, y = data()
    g = VmappedTrialGroup(factory(), [Trial(i, BS, *CFG[i]) for i in range(4)], mesh=mesh,
                          seed=0, device="cpu")
    train = cache_on_device(ArrayLoader(x[:8], y[:8], 8), device="cpu", device_bytes=CPU)
    val = cache_on_device(ArrayLoader(x[8:], y[8:], 8), device="cpu", device_bytes=CPU)
    vb = batch_val_cache(val, BS)
    out = {"train": [], "val": []}
    for e in range(2):
        out["train"].append(g.train_epoch_resident(train, e).tolist())
        out["val"].append(g.val_epoch_resident(vb, val.n).tolist())
    return out


def sweep_outcome(res: dict, out_dir: str) -> dict:
    return {"best_id": res["best"]["trial_id"], "best_val": res["best"]["best_val_loss"],
            "vals": [t["best_val_loss"] for t in res["trials"]], "trials": res["trials"],
            "wrote_results": os.path.exists(os.path.join(out_dir, "sweep_results.json")),
            "wrote_params": os.path.exists(os.path.join(out_dir, "best_trial_params.npz")),
            "wrote_journal": os.path.exists(os.path.join(out_dir, "sweep_journal.jsonl"))}


def sweep_run(factory, out_dir: str, mesh=None) -> dict:
    res = run_sweep(factory, loaders, mesh=mesh, output_dir=out_dir, device="cpu",
                    space=SearchSpace(batch_sizes=(8,)), **SWEEP)
    return sweep_outcome(res, out_dir)


class _Trig:
    """A preemption guard that reads as triggered from its n+1-th read on;
    every rank reads it at the same points."""

    def __init__(self, n):
        self.n, self.c = n, 0

    @property
    def triggered(self):
        self.c += 1
        return self.c > self.n


def resume_run(factory, root: str, rank: int, mesh) -> dict:
    """The JAX two-host test's phase 7: a preempted sweep whose journal is
    on rank 0 only (per-rank directories), resumed."""
    kw = dict(RESUME, mesh=mesh, device="cpu", space=SearchSpace(batch_sizes=(8,)))
    full = run_sweep(factory, loaders, output_dir=os.path.join(root, f"full_r{rank}"), **kw)
    pre_dir = os.path.join(root, f"pre_r{rank}")
    pre = run_sweep(factory, loaders, output_dir=pre_dir, preempt_guard=_Trig(3), **kw)
    out = {"preempted": pre["preempted"], "pre_trials": len(pre["trials"]),
           "journal_local": os.path.exists(os.path.join(pre_dir, "sweep_journal.jsonl"))}
    res = run_sweep(factory, loaders, output_dir=pre_dir, resume=True, **kw)
    out["resumed_matches_full"] = res["trials"] == full["trials"] and res["best"] == full["best"]
    out["results_written"] = os.path.exists(os.path.join(pre_dir, "sweep_results.json"))
    return out


class FakeRun:
    def __init__(self, config, stop_after):
        self.config, self.summary, self.logged = config, {}, []
        self._stop_after = stop_after

    def log(self, rec, step=None):
        self.logged.append((rec, step))

    def should_stop(self):
        return self._stop_after is not None and len(self.logged) >= self._stop_after

    def finish(self):
        pass


class FakeWandb(types.ModuleType):
    """wandb stand-in: a sweep server with fixed proposals and one Hyperband
    stop (trial 1 after its first epoch)."""

    def __init__(self):
        super().__init__("wandb")
        self.sweeps, self.agents, self.runs = [], [], []

    def sweep(self, config, project=None, entity=None):
        self.sweeps.append(config)
        return "sw-fake-1"

    def init(self, **kwargs):
        i = len(self.runs)
        self.runs.append(FakeRun(PROPOSALS[i], 1 if i == 1 else None))
        return self.runs[-1]

    def agent(self, sweep_id, function=None, count=None):
        self.agents.append((sweep_id, count))
        for _ in range(count):
            function()


def wandb_run(factory, out_dir: str, mesh=None) -> dict:
    """``run_wandb_agent_sweep`` with the fake server on rank 0 only."""
    fake = FakeWandb() if mesh is None or mesh.rank == 0 else None
    res = run_wandb_agent_sweep(factory, loaders, n_trials=3, max_epochs=3, min_iter=1, eta=2,
                                seed=0, mesh=mesh, output_dir=out_dir, device="cpu",
                                space=SearchSpace(batch_sizes=(8,)), wandb_module=fake)
    out = sweep_outcome(res, out_dir)
    out["sweep_id"] = res["sweep_id"]
    if fake is not None:
        out["server"] = {"sweeps": len(fake.sweeps), "agents": [list(a) for a in fake.agents],
                         "logged": [len(r.logged) for r in fake.runs]}
    return out


def rank_main(root: str) -> None:
    torch.set_num_threads(1)
    mesh = distributed.global_mesh(device="cpu")
    assert (mesh.world, mesh.device.type, mesh.backend) == (2, "cpu", "gloo")
    rank = mesh.rank
    f0 = Factory(os.path.join(root, "init0.npz"))
    out = {
        "rank": rank,
        "group3": group_run(f0, 3, mesh, keep=[0, 2]),
        "group3_mask": group_run(f0, 3, mesh, keep=[0, 2], mode="mask"),
        "group5": group_run(f0, 5, mesh),
        "resident": resident_run(f0, mesh),
        "sweep": sweep_run(f0, os.path.join(root, f"sweep_r{rank}"), mesh),
        "resume": resume_run(f0, root, rank, mesh),
        "wandb": wandb_run(f0, os.path.join(root, f"wandb_r{rank}"), mesh),
    }
    with open(os.path.join(root, f"r{rank}.json"), "w") as f:
        json.dump(out, f)


def cli_runs(root: str) -> dict:
    """``cli.sweep`` on a synthetic set, alone and over two CPU ranks."""
    from image_enhancement_deglaring_tpu_torch.cli import sweep as sweep_cli
    from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1

    data_dir = os.path.join(root, "sd1")
    generate_synthetic_sd1(data_dir, n_train=10, n_val=0, size=SIZE, seed=3)
    out = {}
    for name, extra in (("one", []), ("two", ["--n_devices", "2"])):
        d = os.path.join(root, f"cli_{name}")
        sweep_cli.main(["--data_dir", os.path.join(data_dir, "train"), "--output_dir", d,
                        *CLI_FLAGS, *extra])
        with open(os.path.join(d, "sweep_results.json")) as f:
            out[name] = json.load(f)
    return out


def main() -> None:
    root = sys.argv[1]
    distributed.launch_local(rank_main, 2, root, device="cpu")
    cli = cli_runs(root)
    with open(os.path.join(root, "cli.json"), "w") as f:
        json.dump(cli, f)


if __name__ == "__main__":
    main()
