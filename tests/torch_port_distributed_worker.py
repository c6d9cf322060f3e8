"""One rank of the port's 2-process data-parallel run
(``tests/test_torch_port_distributed.py``): CPU processes joined by Gloo.

    python tests/torch_port_distributed_worker.py <rank> <port> <cli_port> <out.json> \\
        <work_dir> <sd1_dir>

Every rank builds the same seeded data and models and runs the phases
below through the port's entry points, then writes what it saw as JSON for
the parent test to hold against the other rank, the port's one-process
runs and the JAX package's ``train_model(mesh=make_mesh(2))``. Imports
torch only, and the test's shared array loader.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from image_enhancement_deglaring_tpu_torch.eval import evaluate  # noqa: E402
from image_enhancement_deglaring_tpu_torch.models import EnhancedUNet, LightweightUNet  # noqa: E402
from image_enhancement_deglaring_tpu_torch.parallel import distributed  # noqa: E402
from image_enhancement_deglaring_tpu_torch.train import train_model  # noqa: E402
from image_enhancement_deglaring_tpu_torch.train.preempt import preemption_agreed  # noqa: E402
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree  # noqa: E402
from tests.loaders import ArrayLoader  # noqa: E402

WIDTH, ENH_WIDTH, SIZE, LR = 8, 4, 32, 1e-3


def data():
    """The 16 seeded samples of the JAX multi-host test: 8 train, 8 val."""
    rng = np.random.default_rng(0)
    y = rng.random((16, SIZE, SIZE, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.15, y.shape), 0, 1).astype(np.float32)
    return x, y


def lightweight():
    return LightweightUNet(features_start=WIDTH, generator=torch.Generator().manual_seed(0))


def enhanced():
    return EnhancedUNet(init_features=ENH_WIDTH, dropout_rate=0.0,
                        generator=torch.Generator().manual_seed(1))


def summary(tree) -> dict:
    """Per-leaf float64 sums of |x| and their total, of a JAX-named tree."""
    flat = flatten_tree(tree)
    leaves = {k: float(np.abs(np.asarray(v, np.float64)).sum()) for k, v in flat.items()}
    return {"abs_sum": float(sum(leaves.values())), "leaves": leaves}


class _Guard:
    """A preemption guard that reads as triggered from its first read on."""

    preempt_checkpoint = None

    def __init__(self, on: bool):
        self.triggered = on


class _DS:
    augment = "none"

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __len__(self):
        return len(self.a)

    def __getitem__(self, i):
        return self.a[i], self.b[i]


def main() -> None:
    rank, port, cli_port, out_path, work, sd1 = sys.argv[1:7]
    rank = int(rank)
    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = distributed.global_mesh()
    assert (mesh.world, mesh.rank, mesh.device.type, mesh.backend) == (2, rank, "cpu", "gloo")
    x, y = data()
    common = dict(epochs=2, lr=LR, save_every=100, progress=False, mesh=mesh,
                  validation_metrics_every=1, handle_preemption=False)

    def sliced(a, b, bs=8):
        return distributed.LocalSliceLoader(ArrayLoader(a, b, bs))

    out = {"rank": rank}
    ckpt = os.path.join(work, "ckpt")  # one directory for both ranks: rank 0 writes
    # 1: streaming training, each rank its half of every global batch
    best, _, best_val, state = train_model(lightweight(), sliced(x[:8], y[:8]),
                                           sliced(x[8:], y[8:]), output_dir=ckpt, **common)
    out["train"] = {"best_val": float(best_val), "step": state.step, **summary(best)}

    # 2: resume with rank-divergent paths: rank 1's output_dir has no
    # best_model and its resume_from does not exist; rank 0 reads both and
    # broadcasts. epochs == the resumed epoch count: the returned values
    # are the restored bar
    r_out = ckpt if rank == 0 else os.path.join(work, "rank1_local")
    r_src = os.path.join(ckpt if rank == 0 else os.path.join(work, "missing_on_rank1"),
                         "best_model")
    r_best, _, r_val, _ = train_model(lightweight(), sliced(x[:8], y[:8]), sliced(x[8:], y[8:]),
                                      output_dir=r_out, resume_from=r_src, **common)
    out["resume"] = {"best_val": float(r_val), **summary(r_best)}

    # 3: a checkpoint that exists nowhere: the same error on every rank
    try:
        train_model(lightweight(), sliced(x[:8], y[:8]), sliced(x[8:], y[8:]), output_dir=r_out,
                    resume_from=os.path.join(work, "nowhere", "best_model"), **common)
        out["resume_missing_err"] = ""
    except RuntimeError as e:
        out["resume_missing_err"] = str(e).replace(work, "<work>")

    # 4: resident training over global loaders
    train_res = ArrayLoader(x[:8], y[:8], 8)
    train_res.dataset = _DS(x[:8], y[:8])
    res, _, res_val, res_state = train_model(
        lightweight(), train_res, ArrayLoader(x[8:], y[8:], 8),
        output_dir=os.path.join(work, "res"), resident=True, **common)
    out["resident"] = {"best_val": float(res_val), "step": res_state.step, **summary(res)}

    # 5: the preemption decision: one rank's signal stops both
    out["agree_one"] = preemption_agreed(rank == 1, mesh)
    out["agree_none"] = preemption_agreed(False, mesh)
    guard = _Guard(rank == 1)
    pre_dir = os.path.join(work, "pre")
    train_model(lightweight(), sliced(x[:8], y[:8]), sliced(x[8:], y[8:]), output_dir=pre_dir,
                preempt_guard=guard, **{**common, "handle_preemption": True})
    out["preempted"] = {"checkpoint": guard.preempt_checkpoint is not None,
                        "triggered": bool(guard.triggered)}
    p_best, _, p_val, p_state = train_model(
        lightweight(), sliced(x[:8], y[:8]), sliced(x[8:], y[8:]), output_dir=pre_dir,
        resume_from=os.path.join(pre_dir, "preempt_checkpoint"), **common)
    out["preempt_resumed"] = {"best_val": float(p_val), "step": p_state.step, **summary(p_best)}

    # 6: BatchNorm over the global batch (EnhancedUNet without dropout)
    e_best, e_stats, e_val, e_state = train_model(
        enhanced(), sliced(x[:8], y[:8]), sliced(x[8:], y[8:]),
        output_dir=os.path.join(work, "enh"), **common)
    out["enhanced"] = {"best_val": float(e_val), "step": e_state.step, **summary(e_best),
                       "stats": summary(e_stats)}

    # 7: evaluation over both ranks, a ragged last batch (10 = 4 + 4 + 2)
    model = lightweight()
    out["evaluate"] = evaluate(model, ArrayLoader(x[:10], y[:10], 4, ragged_tail=True),
                               mesh=mesh, progress=False)

    # 8: cli.train --distributed in a group of its own
    distributed.shutdown()
    from image_enhancement_deglaring_tpu_torch.cli import train as train_cli

    train_cli.main(["--data_dir", sd1, "--output_dir", os.path.join(work, "cli"),
                    "--epochs", "1", "--batch_size", "8", "--image_size", str(SIZE),
                    "--num_workers", "0", "--validation_metrics_every", "1",
                    "--device", "cpu", "--distributed", "--coordinator_address",
                    f"127.0.0.1:{cli_port}", "--num_processes", "2",
                    "--process_id", str(rank)])
    out["cli_wrote_final"] = os.path.exists(os.path.join(work, "cli", "model_weights.npz"))
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
