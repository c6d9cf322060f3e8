"""The port's data parallelism (``parallel.mesh``, ``parallel.distributed``
and the paths on them) on the CPU: two processes joined by Gloo.

- The plain functions against the JAX package's: ``process_batch_slice``,
  ``sliced_batch_count`` and ``LocalSliceLoader``'s slices for ranks 0 and
  1 of 2 (JAX's run with ``jax.process_count``/``process_index``
  monkeypatched); the port's ``_Loader`` sliced before decode equals the
  decoded global batch sliced.
- One 2-rank run (``tests/torch_port_distributed_worker.py``, 32x32,
  LightweightUNet at width 8 and EnhancedUNet at width 4 without dropout,
  16 samples, 2 epochs of batch 8): training, a resume whose paths differ
  by rank, a checkpoint missing everywhere, resident training, a
  preemption seen by one rank, evaluation, and ``cli.train --distributed``.
  Held: both ranks agree bit for bit; the run equals the port's one-process
  run at the same global batch and JAX's ``train_model(mesh=
  make_mesh(2))`` on the same data and carried weights within rtol 1e-5
  (the JAX multi-host test's tolerance, tests/test_distributed.py), the
  BatchNorm family included; ``evaluate`` over 2 ranks equals one process
  and JAX's ``evaluate(mesh=make_mesh(2))`` within the evaluation
  tolerances of tests/test_torch_port_eval.py.
- Refusals: ``cli.train`` refuses coordinator flags without
  ``--distributed`` and a batch the ranks do not divide, as the JAX CLI
  does.
- ``cli.evaluate --n_devices 2 --device cpu`` through the launcher prints
  what one process prints.

The run and the references are computed once per test session: under
pytest-xdist the first worker to need them computes them under a file
lock in the session's shared temporary directory, and the others read
them there.
"""

import contextlib
import fcntl
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.data import dataset as jax_dataset
from image_enhancement_deglaring_tpu.eval import evaluate as jax_evaluate
from image_enhancement_deglaring_tpu.models import EnhancedUNet as JaxEnhanced
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.models import enhanced_unet as jax_enhanced_module
from image_enhancement_deglaring_tpu.parallel import distributed as jax_distributed
from image_enhancement_deglaring_tpu.parallel import make_mesh as jax_make_mesh
from image_enhancement_deglaring_tpu.train.loop import train_model as jax_train_model
from image_enhancement_deglaring_tpu_torch.cli import evaluate as eval_cli
from image_enhancement_deglaring_tpu_torch.cli import train as train_cli
from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1
from image_enhancement_deglaring_tpu_torch.data.dataset import (
    GlareRemovalDataset,
    _Loader,
    sliced_batch_count,
)
from image_enhancement_deglaring_tpu_torch.data.pipeline import list_image_paths
from image_enhancement_deglaring_tpu_torch.eval import evaluate
from image_enhancement_deglaring_tpu_torch.modelio import export_jax_params
from image_enhancement_deglaring_tpu_torch.parallel import distributed, mesh as port_mesh
from image_enhancement_deglaring_tpu_torch.train import train_model
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from tests.loaders import ArrayLoader
from tests.torch_port_distributed_worker import ENH_WIDTH, LR, SIZE, WIDTH, data, enhanced
from tests.torch_port_distributed_worker import lightweight, summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_distributed_worker.py")
RTOL = 1e-5                                    # tests/test_distributed.py
EVAL_RTOL = {"l1_loss": 1e-4, "psnr": 1e-4, "ssim": 1e-3}  # tests/test_torch_port_eval.py


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the plain functions


@pytest.mark.parametrize("rank", [0, 1])
def test_process_batch_slice_and_local_slice_loader_equal_jax(monkeypatch, rank):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: rank)
    for g in (2, 8, 16):
        assert distributed.process_batch_slice(g) == jax_distributed.process_batch_slice(g)
    for bad in (3, 7):
        with pytest.raises(ValueError, match="must divide"):
            distributed.process_batch_slice(bad)
    x = np.arange(22, dtype=np.float32).reshape(11, 2)
    for kw in ({}, {"ragged_tail": True}):
        for bs in (1, 2, 4, 5):
            port = distributed.LocalSliceLoader(ArrayLoader(x, x, bs, **kw))
            ref = jax_distributed.LocalSliceLoader(ArrayLoader(x, x, bs, **kw))
            got, want = list(port), list(ref)
            assert len(port) == len(ref) == len(got) == len(want), (kw, bs)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[0], w[0])
            assert (port.batch_size, port.num_samples) == (ref.batch_size, ref.num_samples)


def test_sliced_batch_count_equals_jax():
    for ns in range(1, 13):
        for bs in (1, 2, 3, 4, 5, 8):
            for world in (1, 2, 3, 4, 8):
                for drop_last in (False, True):
                    assert sliced_batch_count(ns, bs, world, drop_last) == \
                        jax_dataset.sliced_batch_count(ns, bs, world, drop_last)


@pytest.fixture(scope="module")
def sd1_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice_sd1")
    generate_synthetic_sd1(str(d), n_train=10, n_val=0, size=32, seed=3)
    return list_image_paths(str(d / "train"))


@pytest.mark.parametrize("world", [2, 4])
def test_pre_decode_slice_equals_post_decode_slice(sd1_paths, world):
    """``_Loader.set_batch_slice`` decodes only a rank's rows and yields the
    rows the decoded global batch gives sliced: the seeded shuffle, the
    ragged tail cut to a multiple of ``world``, a tail of fewer rows than
    ``world`` skipped, and ``len`` as iteration."""

    def loader():
        ds = GlareRemovalDataset(sd1_paths, image_size=32, seed=7, augment="optimized")
        ld = _Loader(ds, 4, shuffle=True, drop_last=False, seed=11, num_workers=0)
        ld.set_epoch(1)
        return ld

    full = [b for b in loader() if b[0].shape[0] // world > 0]  # batches of 4, 4, 2
    for rank in range(world):
        ld = loader()
        ld.set_batch_slice(rank, world)
        got = list(ld)
        assert len(ld) == len(got) == len(full)
        for (gx, gy), (fx, fy) in zip(got, full):
            per = fx.shape[0] // world
            np.testing.assert_array_equal(gx, fx[rank * per:(rank + 1) * per])
            np.testing.assert_array_equal(gy, fy[rank * per:(rank + 1) * per])
    with pytest.raises(ValueError, match="outside world"):
        loader().set_batch_slice(2, 2)


def test_one_process_mesh_and_its_helpers():
    """Without a process group the mesh is this process alone and every
    helper is a plain placement or fetch."""
    mesh = port_mesh.make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.in_group) == (1, 0, False)
    with pytest.raises(ValueError, match="process group"):
        port_mesh.make_mesh(2, device="cpu")
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    np.testing.assert_array_equal(
        port_mesh.put_from_full(x, port_mesh.batch_sharding(mesh)).numpy(), x)
    np.testing.assert_array_equal(port_mesh.fetch_replicated(torch.from_numpy(x), mesh), x)
    t = torch.from_numpy(x)
    assert port_mesh.all_gather_rows(t, mesh) is t and port_mesh.broadcast_from(t, 0, mesh) is t
    assert port_mesh.broadcast_bytes(b"abc", mesh) == b"abc"
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.backend_for("cpu") == "gloo" and distributed.backend_for("cuda") == "nccl"
    distributed.initialize()  # no arguments, no torchrun variables: stays alone
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        distributed.initialize("127.0.0.1:1", num_processes=2)


# ----------------------------------------------------------- the 2-rank run


@contextlib.contextmanager
def _no_jax_dropout():
    """JAX's EnhancedUNet without its dropout, as the port's at rate 0 (the
    two packages' random streams differ by construction)."""

    class _Identity(jax_enhanced_module.nn.Module):
        rate: float
        deterministic: bool = False

        def __call__(self, x):
            return x

    saved = jax_enhanced_module.nn.Dropout
    jax_enhanced_module.nn.Dropout = _Identity
    try:
        yield
    finally:
        jax_enhanced_module.nn.Dropout = saved


def _jax_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _references(work: str, sd1: str) -> dict:
    """The port's one-process runs and the JAX package's runs over a 2-device
    mesh on the worker's data, carried weights and settings."""
    x, y = data()
    common = dict(epochs=2, lr=LR, save_every=100, progress=False, validation_metrics_every=1,
                  handle_preemption=False)
    out = {}
    best, _, val, state = train_model(lightweight(), ArrayLoader(x[:8], y[:8], 8),
                                      ArrayLoader(x[8:], y[8:], 8), device="cpu",
                                      output_dir=os.path.join(work, "p_train"), **common)
    out["port_train"] = {"best_val": float(val), "step": state.step, **summary(best)}

    class _DS:
        augment = "none"

        def __len__(self):
            return 8

        def __getitem__(self, i):
            return x[i], y[i]

    train_res = ArrayLoader(x[:8], y[:8], 8)
    train_res.dataset = _DS()
    best, _, val, state = train_model(lightweight(), train_res, ArrayLoader(x[8:], y[8:], 8),
                                      device="cpu", resident=True,
                                      output_dir=os.path.join(work, "p_res"), **common)
    out["port_resident"] = {"best_val": float(val), "step": state.step, **summary(best)}
    best, stats, val, state = train_model(enhanced(), ArrayLoader(x[:8], y[:8], 8),
                                          ArrayLoader(x[8:], y[8:], 8), device="cpu",
                                          output_dir=os.path.join(work, "p_enh"), **common)
    out["port_enhanced"] = {"best_val": float(val), "step": state.step, **summary(best),
                            "stats": summary(stats)}
    ragged = ArrayLoader(x[:10], y[:10], 4, ragged_tail=True)
    out["port_evaluate"] = evaluate(lightweight(), ragged, device="cpu", progress=False)
    train_cli.main(["--data_dir", sd1, "--output_dir", os.path.join(work, "p_cli"),
                    "--epochs", "1", "--batch_size", "8", "--image_size", str(SIZE),
                    "--num_workers", "0", "--validation_metrics_every", "1", "--device", "cpu"])

    jax_common = dict(common, mesh=jax_make_mesh(2))
    jax_common.pop("handle_preemption")
    jm = JaxUNet(features_start=WIDTH)
    best, _, val, state = jax_train_model(
        jm, ArrayLoader(x[:8], y[:8], 8), ArrayLoader(x[8:], y[8:], 8),
        init_params=_jax_tree(export_jax_params(lightweight())),
        output_dir=os.path.join(work, "j_train"), **jax_common)
    out["jax_train"] = {"best_val": float(val), "step": int(state.step), **summary(best)}
    with _no_jax_dropout():
        best, stats, val, state = jax_train_model(
            JaxEnhanced(init_features=ENH_WIDTH), ArrayLoader(x[:8], y[:8], 8),
            ArrayLoader(x[8:], y[8:], 8), init_params=_jax_tree(export_jax_params(enhanced())),
            output_dir=os.path.join(work, "j_enh"), **jax_common)
    out["jax_enhanced"] = {"best_val": float(val), "step": int(state.step), **summary(best),
                           "stats": summary(stats)}
    out["jax_evaluate"] = jax_evaluate(jm.apply, _jax_tree(export_jax_params(lightweight())),
                                       ArrayLoader(x[:10], y[:10], 4, ragged_tail=True),
                                       progress=False, mesh=jax_make_mesh(2))
    return out


def _two_rank_run(root: str) -> dict:
    work = os.path.join(root, "work")
    sd1 = os.path.join(root, "sd1")
    generate_synthetic_sd1(sd1, n_train=20, n_val=0, size=SIZE, seed=3)
    sd1 = os.path.join(sd1, "train")
    ports = [distributed.free_port(), distributed.free_port()]
    env = {"PATH": os.environ.get("PATH", ""), "HOME": os.environ.get("HOME", ""),
           "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
    outs = [os.path.join(root, f"r{r}.json") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(ports[0]), str(ports[1]),
                               outs[r], os.path.join(work, "ranks"), sd1],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in (0, 1)]
    try:
        # the references run here while the ranks train
        refs = _references(os.path.join(work, "refs"), sd1)
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    ranks = [json.load(open(o)) for o in outs]
    cli = {k: v for k, v in np.load(os.path.join(work, "ranks", "cli",
                                                 "model_weights.npz")).items()}
    ref_cli = {k: v for k, v in np.load(os.path.join(work, "refs", "p_cli",
                                                     "model_weights.npz")).items()}
    refs["cli_abs_sum"] = {"ranks": summary(cli)["abs_sum"], "one": summary(ref_cli)["abs_sum"]}
    refs["cli_max_diff"] = max(float(np.abs(cli[k] - ref_cli[k]).max()) for k in ref_cli)
    return {"ranks": ranks, "refs": refs, "log0": logs[0][-4000:]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 2-rank run and its references, once per session (see the module
    docstring)."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _two_rank_run(str(tmp_path_factory.mktemp("dist")))
    root = tmp_path_factory.getbasetemp().parent / "torch_port_distributed"
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / "result.json"
        if not done.exists():
            result = _two_rank_run(str(root))
            done.write_text(json.dumps(result))
        return json.loads(done.read_text())


def test_ranks_agree_bit_for_bit(run):
    r0, r1 = run["ranks"]
    for key in ("train", "resume", "resident", "preempt_resumed", "enhanced", "evaluate"):
        assert r0[key] == r1[key], key
    assert r0["train"]["step"] == 2 and r0["train"]["leaves"].keys() == r1["train"]["leaves"].keys()


@pytest.mark.parametrize("kind", ["train", "resident", "enhanced"])
def test_two_ranks_equal_one_process(run, kind):
    got, want = run["ranks"][0][kind], run["refs"][f"port_{kind}"]
    assert got["step"] == want["step"] == 2
    np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got["abs_sum"], want["abs_sum"], rtol=RTOL)
    if kind == "enhanced":  # the BatchNorm running statistics of the global batch
        np.testing.assert_allclose(got["stats"]["abs_sum"], want["stats"]["abs_sum"], rtol=RTOL)


@pytest.mark.parametrize("kind", ["train", "enhanced"])
def test_two_ranks_equal_jax_over_a_two_device_mesh(run, kind):
    got, want = run["ranks"][0][kind], run["refs"][f"jax_{kind}"]
    assert got["step"] == want["step"] == 2
    np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got["abs_sum"], want["abs_sum"], rtol=RTOL)
    if kind == "enhanced":
        np.testing.assert_allclose(got["stats"]["abs_sum"], want["stats"]["abs_sum"], rtol=RTOL)


def test_resume_with_rank_divergent_paths_is_uniform(run):
    """Rank 1's output_dir holds no best_model and its resume_from does not
    exist: rank 0 reads both and broadcasts, so both ranks return the first
    run's bar."""
    for r in run["ranks"]:
        assert r["resume"]["best_val"] == r["train"]["best_val"]
        assert r["resume"]["abs_sum"] == r["train"]["abs_sum"]


def test_resume_missing_everywhere_fails_uniformly(run):
    r0, r1 = run["ranks"]
    assert "rank 0 could not restore" in r0["resume_missing_err"]
    assert r0["resume_missing_err"] == r1["resume_missing_err"]


def test_one_sided_preemption_stops_both_ranks_and_resumes_exactly(run):
    for r in run["ranks"]:
        assert r["agree_one"] is True and r["agree_none"] is False
        assert r["preempted"] == {"checkpoint": True, "triggered": True}
        resumed, full = r["preempt_resumed"], r["train"]
        assert resumed["step"] == full["step"] and resumed["best_val"] == full["best_val"]
        assert resumed["leaves"] == full["leaves"]


def test_evaluate_over_two_ranks_equals_one_process_and_jax(run):
    got = run["ranks"][0]["evaluate"]
    for want in (run["refs"]["port_evaluate"], run["refs"]["jax_evaluate"]):
        assert got["num_samples"] == want["num_samples"] == 10
        for key, rtol in EVAL_RTOL.items():
            np.testing.assert_allclose(got[key], want[key], rtol=rtol)


def test_cli_train_distributed_equals_one_process(run):
    """``cli.train --distributed`` over 2 Gloo ranks (each decoding its half
    of every batch before decode) against the one-process CLI: the weights
    rank 0 alone writes."""
    r0, r1 = run["ranks"]
    assert r0["cli_wrote_final"] and not r1["cli_wrote_final"]
    np.testing.assert_allclose(run["refs"]["cli_abs_sum"]["ranks"],
                               run["refs"]["cli_abs_sum"]["one"], rtol=RTOL)
    assert "Distributed runtime: 2 process(es)" in run["log0"]


# --------------------------------------------------------------- refusals


def test_cli_train_refuses_what_the_jax_cli_refuses(capsys):
    with pytest.raises(SystemExit, match="require --distributed"):
        train_cli.main(["--data_dir", "unused", "--device", "cpu",
                        "--coordinator_address", "127.0.0.1:1"])
    with pytest.raises(SystemExit, match="must divide by 2 devices"):
        train_cli.main(["--data_dir", "unused", "--device", "cpu", "--n_devices", "2",
                        "--batch_size", "3"])
    if not torch.cuda.is_available():  # the clamp: no card, no CUDA ranks
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cli.main(["--data_dir", "unused", "--n_devices", "2"])


def test_cli_evaluate_over_two_ranks_prints_what_one_process_prints(tmp_path, capfd):
    d = tmp_path / "sd"
    generate_synthetic_sd1(str(d), n_train=0, n_val=5, size=32, seed=4)
    model_dir = tmp_path / "m.npz"
    np.savez(model_dir, **flatten_tree(export_jax_params(lightweight())))
    argv = ["--data_dir", str(d / "val"), "--model_path", str(model_dir), "--model",
            "lightweight", "--image_size", "32", "--batch_size", "2", "--num_workers", "0",
            "--device", "cpu"]
    eval_cli.main(argv)
    one = capfd.readouterr().out
    eval_cli.main(argv + ["--n_devices", "2"])  # two spawned ranks, rank 0 prints
    two = capfd.readouterr().out

    def metrics(out):
        return [ln for ln in out.splitlines() if ln.startswith(("L1 Loss", "PSNR", "SSIM",
                                                                 "Evaluation on"))]

    assert len(metrics(one)) == 4 and metrics(two) == metrics(one)
