"""The port's model-artifact export against the JAX package's, on the CPU.

- ``modelio.onnx_writer``: the port writes the JAX writer's file byte for
  byte for all three families on the same seeded trees (LightweightUNet at
  features 8 and at 4 with 2 groups, the other families at
  ``init_features`` 4), and ``export_model`` on a module writes what the
  tree writer does; the port's importers read the file back to the same
  parameters bit for bit.
- ``modelio.onnx_exec.run_onnx``: equal to JAX's exactly on the same file
  (numpy both; every family's file and deploy/models/best_model.onnx).
- The port's float32 forward against ``run_onnx`` at 32x32 on every
  family's exported file and on best_model.onnx: within 1e-4 (the
  float32 forward against a numpy executor: summation order only).
- ``cli.export_onnx`` and ``cli.extract_weights`` of both packages on the
  same ``.onnx`` / ``.pth`` / ``.npz`` inputs: equal ``.onnx`` bytes and
  ``.npz`` arrays, and equal parameters (and statistics) in the
  directory output (the port's checkpoint directory, JAX's orbax one);
  the port's CLIs also read the port's own checkpoint directory.
"""

import os

import jax
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.cli import export_onnx as jax_export_cli
from image_enhancement_deglaring_tpu.cli import extract_weights as jax_extract_cli
from image_enhancement_deglaring_tpu.modelio import onnx_exec as jax_exec
from image_enhancement_deglaring_tpu.modelio import onnx_writer as jax_writer
from image_enhancement_deglaring_tpu.train.checkpoint import restore_checkpoint as jax_restore
from image_enhancement_deglaring_tpu_torch.cli import export_onnx as export_cli
from image_enhancement_deglaring_tpu_torch.cli import extract_weights as extract_cli
from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
from image_enhancement_deglaring_tpu_torch.modelio import (
    enhanced_unet_params_from_onnx,
    export_jax_params,
    export_model,
    lightweight_unet_params_from_onnx,
    load_jax_params,
    onnx_writer,
    optimized_unet_params_from_onnx,
    run_onnx,
)
from image_enhancement_deglaring_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from tests.torch_port_weights import family_model, save_pth, seeded_tree, state_dict_from_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")
SIZE = 32
ARCHS = ["lightweight", "optimized", "enhanced"]
WIDTHS = {"lightweight": 8, "optimized": 4, "enhanced": 4}
FORWARD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(writer, arch: str, params, stats, path: str, groups: int = 8) -> str:
    """Write a family's tree with ``writer`` (either package's module)."""
    if arch == "enhanced":
        return writer.export_enhanced_unet(params, stats, path)
    if arch == "optimized":
        return writer.export_optimized_unet(params, path)
    return writer.export_lightweight_unet(params, path, groups=groups)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _assert_trees_equal(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """arch -> (params, batch_stats, the port-written .onnx path)."""
    root = tmp_path_factory.mktemp("onnx")
    out = {}
    for arch in ARCHS:
        params, stats = seeded_tree(arch, 0, WIDTHS[arch])
        out[arch] = (params, stats, _write(onnx_writer, arch, params, stats,
                                           str(root / f"{arch}.onnx")))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_writer_bytes_equal_jax(exported, arch, tmp_path):
    params, stats, path = exported[arch]
    want = _write(jax_writer, arch, params, stats, str(tmp_path / "jax.onnx"))
    assert _read(path) == _read(want)
    if arch == "lightweight":  # a narrow model with its own group budget
        narrow, _ = seeded_tree(arch, 3, 4)
        got = _write(onnx_writer, arch, narrow, None, str(tmp_path / "n.onnx"), groups=2)
        want = _write(jax_writer, arch, narrow, None, str(tmp_path / "nj.onnx"), groups=2)
        assert _read(got) == _read(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_export_model_writes_the_tree_writers_bytes(exported, arch, tmp_path):
    params, stats, path = exported[arch]
    model = family_model(arch, WIDTHS[arch])
    load_jax_params(model, params, stats)
    assert _read(export_model(model, str(tmp_path / "m.onnx"))) == _read(path)


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_through_the_importers(exported, arch):
    params, stats, path = exported[arch]
    if arch == "enhanced":
        got, got_stats = enhanced_unet_params_from_onnx(path)
        _assert_trees_equal(got_stats, stats)
    elif arch == "optimized":
        got = optimized_unet_params_from_onnx(path)
    else:
        got = lightweight_unet_params_from_onnx(path)
    _assert_trees_equal(got, params)


def _nchw_input(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 1, SIZE, SIZE)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS + ["best_model"])
def test_executor_equals_jax_and_the_forward_matches_it(exported, arch):
    path = ONNX if arch == "best_model" else exported[arch][2]
    x = _nchw_input(2, 4)
    got = run_onnx(path, {"input": x})["output"]
    want = jax_exec.run_onnx(path, {"input": x})["output"]
    assert got.dtype == want.dtype and got.shape == (2, 1, SIZE, SIZE)
    np.testing.assert_array_equal(got, want)

    model, _ = load_model_for_eval(path, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x.transpose(0, 2, 3, 1).copy())).numpy()
    err = float(np.abs(out.transpose(0, 3, 1, 2) - got).max())
    print(f"{arch}: max |port f32 forward - run_onnx| {err:.3g}")
    assert err <= FORWARD_ATOL


# ------------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def cli_inputs(exported, tmp_path_factory):
    """arch -> {"onnx": path, "pth": path, "npz": path} of the same weights."""
    root = tmp_path_factory.mktemp("cli_inputs")
    out = {}
    for arch in ARCHS:
        params, stats, path = exported[arch]
        tree = {"params": params, "batch_stats": stats} if stats else params
        npz = str(root / f"{arch}.npz")
        np.savez(npz, **flatten_tree(tree))
        pth = save_pth(root / f"{arch}.pth", state_dict_from_params(arch, params, stats))
        out[arch] = {"onnx": path, "pth": str(pth), "npz": npz}
    return out


@pytest.mark.parametrize("kind", ["onnx", "pth", "npz"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_export_onnx_equals_jax(cli_inputs, arch, kind, tmp_path, capsys):
    src = cli_inputs[arch][kind]
    got, want = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    export_cli.main(["--model_path", src, "--model", arch, "--output", got])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    jax_export_cli.main(["--model_path", src, "--model", arch, "--output", want])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert _read(got) == _read(want)
    assert port_line.replace(got, "X") == jax_line.replace(want, "X")


def _npz(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("kind", ["onnx", "pth", "npz"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_extract_weights_equals_jax(cli_inputs, arch, kind, tmp_path):
    src = cli_inputs[arch][kind]
    for ext in (".npz", ".onnx"):
        got, want = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
        assert extract_cli.main([src, got]) == 0
        assert jax_extract_cli.main([src, want]) == 0
        if ext == ".onnx":
            assert _read(got) == _read(want)
        else:
            g, w = _npz(got), _npz(want)
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # directory output: the port's checkpoint against JAX's orbax one
    assert extract_cli.main([src, str(tmp_path / "port_dir")]) == 0
    assert jax_extract_cli.main([src, str(tmp_path / "jax_dir")]) == 0
    item, meta = restore_checkpoint(str(tmp_path / "port_dir"))
    jax_item, _ = jax_restore(str(tmp_path / "jax_dir"))
    _assert_trees_equal(item["params"], jax.tree_util.tree_map(np.asarray, jax_item["params"]))
    assert "opt_state" not in item and meta["model_arch"] == arch
    if arch == "enhanced":
        _assert_trees_equal(item["model_state"]["batch_stats"], jax.tree_util.tree_map(
            np.asarray, jax_item["model_state"]["batch_stats"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_read_the_ports_checkpoint_directory(exported, cli_inputs, arch, tmp_path):
    """A training checkpoint (with optimizer state) of the port: extracted
    to .npz it equals the extraction of the same weights' .npz, exported
    to .onnx it is the writer's file."""
    params, stats, path = exported[arch]
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), params=params,
                           opt_state={"count": np.asarray(3, np.int32)},
                           model_state={"batch_stats": stats} if stats else None)
    assert extract_cli.main([ckpt, str(tmp_path / "a.npz")]) == 0
    assert extract_cli.main([cli_inputs[arch]["npz"], str(tmp_path / "b.npz")]) == 0
    a, b = _npz(str(tmp_path / "a.npz")), _npz(str(tmp_path / "b.npz"))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    export_cli.main(["--model_path", ckpt, "--model", arch, "--output",
                     str(tmp_path / "c.onnx")])
    assert _read(str(tmp_path / "c.onnx")) == _read(path)


def test_cli_extract_weights_refusals(exported, tmp_path, capsys):
    assert extract_cli.main([str(tmp_path / "missing.pth"), str(tmp_path / "o.npz")]) == 1
    assert "Checkpoint file not found" in capsys.readouterr().out
    params, _, _ = exported["enhanced"]
    bare = save_checkpoint(str(tmp_path / "bare"), params=params)
    with pytest.raises(SystemExit, match="batch_stats"):
        extract_cli.main([bare, str(tmp_path / "o.npz"), "--model", "enhanced"])


def test_exported_lightweight_model_round_trips_through_the_forward(tmp_path):
    """``export_model`` of a LightweightUNet loaded from best_model.onnx
    writes a file whose parameters are the source's, bit for bit."""
    model, params = load_model_for_eval(ONNX, device="cpu")
    out = export_model(model, str(tmp_path / "again.onnx"))
    _assert_trees_equal(lightweight_unet_params_from_onnx(out), params)
    _assert_trees_equal(export_jax_params(model), params)
