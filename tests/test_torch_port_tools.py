"""The port's tools and the rest of its host paths on the CPU, against the
JAX package where it has a counterpart:

- ``cli.enhance --visualize``: the same output and figure file names as
  the JAX CLI (collisions included), each figure the input's luma and the
  output side by side with the panel titles in ``tEXt`` chunks;
- ``tools.crossval_artifact``: the JAX script's JSON line at 32x32 (each
  metric within 1e-3, the same verdict both ways round);
- the native decode route (``native/``, ``use_native=True``): the JAX
  package's native numbers bit for bit, at identity size and at a resize;
- ``tools.train_synthetic_demo`` and ``tools.train_roofline`` run end to
  end at a toy size.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from image_enhancement_deglaring_tpu import native as jax_native
from image_enhancement_deglaring_tpu.cli import enhance as jax_enhance_cli
from image_enhancement_deglaring_tpu.data import pipeline as jax_pipeline
from image_enhancement_deglaring_tpu.data.synthetic import make_triptych
from image_enhancement_deglaring_tpu_torch import native
from image_enhancement_deglaring_tpu_torch.cli import enhance as enhance_cli
from image_enhancement_deglaring_tpu_torch.data import (
    decode_inference_image,
    decode_triptych,
    png,
)
from image_enhancement_deglaring_tpu_torch.serve.imaging import decode_image, to_luma
from image_enhancement_deglaring_tpu_torch.tools import (
    crossval_artifact,
    train_roofline,
    train_synthetic_demo,
)
from tests.torch_port_weights import save_pth, seeded_tree, state_dict_from_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors, several test processes at once: one intra-op thread
    each (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------- enhance --visualize


def test_cli_enhance_visualize_writes_the_jax_file_names(tmp_path):
    """``--visualize`` (it raised naming ROADMAP Queue 1 item 15 before the
    port had it): ``scan.png`` and ``scan.jpg`` share a stem and an input is
    itself named ``scan_comparison.png``, so every output and figure name
    goes through the collision rule."""
    rng = np.random.default_rng(4)
    inp = tmp_path / "in"
    inp.mkdir()
    Image.fromarray(rng.integers(0, 256, (40, 48), dtype=np.uint8)).save(inp / "scan.png")
    Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)).save(inp / "scan.jpg")
    Image.fromarray(rng.integers(0, 256, (32, 32), dtype=np.uint8)).save(
        inp / "scan_comparison.png")
    common = ["--input", str(inp), "--model_path", ONNX, "--image_size", "32", "--visualize"]
    enhance_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_enhance_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    figures = [n for n in names if "_comparison" in n and n != "scan_comparison.png"]
    assert len(figures) == 3, names
    for inp_name, out_name in (("scan.jpg", "scan.png"), ("scan.png", "scan_1.png")):
        # sorted inputs: scan.jpg -> scan.png, scan.png -> scan_1.png
        out = png.read_png(tmp_path / "port" / out_name)
        fig_path = tmp_path / "port" / (out_name[:-4] + "_comparison.png")
        data = fig_path.read_bytes()
        fig = png.decode_png(data)
        img = decode_image((inp / inp_name).read_bytes())
        luma = to_luma(img.pixels, img.mode, img.palette)
        h = max(luma.shape[0], out.shape[0])
        assert fig.shape == (h, luma.shape[1] + 16 + out.shape[1])
        np.testing.assert_array_equal(fig[:luma.shape[0], :luma.shape[1]], luma)
        np.testing.assert_array_equal(fig[:out.shape[0], -out.shape[1]:], out)
        assert png.png_text(data) == {"Input": "Input Image (with glare)",
                                      "Output": "De-glared Image"}


# ---------------------------------------------------------- crossval_artifact


def _jax_crossval(argv, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_crossval", os.path.join(REPO, "scripts", "crossval_artifact.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["crossval_artifact.py", *argv])
    assert mod.main() == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def random_pth(tmp_path_factory):
    params, _ = seeded_tree("lightweight", 11, 8)
    return save_pth(tmp_path_factory.mktemp("w") / "random.pth",
                    state_dict_from_params("lightweight", params))


@pytest.mark.parametrize("promote", [True, False], ids=["promote", "keep_incumbent"])
def test_crossval_artifact_equals_the_jax_script(promote, random_pth, monkeypatch, capsys):
    cand, inc = (ONNX, random_pth) if promote else (random_pth, ONNX)
    argv = ["--candidate", cand, "--incumbent", inc, "--n", "6", "--size", "32",
            "--batch_size", "4"]
    assert crossval_artifact.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _jax_crossval(argv, monkeypatch, capsys)
    print(f"crossval port {got} | JAX {want}")
    assert got["verdict"] == want["verdict"] == ("promote" if promote else "keep_incumbent")
    assert (got["n_heldout"], got["seed"]) == (want["n_heldout"], want["seed"]) == (6, 123)
    for model in ("candidate", "incumbent"):
        for k in ("l1_loss", "psnr", "ssim"):
            assert got[model][k] == pytest.approx(want[model][k], abs=1e-3), (model, k)


def test_crossval_verdict_rule():
    inc = {"psnr": 30.0, "l1_loss": 0.02}
    assert crossval_artifact.verdict({"psnr": 30.1, "l1_loss": 0.0204}, inc) == "promote"
    assert crossval_artifact.verdict({"psnr": 30.1, "l1_loss": 0.0205}, inc) == "keep_incumbent"
    assert crossval_artifact.verdict({"psnr": 30.0, "l1_loss": 0.01}, inc) == "keep_incumbent"


# ----------------------------------------------------------- native decode


@pytest.mark.parametrize("size,out", [(32, 32), (64, 48), (40, 96)])
def test_native_route_equals_the_jax_native_route(size, out, tmp_path):
    rng = np.random.default_rng(size + out)
    img = make_triptych(rng, size=size)
    for got, want in zip(native.triptych_preprocess(img, out),
                         jax_native.triptych_preprocess(img, out)):
        np.testing.assert_array_equal(got, want)
    batch = np.stack([make_triptych(rng, size=size) for _ in range(3)])
    for got, want in zip(native.triptych_preprocess_batch(batch, out, n_threads=2),
                         jax_native.triptych_preprocess_batch(batch, out, n_threads=2)):
        np.testing.assert_array_equal(got, want)
    for page in (img[..., :3], img[..., 0]):
        np.testing.assert_array_equal(native.inference_preprocess(page, out),
                                      jax_native.inference_preprocess(page, out))
    path = tmp_path / "t.png"
    Image.fromarray(img, mode="RGBA").save(path)
    for got, want in zip(decode_triptych(str(path), out, use_native=True),
                         jax_pipeline.decode_triptych(str(path), out, use_native=True)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_inference_image(str(path), out, use_native=True),
                                  jax_pipeline.decode_inference_image(str(path), out,
                                                                      use_native=True))
    with pytest.raises(ValueError, match="too small"):
        native.triptych_preprocess(img[:, :2], out)


def test_native_route_at_a_resize_is_within_one_step_of_numpy():
    """At identity size the routes agree bit for bit; at a resize the
    native route rounds a float bilinear once where the numpy path follows
    cv2's fixed point: within one uint8 step (the share that differs is
    printed)."""
    img = make_triptych(np.random.default_rng(9), size=64)
    for out in (64, 48, 100):
        nat = native.triptych_preprocess(img, out)[0]
        third = img.shape[1] // 3
        with_numpy = decode_inference_image(img[:, third:2 * third, :3], out)
        steps = np.abs(nat - with_numpy) * 255
        print(f"{out}: native vs numpy max {steps.max():.3f} steps, "
              f"{(steps > 0.5).mean():.4f} of pixels differ")
        assert steps.max() <= 1 + 1e-3
        if out == 64:
            assert steps.max() == 0


# -------------------------------------------------------- training scripts


def test_train_synthetic_demo_runs_on_the_cpu(tmp_path, capsys):
    argv = ["--data_dir", str(tmp_path / "d"), "--out_dir", str(tmp_path / "m"),
            "--n_train", "8", "--n_val", "2", "--epochs", "1", "--batch_size", "2",
            "--size", "32", "--device", "cpu"]
    assert train_synthetic_demo.main(argv) == 0
    out = capsys.readouterr().out
    assert "identity baseline: PSNR" in out and "final (held-out val/ (2))" in out
    assert train_synthetic_demo.main(argv) == 0  # the dataset is reused by its manifest
    assert "Generating" not in capsys.readouterr().out


def test_train_roofline_runs_on_the_cpu(capsys):
    assert train_roofline.main(["--batches", "1,2", "--size", "16", "--iters", "1",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("img/s |") == 2 and "linear fit over b=[1, 2]" in out
    rows = [train_roofline.measure(b, 16, torch.device("cpu"), iters=1) for b in (1, 2)]
    assert rows[1]["flops"] == pytest.approx(2 * rows[0]["flops"], rel=1e-6)
    assert rows[1]["bytes"] > rows[0]["bytes"] > 0
