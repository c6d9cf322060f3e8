"""The port's evaluation path and dataset tools against the JAX package on
the CPU: ``evaluate`` (a narrow LightweightUNet carried over from JAX
parameters, and the bias-identity model of tests/test_eval.py against its
numpy reference), its visualizations and results file, ``make_eval_loader``,
``cli.evaluate``, the dataset validator and its CLI, ``split_image``,
``make_synthetic``, ``load_dotenv``, ``ops/image.py`` and the package's CLI
list.

Tolerances: ``evaluate`` within rtol 1e-4 for L1 and PSNR and 1e-3 for SSIM
(those of tests/test_eval.py); printed metrics within one unit of their last
printed digit; loaders, files, pixels and text equal.
"""

import io
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_enhancement_deglaring_tpu.cli import check_dataset as jax_check_cli
from image_enhancement_deglaring_tpu.cli import evaluate as jax_eval_cli
from image_enhancement_deglaring_tpu.cli import make_synthetic as jax_synth_cli
from image_enhancement_deglaring_tpu.cli import split_image as jax_split_cli
from image_enhancement_deglaring_tpu.data import make_eval_loader as jax_make_eval_loader
from image_enhancement_deglaring_tpu.data import validate as jax_validate
from image_enhancement_deglaring_tpu.eval import evaluate as jax_evaluate
from image_enhancement_deglaring_tpu.eval import write_results_file as jax_write_results
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.ops import image as jax_image
from image_enhancement_deglaring_tpu.utils import load_dotenv as jax_load_dotenv
from image_enhancement_deglaring_tpu_torch import __main__ as port_main
from image_enhancement_deglaring_tpu_torch.cli import check_dataset as check_cli
from image_enhancement_deglaring_tpu_torch.cli import evaluate as eval_cli
from image_enhancement_deglaring_tpu_torch.cli import make_synthetic as synth_cli
from image_enhancement_deglaring_tpu_torch.cli import split_image as split_cli
from image_enhancement_deglaring_tpu_torch.parallel import make_mesh
from image_enhancement_deglaring_tpu_torch.cli import train as train_cli
from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1, make_eval_loader
from image_enhancement_deglaring_tpu_torch.data import png, validate
from image_enhancement_deglaring_tpu_torch.data.png import decode_png_image, png_text
from image_enhancement_deglaring_tpu_torch.eval import evaluate, write_results_file
from image_enhancement_deglaring_tpu_torch.modelio import load_jax_params
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.ops import image as port_image
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree, load_dotenv
from tests.test_metrics import _psnr_np, _ssim_np

SIZE = 32
BATCHES = (4, 4, 2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def narrow():
    """(JAX params, port model): LightweightUNet(features_start=4), the
    port's carrying the JAX parameters over."""
    params = jax.jit(JaxUNet(features_start=4).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, SIZE, SIZE, 1)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = LightweightUNet(features_start=4, dtype=torch.float32, pallas_gn=True,
                            fused_blocks="auto", generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params)
    return params, model


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for b in BATCHES:
        x = rng.random((b, SIZE, SIZE, 1)).astype(np.float32)
        y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
        out.append((x, y))
    return out


def _assert_metrics_close(got, want):
    assert got["num_samples"] == want["num_samples"] == sum(BATCHES)
    np.testing.assert_allclose(got["l1_loss"], want["l1_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-3)


# ------------------------------------------------------------------ evaluate


def test_evaluate_equals_jax_on_narrow_unet(narrow):
    params, model = narrow
    batches = _batches()
    want = jax_evaluate(JaxUNet(features_start=4).apply,
                        jax.tree_util.tree_map(jnp.asarray, params), batches,
                        batch_size=4, progress=False)
    got = evaluate(model, batches, device="cpu", batch_size=4, progress=False)
    _assert_metrics_close(got, want)
    # without batch_size the first batch sets it, as in JAX
    _assert_metrics_close(evaluate(model, batches, device="cpu", progress=False), want)


class _BiasIdentity(torch.nn.Module):
    """tests/test_eval.py's fake model: a slightly biased identity."""

    def __init__(self, bias: float):
        super().__init__()
        self.bias = torch.nn.Parameter(torch.tensor(bias))

    def forward(self, x):
        return x + self.bias


def test_evaluate_bias_identity_equals_numpy_reference():
    batches = _batches(seed=1)
    got = evaluate(_BiasIdentity(0.03), batches, device="cpu", batch_size=4, progress=False)
    total_loss, total_psnr, total_ssim, n = 0.0, 0.0, 0.0, 0
    for x, y in batches:
        out = x + np.float32(0.03)
        total_loss += np.mean(np.abs(out - y))
        for i in range(x.shape[0]):
            o = np.clip(out[i, ..., 0], 0, 1).astype(np.float64)
            t = y[i, ..., 0].astype(np.float64)
            total_psnr += _psnr_np(o, t)
            total_ssim += _ssim_np(o, t)
            n += 1
    want = {"l1_loss": total_loss / len(batches), "psnr": total_psnr / n,
            "ssim": total_ssim / n, "num_samples": n}
    _assert_metrics_close(got, want)


def test_evaluate_rejects_a_batch_larger_than_batch_size(narrow):
    params, model = narrow
    batches = _batches()
    with pytest.raises(ValueError) as want:
        jax_evaluate(JaxUNet(features_start=4).apply, jax.tree_util.tree_map(jnp.asarray, params),
                     batches, batch_size=2, progress=False)
    with pytest.raises(ValueError) as got:
        evaluate(model, batches, device="cpu", batch_size=2, progress=False)
    assert str(got.value) == str(want.value)


def test_evaluate_refuses_mesh_and_defaults_to_cuda(narrow):
    _, model = narrow
    # a one-process mesh changes nothing; several ranks are held in
    # tests/test_torch_port_distributed.py
    mesh = make_mesh(device="cpu")
    assert evaluate(model, _batches(), mesh=mesh, progress=False) == evaluate(
        model, _batches(), device="cpu", progress=False)
    # the mesh owns the device: another one named beside it raises
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        evaluate(model, _batches(), mesh=mesh, device="cuda", progress=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            evaluate(model, _batches(), mesh=make_mesh(), progress=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            evaluate(model, _batches(), progress=False)


def test_visualizations_same_files_as_jax_with_the_panels(narrow, tmp_path):
    """``max_vis_samples`` files with the JAX names; each decodes to input |
    clipped prediction | target in uint8, the JAX titles in tEXt chunks."""
    params, model = narrow
    batches = _batches(seed=2)
    kw = dict(batch_size=4, progress=False, save_visualizations=True, max_vis_samples=6)
    jax_evaluate(JaxUNet(features_start=4).apply, jax.tree_util.tree_map(jnp.asarray, params),
                 batches, visualizations_dir=str(tmp_path / "jax"), **kw)
    evaluate(model, batches, device="cpu", visualizations_dir=str(tmp_path / "port"), **kw)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == [f"sample_{k}.png" for k in range(6)]
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    with torch.inference_mode():
        pred = model(torch.from_numpy(x)).numpy()

    def u8(a):
        return (np.clip(a, 0, 1) * 255).astype(np.uint8)

    for k in range(6):
        data = (tmp_path / "port" / f"sample_{k}.png").read_bytes()
        img = decode_png_image(data)
        assert img.mode == "L" and img.pixels.shape == (SIZE, 3 * SIZE)
        np.testing.assert_array_equal(img.pixels[:, :SIZE], u8(x[k, ..., 0]))
        np.testing.assert_array_equal(img.pixels[:, 2 * SIZE:], u8(y[k, ..., 0]))
        assert np.abs(img.pixels[:, SIZE:2 * SIZE].astype(int)
                      - u8(pred[k, ..., 0]).astype(int)).max() <= 1
        text = png_text(data)
        assert list(text) == ["Input", "Prediction", "Ground Truth"]
        p = np.clip(pred[k, ..., 0], 0, 1).astype(np.float64)
        title = text["Prediction"].split("\n")
        assert title[0] == "Prediction" and title[2].startswith("Range: [")
        psnr, ssim = (float(v.split(": ")[1]) for v in title[1].split(", "))
        assert abs(psnr - _psnr_np(p, y[k, ..., 0].astype(np.float64))) <= 0.011
        assert abs(ssim - _ssim_np(p, y[k, ..., 0].astype(np.float64))) <= 1e-3
        assert text["Input"] == (f"Input\nRange: [{x[k].min():.2f}, {x[k].max():.2f}]")


def test_write_results_file_equals_jax_byte_for_byte(tmp_path):
    metrics = {"l1_loss": 0.0168, "psnr": 32.57, "ssim": 0.975, "num_samples": 10}
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
    want = jax_write_results(metrics, str(tmp_path / "m.onnx"), "SD1/val", "onnx",
                             out_dir=str(tmp_path / "jax"))
    got = write_results_file(metrics, str(tmp_path / "m.onnx"), "SD1/val", "onnx",
                             out_dir=str(tmp_path / "port"))
    assert open(got, "rb").read() == open(want, "rb").read()
    # by default beside the model
    got = write_results_file(metrics, str(tmp_path / "port" / "m.npz"), "d", "ckpt")
    assert got == str(tmp_path / "port" / "evaluation_results.txt")


# -------------------------------------------------------------- data, CLIs


@pytest.fixture(scope="module")
def sd1(tmp_path_factory):
    """A seeded synthetic SD1 set at 32^2 panels: 8 train + 10 val."""
    root = tmp_path_factory.mktemp("sd1")
    generate_synthetic_sd1(str(root), n_train=8, n_val=10, size=SIZE, seed=3)
    return root


@pytest.mark.parametrize("num_workers", [0, 3])
def test_make_eval_loader_equals_jax_bit_for_bit(sd1, num_workers):
    kw = dict(batch_size=4, image_size=SIZE, seed=42, num_workers=num_workers)
    got = list(make_eval_loader(str(sd1 / "val"), **kw))
    want = list(jax_make_eval_loader(str(sd1 / "val"), **kw))
    assert [b[0].shape[0] for b in got] == [4, 4, 2]
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_make_eval_loader_rejects_an_empty_directory(tmp_path):
    with pytest.raises(ValueError, match="No images found"):
        make_eval_loader(str(tmp_path))


def _metric_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.split(":")[0] in ("L1 Loss", "PSNR", "SSIM")]


def _close_printed(got: list[str], want: list[str]) -> None:
    """Printed metrics agree within one unit of their last printed digit."""
    assert [g.split(":")[0] for g in got] == [w.split(":")[0] for w in want]
    for g, w in zip(got, want):
        gv, wv = g.split(": ")[1].split()[0], w.split(": ")[1].split()[0]
        unit = 10.0 ** -len(wv.split(".")[1])
        assert abs(float(gv) - float(wv)) <= unit * 1.01, (g, w)


def test_cli_evaluate_cpu_equals_jax_cli(narrow, sd1, tmp_path, capsys):
    params, _ = narrow
    npz = tmp_path / "narrow.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in flatten_tree(params).items()})
    argv = ["--data_dir", str(sd1 / "val"), "--model_path", str(npz), "--batch_size", "4",
            "--image_size", str(SIZE), "--num_workers", "2"]
    jax_eval_cli.main(argv)
    want_out = capsys.readouterr().out
    want_file = (tmp_path / "evaluation_results.txt").read_text()
    os.remove(tmp_path / "evaluation_results.txt")
    eval_cli.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    got_file = (tmp_path / "evaluation_results.txt").read_text()
    assert ([ln for ln in got_out.splitlines() if ln not in _metric_lines(got_out)]
            == [ln for ln in want_out.splitlines() if ln not in _metric_lines(want_out)])
    _close_printed(_metric_lines(got_out), _metric_lines(want_out))
    assert f"Evaluating CKPT model from {npz}" in got_out.splitlines()
    assert ([ln for ln in got_file.splitlines() if ln not in _metric_lines(got_file)]
            == [ln for ln in want_file.splitlines() if ln not in _metric_lines(want_file)])
    _close_printed(_metric_lines(got_file), _metric_lines(want_file))
    # the file holds what the CLI printed
    assert _metric_lines(got_file) == _metric_lines(got_out)


def test_cli_evaluate_parser_and_refusals(tmp_path):
    got = vars(eval_cli.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == vars(jax_eval_cli.parse_args([]))
    bad = tmp_path / "weights.bin"
    bad.write_bytes(b"")
    for argv, match in ((["--model_path", str(bad)], "cannot determine the artifact format"),
                        # checked before any rank starts, as the JAX CLI checks it
                        (["--n_devices", "2"], "cannot determine the artifact format")):
        with pytest.raises(SystemExit, match=match):
            eval_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="cannot determine the artifact format") as want:
        jax_eval_cli.main(["--model_path", str(bad)])
    with pytest.raises(SystemExit) as got_exit:
        eval_cli.main(["--model_path", str(bad), "--device", "cpu"])
    assert str(got_exit.value) == str(want.value)
    # a .pth is read now: an empty one fails in torch.load, as in the JAX CLI
    pth = tmp_path / "model.pth"
    pth.write_bytes(b"")
    with pytest.raises(Exception) as want_pth:
        jax_eval_cli.main(["--model_path", str(pth), "--model", "lightweight"])
    with pytest.raises(want_pth.type):
        eval_cli.main(["--model_path", str(pth), "--model", "lightweight", "--device", "cpu"])


def _png(img: np.ndarray, mode: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def mixed_dataset(tmp_path_factory):
    """train/ and val/ holding a good 96x32 RGBA PNG, a wrong-size one, an
    RGB PNG, a truncated PNG, a gray and an RGB JPEG, a 16-bit gray PNG, a
    file that is no image, and a nested directory, as the loader lists."""
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(9)
    for sub in ("train", "val", "val/nested"):
        (root / sub).mkdir(parents=True)
    rgba = rng.integers(0, 256, (32, 96, 4), dtype=np.uint8)
    (root / "train" / "good.png").write_bytes(_png(rgba, "RGBA"))
    (root / "train" / "wide.PNG").write_bytes(_png(rng.integers(0, 256, (32, 99, 4),
                                                                dtype=np.uint8), "RGBA"))
    (root / "train" / "rgb.png").write_bytes(_png(rgba[..., :3].copy(), "RGB"))
    full = _png(rgba, "RGBA")
    (root / "val" / "truncated.png").write_bytes(full[:len(full) // 2])
    for name, mode, arr in (("gray.jpg", "L", rgba[..., 0]), ("photo.jpeg", "RGB", rgba[..., :3])):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(arr), mode=mode).save(buf, format="JPEG")
        (root / "val" / name).write_bytes(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 65536, (20, 96), dtype=np.uint16)).save(buf, format="PNG")
    (root / "val" / "nested" / "deep16.png").write_bytes(buf.getvalue())
    (root / "val" / "nested" / "junk.png").write_bytes(b"not an image at all")
    (root / "val" / "notes.txt").write_text("ignored")
    return root


def test_check_png_dimensions_equals_jax(mixed_dataset, capsys):
    kw = dict(required_width=96, required_height=32)
    got = validate.check_png_dimensions(str(mixed_dataset), **kw)
    want = jax_validate.check_png_dimensions(str(mixed_dataset), **kw)
    assert got == want
    assert got[3] == 8 and ("val/photo.jpeg", "RGB") in got[1] and ("val/gray.jpg", "L") in got[1]
    assert "val/truncated.png" in got[2] and "val/nested/junk.png" in got[2]
    assert validate.main(str(mixed_dataset), 96, 32) == jax_validate.main(str(mixed_dataset),
                                                                          96, 32) == 1
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    with pytest.raises(FileNotFoundError):
        validate.check_png_dimensions(str(mixed_dataset / "missing"))


def test_check_png_dimensions_jpeg_header_is_all_the_port_reads(mixed_dataset, tmp_path):
    """A JPEG cut after its frame header is a decode failure for both
    validators now that the port decodes JPEG in full (the difference this
    test once held is gone); one cut inside its headers fails at the
    header in both, so neither records its size or mode."""
    (tmp_path / "val").mkdir()
    data = (mixed_dataset / "val" / "photo.jpeg").read_bytes()
    (tmp_path / "val" / "cut.jpg").write_bytes(data[:len(data) - 200])
    (tmp_path / "val" / "head.jpg").write_bytes(data[:data.index(b"\xff\xda") + 4])
    kw = dict(required_width=96, required_height=32)
    got = validate.check_png_dimensions(str(tmp_path), **kw)
    want = jax_validate.check_png_dimensions(str(tmp_path), **kw)
    assert got == want
    assert got[:3] == ([], [("val/cut.jpg", "RGB")], ["val/cut.jpg", "val/head.jpg"])
    for cmyk, mode in ((4, "CMYK"), (1, "L")):
        assert validate.jpeg_header(_sof(cmyk))[2] == mode
    with pytest.raises(ValueError):
        validate.jpeg_header(b"\xff\xd8\xff\xda\x00\x02")


def _sof(components: int) -> bytes:
    """A JPEG header up to the scan header, its frame 8x16 pixels."""
    sof = bytes([8, 0, 8, 0, 16, components]) + bytes(3 * components)
    sos = bytes([1, 0, 0, 0, 63, 0])
    return (b"\xff\xd8\xff\xe0\x00\x04ab\xff\xc0" + (2 + len(sof)).to_bytes(2, "big") + sof
            + b"\xff\xda" + (2 + len(sos)).to_bytes(2, "big") + sos)


@pytest.mark.parametrize("args", [[], ["--width", "96", "--height", "32"], ["missing"]])
def test_cli_check_dataset_equals_jax(mixed_dataset, args, capsys, monkeypatch):
    monkeypatch.chdir(mixed_dataset)
    argv = (["."] if args != ["missing"] else []) + args
    want = jax_check_cli.main(argv)
    want_out = capsys.readouterr().out
    assert check_cli.main(argv) == want
    assert capsys.readouterr().out == want_out


def test_split_image_equals_jax_crops(tmp_path, capsys):
    rng = np.random.default_rng(4)
    strip = tmp_path / "strip.png"
    strip.write_bytes(_png(rng.integers(0, 256, (20, 97, 4), dtype=np.uint8), "RGBA"))
    gray = tmp_path / "gray.png"
    gray.write_bytes(_png(rng.integers(0, 256, (9, 31), dtype=np.uint8), "L"))
    for src in (strip, gray):
        assert jax_split_cli.main([str(src), "-o", str(tmp_path / "jax")]) == 0
        want_out = capsys.readouterr().out
        assert split_cli.main([str(src), "-o", str(tmp_path / "port")]) == 0
        assert capsys.readouterr().out == want_out.replace(str(tmp_path / "jax"),
                                                           str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6
    for name in names:
        with Image.open(tmp_path / "jax" / name) as a, Image.open(tmp_path / "port" / name) as b:
            assert a.mode == b.mode and a.size == b.size
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    # PIL's row filters: the same scanlines as PIL writes
    def raw(p):
        return zlib.decompress(b"".join(body for kind, body in png._chunks(p.read_bytes())
                                        if kind == b"IDAT"))

    for name in names:
        assert raw(tmp_path / "port" / name) == raw(tmp_path / "jax" / name)
    # a JPEG input gives the JAX CLI's crops too; a missing file exits 1
    jpg = tmp_path / "photo.jpg"
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (8, 29, 3), dtype=np.uint8)).save(buf, format="JPEG")
    jpg.write_bytes(buf.getvalue())
    assert jax_split_cli.main([str(jpg), "-o", str(tmp_path / "jax_jpg")]) == 0
    assert split_cli.main([str(jpg), "-o", str(tmp_path / "port_jpg")]) == 0
    capsys.readouterr()
    for name in sorted(os.listdir(tmp_path / "jax_jpg")):
        with Image.open(tmp_path / "jax_jpg" / name) as a, \
                Image.open(tmp_path / "port_jpg" / name) as b:
            assert a.mode == b.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert split_cli.main([str(tmp_path / "none.png")]) == 1
    assert capsys.readouterr().out.startswith("Error: Image file not found")


def test_make_synthetic_equals_jax_cli(tmp_path, capsys):
    argv = ["--n_train", "3", "--n_val", "2", "--size", "32", "--seed", "7"]
    jax_synth_cli.main(argv + ["--out_dir", str(tmp_path / "jax")])
    want_out = capsys.readouterr().out
    synth_cli.main(argv + ["--out_dir", str(tmp_path / "port")])
    assert capsys.readouterr().out == want_out.replace("jax/", "port/")
    for sub in ("train", "val"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        assert len(names) == (3 if sub == "train" else 2)
        for name in names:
            with Image.open(tmp_path / "jax" / sub / name) as a, \
                    Image.open(tmp_path / "port" / sub / name) as b:
                assert a.mode == b.mode == "RGBA" and a.size == b.size == (96, 32)
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ------------------------------------------------------------- .env, image


def test_load_dotenv_equals_jax(tmp_path, monkeypatch):
    """The cases of tests/test_utils.py: comments, export, quotes, no
    override by default, unquoted inline comments stripped."""
    envfile = tmp_path / ".env"
    envfile.write_text("# comment\nFOO=bar\nexport QUOTED='hello world'\nEXISTING=new\n"
                       "KEY=abc123 # personal key\nQ2='abc # not a comment'\nHASHED=a#b\n"
                       "DQ=\"x y\" trailing\nEMPTY=\nnot a pair\n")
    for k in ("FOO", "QUOTED", "KEY", "Q2", "HASHED", "DQ", "EMPTY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EXISTING", "old")
    got = load_dotenv(str(envfile))
    assert got == {"FOO": "bar", "QUOTED": "hello world", "EXISTING": "new", "KEY": "abc123",
                   "Q2": "abc # not a comment", "HASHED": "a#b", "DQ": "x y", "EMPTY": ""}
    assert os.environ["FOO"] == "bar" and os.environ["EXISTING"] == "old"
    assert got == jax_load_dotenv(str(envfile))
    load_dotenv(str(envfile), override=True)
    assert os.environ["EXISTING"] == "new"
    assert load_dotenv(str(tmp_path / "missing.env")) == {}


def test_cli_train_reads_dotenv_at_start(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DEGLARE_PORT_DOTENV", raising=False)
    (tmp_path / ".env").write_text("DEGLARE_PORT_DOTENV=read\n")
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="No images found"):
        train_cli.main(["--data_dir", str(tmp_path / "empty"), "--device", "cpu"])
    assert os.environ["DEGLARE_PORT_DOTENV"] == "read"


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("shape,size", [((2, 12, 18, 1), (7, 31)), ((12, 18, 3), (24, 9)),
                                        ((1, 2, 9, 9, 2), (9, 9)), ((3, 16, 16, 1), (8, 8))])
def test_resize_bilinear_equals_jax(shape, size):
    img = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = port_image.resize_bilinear(torch.from_numpy(img), *size)
    want = jax_image.resize_bilinear(jnp.asarray(img), *size)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_image_ops_equal_jax():
    rng = np.random.default_rng(12)
    rgba = rng.random((2, 5, 9, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(port_image.rgb_to_gray_luminance(torch.from_numpy(rgba))),
                               _np(jax_image.rgb_to_gray_luminance(jnp.asarray(rgba))),
                               rtol=1e-6, atol=1e-7)
    for got, want in zip(port_image.split_triptych(torch.from_numpy(rgba)),
                         jax_image.split_triptych(jnp.asarray(rgba))):
        np.testing.assert_array_equal(_np(got), _np(want))
    u8 = rng.integers(0, 256, (3, 4, 1), dtype=np.uint8)
    np.testing.assert_array_equal(_np(port_image.from_uint8(torch.from_numpy(u8))),
                                  _np(jax_image.from_uint8(jnp.asarray(u8))))
    f = np.concatenate([rng.random(50) * 1.4 - 0.2, [0.0, 1.0, 0.5, 254.5 / 255]])
    f = f.astype(np.float32)
    got = port_image.to_uint8(torch.from_numpy(f))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(_np(got), _np(jax_image.to_uint8(jnp.asarray(f))))


@pytest.mark.parametrize("mode", ["edge", "constant", "reflect", "wrap"])
def test_pad_to_multiple_equals_jax(mode):
    img = np.random.default_rng(2).random((2, 13, 10, 1)).astype(np.float32)
    for multiple in (8, 5, 1):
        got, got_hw = port_image.pad_to_multiple(torch.from_numpy(img), multiple, mode=mode)
        want, want_hw = jax_image.pad_to_multiple(jnp.asarray(img), multiple, mode=mode)
        assert got_hw == want_hw == (13, 10)
        np.testing.assert_array_equal(_np(got), _np(want))
    with pytest.raises(ValueError, match="mode"):
        port_image.pad_to_multiple(torch.from_numpy(img), 8, mode="symmetric")


def test_package_main_lists_the_ports_clis():
    listed = [ln.split()[0] for ln in port_main.HELP.split("Entry points")[1].splitlines()
              if ln.startswith("  ") and not ln.startswith("   ")]
    cli_dir = os.path.join(os.path.dirname(port_main.__file__), "cli")
    have = sorted(f[:-3] for f in os.listdir(cli_dir) if f.endswith(".py") and f != "__init__.py")
    assert sorted(listed) == have
    assert {"export_onnx", "extract_weights", "sweep"} <= set(listed)
