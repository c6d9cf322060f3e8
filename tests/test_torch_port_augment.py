"""Heavy augmentation and the profiler on the CPU.

- ``data.cv_ops``, the port's numpy copies of the cv2 operations that
  ``heavy_augment`` calls, against cv2 5.0.0: ``getRotationMatrix2D``
  equal; ``warpAffine`` bilinear within 1e-5 (bit for bit where the width
  is a multiple of 16, cv2's vector loop; its scalar tail rounds
  otherwise), nearest bit for bit; the 3x3 Gaussian blur and CLAHE bit for
  bit, CLAHE also at sizes that are no multiple of its 8x8 grid.
- ``heavy_augment`` against the JAX package's on the same
  ``np.random.default_rng`` seeds (200 at 64x64, 3 at 512x512): equal
  arrays and the generator left in the same state; the heavy loaders'
  batches equal JAX's; ``cli.train --augment heavy`` trains.
- ``train_model(profile_dir=)`` writes a trace and trains bit for bit as
  the unprofiled run, streaming and resident; ``cli.train --profile_dir``;
  ``start_trace_server`` answers captures while other threads run ops.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.data import augment as jax_augment
from image_enhancement_deglaring_tpu.data import dataset as jax_dataset
from image_enhancement_deglaring_tpu.utils import profiling as jax_profiling
from image_enhancement_deglaring_tpu_torch.cli import train as port_cli
from image_enhancement_deglaring_tpu_torch.data import cv_ops, generate_synthetic_sd1
from image_enhancement_deglaring_tpu_torch.data.augment import heavy_augment
from image_enhancement_deglaring_tpu_torch.data.dataset import make_dataloaders
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.train import train_model
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from image_enhancement_deglaring_tpu_torch.utils import profiling
from tests.loaders import ArrayLoader


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors, several test processes at once: one intra-op thread
    each (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _affine_matrix(rng, h, w):
    """The matrix heavy augmentation draws: rotation +-15 deg, scale
    0.9-1.1 about the centre, translation +-6.25 %."""
    m = cv2.getRotationMatrix2D((w / 2, h / 2), rng.uniform(-15, 15), rng.uniform(0.9, 1.1))
    m[0, 2] += rng.uniform(-0.0625, 0.0625) * w
    m[1, 2] += rng.uniform(-0.0625, 0.0625) * h
    return m


# ------------------------------------------------------------------ cv_ops


@pytest.mark.parametrize("center,angle,scale", [((32.0, 32.0), 0.0, 1.0),
                                                ((26.5, 18.5), -14.3, 0.93),
                                                ((256.0, 256.0), 11.7, 1.08)])
def test_rotation_matrix_equals_cv2(center, angle, scale):
    np.testing.assert_array_equal(cv_ops.rotation_matrix(center, angle, scale),
                                  cv2.getRotationMatrix2D(center, angle, scale))
    m = cv2.getRotationMatrix2D(center, angle, scale)
    np.testing.assert_array_equal(cv_ops.invert_affine(m), cv2.invertAffineTransform(m))


@pytest.mark.parametrize("h,w", [(64, 64), (37, 53), (512, 512)])
def test_warp_affine_against_cv2(h, w):
    """Bilinear within 1e-5 (bit for bit at widths that are multiples of
    16) and nearest bit for bit, constant-0 border, on random float32
    images and the affine draws of heavy augmentation."""
    rng = np.random.default_rng(h * 1000 + w)
    worst, differing = 0.0, []
    for _ in range(6 if h < 512 else 2):
        img = rng.random((h, w), dtype=np.float32)
        m = _affine_matrix(rng, h, w)
        want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = cv_ops.warp_affine(img, m, cv_ops.INTER_LINEAR)
        assert got.dtype == np.float32 and got.shape == (h, w)
        worst = max(worst, float(np.abs(got - want).max()))
        if w % 16 == 0:
            np.testing.assert_array_equal(got, want)
        want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_NEAREST,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        differing.append(int((cv_ops.warp_affine(img, m, cv_ops.INTER_NEAREST) != want).sum()))
    print(f"warp {h}x{w}: bilinear max |diff| {worst:.3g}; nearest pixels differing "
          f"per warp {differing}")
    assert worst <= 1e-5
    assert differing == [0] * len(differing)


@pytest.mark.parametrize("h,w", [(64, 64), (37, 53), (3, 5)])
def test_gaussian_blur_3x3_equals_cv2(h, w):
    img = np.random.default_rng(h).random((h, w), dtype=np.float32)
    np.testing.assert_array_equal(cv_ops.gaussian_blur_3x3(img), cv2.GaussianBlur(img, (3, 3), 0))


@pytest.mark.parametrize("h,w", [(64, 64), (512, 512), (37, 53), (64, 61), (100, 64), (13, 8)])
def test_clahe_equals_cv2_bit_for_bit(h, w):
    """Full-range noise, a low-contrast image (its histograms clip hard)
    and a ramp, at clip limits across heavy augmentation's U(1, 4)."""
    rng = np.random.default_rng(h + w)
    ramp = np.add.outer(np.arange(h), np.arange(w)) * 255 // max(h + w - 2, 1)
    images = [rng.integers(0, 256, (h, w), dtype=np.uint8),
              rng.integers(100, 120, (h, w), dtype=np.uint8),
              ramp.astype(np.uint8)]
    for img in images:
        for limit in (1.0, 1.7, 2.5, 3.99):
            want = cv2.createCLAHE(clipLimit=limit, tileGridSize=(8, 8)).apply(img)
            np.testing.assert_array_equal(cv_ops.clahe_u8(img, limit), want)
    with pytest.raises(ValueError, match="uint8"):
        cv_ops.clahe_u8(images[0].astype(np.float32), 2.0)


# -------------------------------------------------------------- heavy stack


@pytest.mark.parametrize("size,seeds", [(64, range(200)), (512, range(3))])
def test_heavy_augment_equals_jax_on_the_same_seeds(size, seeds):
    data = np.random.default_rng(size)
    img = data.random((size, size), dtype=np.float32)
    tgt = (data.random((size, size)) > 0.5).astype(np.float32)
    for seed in seeds:
        r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
        got = heavy_augment(img, tgt, r_port)
        want = jax_augment.heavy_augment(img, tgt, r_jax)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert 0.0 <= got[0].min() and got[0].max() <= 1.0
        assert r_port.bit_generator.state == r_jax.bit_generator.state


@pytest.fixture(scope="module")
def sd1(tmp_path_factory):
    d = tmp_path_factory.mktemp("sd1")
    generate_synthetic_sd1(str(d), n_train=8, n_val=0, size=32, seed=5)
    return str(d / "train")


def test_heavy_loaders_yield_the_jax_batches(sd1):
    kw = dict(batch_size=3, val_split=0.25, seed=42, image_size=32, num_workers=2,
              augment="heavy")
    pt, _ = make_dataloaders(sd1, **kw)
    jt, _ = jax_dataset.make_dataloaders(sd1, **kw)
    for epoch in range(2):
        pt.set_epoch(epoch)
        jt.set_epoch(epoch)
        got, want = list(pt), list(jt)
        assert len(got) == len(want) == 2
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_cli_train_augment_heavy_trains(sd1, tmp_path):
    """``--augment heavy`` on the streaming path (it raised naming ROADMAP
    Queue 1 item 17 before the port had it)."""
    out = tmp_path / "run"
    port_cli.main(["--data_dir", sd1, "--output_dir", str(out), "--image_size", "32",
                   "--batch_size", "3", "--epochs", "1", "--num_workers", "2",
                   "--augment", "heavy", "--device", "cpu"])
    with open(out / "logs" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert any(np.isfinite(r.get("train_loss", np.nan)) for r in records)
    assert os.path.exists(out / "final_model") and os.path.exists(out / "model_weights.npz")


# ---------------------------------------------------------------- profiler


def _trace_files(d):
    return sorted(str(p) for p in d.glob("*.pt.trace.json")) if d.exists() else []


def _op_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


@pytest.mark.parametrize("resident,steps", [(False, 2), (False, 9), (True, 1)],
                         ids=["streaming", "epoch-shorter-than-steps", "resident"])
def test_train_model_profile_dir_traces_and_trains_the_same(tmp_path, resident, steps):
    """A trace of the first epoch (its first ``steps`` steps, or the whole
    epoch when shorter or resident) is written, and the parameters equal
    the unprofiled run's bit for bit."""
    rng = np.random.default_rng(3)
    y = rng.random((8, 16, 16, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.1, y.shape), 0, 1).astype(np.float32)

    def run(name, **kw):
        model = LightweightUNet(features_start=4, generator=torch.Generator().manual_seed(0))
        best, _, val, state = train_model(
            model, ArrayLoader(x, y, 2), ArrayLoader(x[:4], y[:4], 4), epochs=2, lr=1e-3,
            output_dir=str(tmp_path / name), progress=False, device="cpu", resident=resident,
            validation_metrics_every=100, log_images_every=100, handle_preemption=False, **kw)
        return flatten_tree(best), val, state

    prof_dir = tmp_path / "prof"
    p_best, p_val, p_state = run("profiled", profile_dir=str(prof_dir), profile_steps=steps)
    b_best, b_val, b_state = run("plain")
    (trace,) = _trace_files(prof_dir)  # one trace: the first epoch only
    assert "aten::convolution" in _op_names(trace)
    assert p_val == b_val and p_state.step == b_state.step == 8
    for k in b_best:
        np.testing.assert_array_equal(p_best[k], b_best[k], err_msg=k)
    run("off", profile_dir=str(tmp_path / "off"), profile_steps=0)
    assert _trace_files(tmp_path / "off") == []  # profile_steps 0 traces nothing, as in JAX


def test_cli_train_profile_dir_writes_a_trace(sd1, tmp_path):
    """``--profile_dir`` (it raised naming ROADMAP Queue 1 item 15 before
    the port had it) with ``--profile_steps 1``."""
    prof = tmp_path / "prof"
    port_cli.main(["--data_dir", sd1, "--output_dir", str(tmp_path / "run"), "--image_size",
                   "32", "--batch_size", "3", "--epochs", "1", "--num_workers", "2",
                   "--profile_dir", str(prof), "--profile_steps", "1", "--device", "cpu"])
    (trace,) = _trace_files(prof)
    assert "aten::convolution_backward" in _op_names(trace)


def test_start_trace_server_answers_a_capture_of_other_threads(tmp_path):
    """Captures taken while other threads run torch ops, as the serving
    engine's drainer and a loader's threads do: each answers with a trace
    that parses, and the process lives through every start and stop (a
    session with ``profile_all_threads`` crashes it there). Host ops are
    the capturing thread's, so the other threads' are not in the trace; on
    a card their kernels are (CUPTI). Bad requests answer 400 / 404."""
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = profiling.start_trace_server(port, str(tmp_path))
    stop = threading.Event()

    def work():
        a = torch.ones(16, 16)
        while not stop.is_set():
            torch.nn.functional.silu(a @ a)

    answers, native_ids = [], set()
    try:
        for _ in range(6):  # threads that start and end around each capture
            stop.clear()
            workers = [threading.Thread(target=work) for _ in range(3)]
            for w in workers:
                w.start()
            native_ids |= {w.native_id for w in workers}
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/trace?ms=20", timeout=60) as r:
                answers.append(json.loads(r.read()))
            stop.set()
            for w in workers:
                w.join(timeout=30)
                assert not w.is_alive()
        for path, code in (("/trace?ms=0", 400), ("/trace?ms=x", 400), ("/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60)
            assert e.value.code == code
    finally:
        stop.set()
        server.shutdown()
        server.server_close()
    assert len({a["trace"] for a in answers}) == 6
    for answer in answers:
        assert answer["ms"] == 20 and os.path.dirname(answer["trace"]) == str(tmp_path)
        with open(answer["trace"]) as f:
            events = json.load(f)["traceEvents"]
        assert not {e["tid"] for e in events if e.get("name") == "aten::silu"} & native_ids


def test_trace_context_and_step_timer(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(4).add_(1)
    (trace,) = _trace_files(tmp_path)
    assert "aten::add_" in _op_names(trace)
    timer, jax_timer = profiling.StepTimer(window=4), jax_profiling.StepTimer(window=4)
    assert timer.ms_per_step == jax_timer.ms_per_step == float("inf")
    for _ in range(6):
        timer.tick(8)
    assert timer.steps_per_sec > 0 and timer.items_per_sec == pytest.approx(
        8 * timer.steps_per_sec)
    assert len(timer._times) == 5 and len(timer._items) == 4
