"""The port's serving slice against the JAX package on the CPU: weights read
from deploy/models/best_model.onnx by each package's own reader, the
float32 LightweightUNet forward, the InferenceEngine's uint8 output, the
parameter carry-over, device defaults and import hygiene."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.modelio import lightweight_unet_params_from_onnx as jax_reader
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.serve import InferenceEngine as JaxEngine
from image_enhancement_deglaring_tpu_torch.modelio import (
    export_jax_params,
    lightweight_unet_params_from_onnx,
    load_jax_params,
    load_lightweight_unet,
)
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.ops import fused_kernels as fk
from image_enhancement_deglaring_tpu_torch.parallel import make_local_mesh
from image_enhancement_deglaring_tpu_torch.serve import InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")
SIZE = 64


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def params():
    return lightweight_unet_params_from_onnx(ONNX)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    base = 0.6 + 0.25 * np.sin(2 * np.pi * (xx + 2 * yy))[None]
    noise = 0.08 * rng.standard_normal((3, SIZE, SIZE))
    return (np.clip(base + noise, 0, 1) * 255).astype(np.uint8)


def test_port_onnx_reader_matches_jax_reader(params):
    want = dict(_leaves(jax_reader(ONNX)))
    got = dict(_leaves(params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_param_count_and_roundtrip_exact(params):
    model = LightweightUNet()
    load_jax_params(model, params)
    assert sum(p.numel() for p in model.parameters()) == 486409
    back = dict(_leaves(export_jax_params(model)))
    want = dict(_leaves(params))
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_load_jax_params_rejects_mismatches(params):
    model = LightweightUNet()
    bad_shape = {**params, "output_conv_bias": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad_shape)
    bad_dtype = {**params, "output_conv_bias": params["output_conv_bias"].astype(np.float64)}
    with pytest.raises(ValueError, match="dtype"):
        load_jax_params(model, bad_dtype)
    missing = {k: v for k, v in params.items() if k != "dec1"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, missing)


@pytest.mark.parametrize("knobs", [dict(pallas_gn=True, fused_blocks="auto"), {}])
def test_f32_forward_matches_jax_on_production_weights(params, knobs):
    x = np.random.default_rng(0).random((2, SIZE, SIZE, 1)).astype(np.float32)
    want = np.asarray(jax.jit(JaxUNet(**knobs).apply)(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)}, jnp.asarray(x)))
    model = LightweightUNet(**knobs)
    load_jax_params(model, params)
    fk.reset_launch_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)
    assert set(fk.LAUNCHES.values()) == {0}  # CPU tensors: plain versions only


def test_engine_uint8_matches_jax_engine(params, frames):
    """Batch of 3 (padded to bucket 4) and submit(): uint8 within one level."""
    knobs = dict(pallas_gn=True, fused_blocks="auto")
    jeng = JaxEngine(JaxUNet(**knobs).apply, params, image_size=SIZE, max_batch_size=4,
                     compute_dtype=jnp.float32, warmup=False)
    want = jeng.infer_batch(frames)
    model = load_lightweight_unet(ONNX, dtype=torch.float32, device="cpu", **knobs)
    eng = InferenceEngine(model, image_size=SIZE, max_batch_size=4, compute_dtype=torch.float32,
                          device="cpu", warmup=False)
    try:
        got = eng.infer_batch(frames)
        assert got.shape == frames.shape and got.dtype == np.uint8
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
        futs = [eng.submit(f) for f in frames]
        outs = np.stack([f.result(timeout=60) for f in futs])
        assert np.abs(outs.astype(np.int16) - want.astype(np.int16)).max() <= 1
        assert eng.stats()["requests_served"] == 3
    finally:
        eng.stop()


def test_engine_concurrent_submits_all_resolve():
    """Many client threads racing first submits and the drainer's stats
    appends: one collector/drainer pair, every future resolved, every
    request counted."""
    import threading

    eng = InferenceEngine(LightweightUNet(generator=torch.Generator().manual_seed(0)),
                          image_size=16, max_batch_size=4, device="cpu",
                          compute_dtype=torch.float32, warmup=False)
    frames = (np.random.default_rng(3).random((48, 16, 16)) * 255).astype(np.uint8)
    futs = [None] * len(frames)

    def client(k):
        for i in range(k, len(frames), 16):
            futs[i] = eng.submit(frames[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        outs = [f.result(timeout=60) for f in futs]
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert eng._worker is None and eng._drainer is None
    assert all(o.shape == (16, 16) and o.dtype == np.uint8 for o in outs)
    assert eng.stats()["requests_served"] == len(frames)


def test_engine_f32_infer_batch_overlapping_submit_keeps_tf32_flags():
    """A float32 forward from infer_batch overlaps one from the collector
    thread (both wait for each other inside the model): TF32 stays off in
    both, the outputs are those of a lone forward, and the flags from
    before are restored afterwards."""
    import threading

    model = LightweightUNet(generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, image_size=16, max_batch_size=1, device="cpu",
                          compute_dtype=torch.float32, warmup=False)
    frames = (np.random.default_rng(4).random((2, 16, 16)) * 255).astype(np.uint8)
    want = [eng.infer_batch(f[None])[0] for f in frames]
    both_inside = threading.Barrier(2, timeout=30)
    seen = []

    def hook(_module, _args):
        both_inside.wait()
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    handle = model.enc1.register_forward_pre_hook(hook)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        fut = eng.submit(frames[0])
        got1 = eng.infer_batch(frames[1:])[0]
        got0 = fut.result(timeout=60)
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        handle.remove()
        eng.stop()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert seen == [(False, False), (False, False)]
    assert after == (True, True)
    np.testing.assert_array_equal(got0, want[0])
    np.testing.assert_array_equal(got1, want[1])


def test_engine_submit_checks_shape_and_dtype():
    eng = InferenceEngine(LightweightUNet(), image_size=16, max_batch_size=2, device="cpu",
                          compute_dtype=torch.float32, warmup=False)
    with pytest.raises(ValueError, match="frame"):
        eng.submit(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        eng.submit(np.zeros((16, 16), np.float32))
    assert eng._worker is None


def test_engine_reload_params_swaps_weights(params):
    eng = InferenceEngine(LightweightUNet(), image_size=16, max_batch_size=2, device="cpu",
                          compute_dtype=torch.float32, warmup=False)
    eng.reload_params(params)
    np.testing.assert_array_equal(export_jax_params(eng._model)["enc1"]["conv1"],
                                  params["enc1"]["conv1"])
    with pytest.raises(ValueError):
        eng.reload_params({**params, "output_conv_bias": np.zeros(3, np.float32)})


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(LightweightUNet(), image_size=16, warmup=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_lightweight_unet(ONNX)


def test_later_slices_raise_not_implemented():
    # int8 weights are served now (ROADMAP Queue 1 item 10); another mode is a ValueError
    eng = InferenceEngine(LightweightUNet(), device="cpu", warmup=False, quantize="int8")
    assert eng._int8[1]["enc1"]["conv1"].dtype == torch.int8
    with pytest.raises(ValueError, match="quantize"):
        InferenceEngine(LightweightUNet(), device="cpu", warmup=False, quantize="int4")
    # serving over a mesh is taken now (tests/test_torch_port_serve_mesh.py);
    # its batch must divide over the mesh, as the JAX engine's
    with pytest.raises(ValueError, match="must divide by mesh size"):
        InferenceEngine(LightweightUNet(), warmup=False, max_batch_size=3,
                        mesh=make_local_mesh(2, device="cpu"))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import image_enhancement_deglaring_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 10, names\n"
        "for m in ('serve.http_server', 'serve.tiling', 'serve.metrics', 'serve.openapi',\n"
        "          'serve.imaging', 'eval.harness', 'cli.serve', 'cli.enhance', 'cli.test_api',\n"
        "          'tools.load_test_api', 'serve.ipc', 'cli.evaluate', 'cli.check_dataset',\n"
        "          'cli.make_synthetic', 'cli.split_image', 'data.validate', 'utils.envfile',\n"
        "          'ops.image', '__main__', 'ops.augment_device', 'train.resident',\n"
        "          'models.optimized_unet', 'models.enhanced_unet', 'models.model_utils',\n"
        "          'data.jpeg', 'modelio.onnx_writer', 'modelio.onnx_exec', 'cli.export_onnx',\n"
        "          'cli.extract_weights', 'tools.e2e_lifecycle', 'ops.quant', 'parallel',\n"
        "          'parallel.sweep', 'cli.sweep', 'utils.config', 'tools.sweep_resident_bench',\n"
        "          'data.cv_ops', 'data.augment', 'utils.profiling', 'tools.crossval_artifact',\n"
        "          'tools.train_synthetic_demo', 'tools.train_roofline', 'native',\n"
        "          'parallel.mesh', 'parallel.distributed', 'data.jpeg_encode',\n"
        "          'serve.engine', 'cli.train', 'models.restormer', 'ops.fused_kernels',\n"
        "          'ops._build'):\n"
        "    assert pkg.__name__ + '.' + m in names, m\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'PIL', 'cv2', 'matplotlib',\n"
        "              'image_enhancement_deglaring_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
