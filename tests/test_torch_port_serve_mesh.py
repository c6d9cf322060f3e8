"""The port's serving over several devices of one process (``parallel.mesh.
LocalMesh``: ``InferenceEngine(mesh=)``, ``TiledInference(mesh=)``,
``create_server(mesh=)``, ``cli.serve`` / ``cli.enhance --data_parallel``)
against the JAX package's over ``make_mesh(n)`` on its CPU devices, on
the CPU with two CPU replicas.

- The engine, f32, a narrow LightweightUNet (width 4, 2 groups) at 32x32
  on JAX's weights: 8 frames and a ragged 3 within one uint8 level of
  JAX's engine over a 2-device mesh and of the port's single engine (the
  packages' f32 summation orders may flip one truncation, as
  tests/test_torch_port_serve.py's gate);
- ``_bucket_for`` of the engine and the tiler equal to JAX's for every
  batch up to twice the largest, on meshes of 2 and 3;
- the tiler over a mesh within one level of JAX's tiler over a mesh;
- ``create_server(mesh=)`` on deploy/models/best_model.onnx over HTTP
  (JAX tests/test_serve.py's ``test_http_infer_on_cli_built_mesh``):
  answers within one level of a single engine, every fill's bucket a
  multiple of 2, a tile request within one level of a single tiler;
- ``build_serving_mesh`` prints and returns what JAX's does (the card
  count patched to JAX's 8 CPU devices), and ``cli.serve`` /
  ``cli.enhance --data_parallel`` run on the mesh it gives (``cli.enhance``
  within one level of one device in both modes, JAX tests/test_cli.py's
  ``test_enhance_data_parallel_matches_single_device``).
"""

import concurrent.futures
import io
import os
import signal
import threading
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_enhancement_deglaring_tpu.cli import serve as jax_serve_cli
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.parallel import make_mesh as jax_make_mesh
from image_enhancement_deglaring_tpu.serve.engine import InferenceEngine as JaxEngine
from image_enhancement_deglaring_tpu.serve.tiling import TiledInference as JaxTiler
from image_enhancement_deglaring_tpu_torch.cli import enhance as enhance_cli
from image_enhancement_deglaring_tpu_torch.cli import serve as serve_cli
from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
from image_enhancement_deglaring_tpu_torch.parallel import LocalMesh, make_local_mesh
from image_enhancement_deglaring_tpu_torch.serve import InferenceEngine, TiledInference
from image_enhancement_deglaring_tpu_torch.serve import http_server
from tests.test_torch_port_serve import (
    _free_port,
    _http,
    _pixels,
    _port_model,
    _upload_png,
    _wait_ready,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")
SIZE = 32
LEVELS = 1  # uint8 levels between f32 engines (tests/test_torch_port_serve.py)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def narrow():
    """(JAX model, its params): the narrow LightweightUNet the port loads."""
    model = JaxUNet(features_start=4, num_groups=2)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 1)))["params"]
    return model, params


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


def test_local_mesh_devices_and_refusals(monkeypatch):
    mesh = make_local_mesh(3, device="cpu")
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert LocalMesh(("cuda:0", "cuda:0")).devices == (torch.device("cuda", 0),) * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_local_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="2 CUDA device"):
        make_local_mesh(3)
    with pytest.raises(ValueError, match="one type"):
        LocalMesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError, match="at least one"):
        make_local_mesh(0, device="cpu")


def test_engine_over_a_mesh_equals_jax_and_one_device(narrow):
    model, params = narrow
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, SIZE, SIZE), dtype=np.uint8)
    jeng = JaxEngine(model.apply, params, image_size=SIZE, max_batch_size=8,
                     compute_dtype=jnp.float32, warmup=False, mesh=jax_make_mesh(2))
    peng = InferenceEngine(_port_model(params), image_size=SIZE, max_batch_size=8,
                           compute_dtype=torch.float32, warmup=False,
                           mesh=make_local_mesh(2, device="cpu"))
    solo = InferenceEngine(_port_model(params), image_size=SIZE, max_batch_size=8,
                           compute_dtype=torch.float32, warmup=False, device="cpu")
    reps = peng._replicas
    assert len(reps) == 2 and reps[0].model is not reps[1].model
    for a, b in zip(reps[0].model.parameters(), reps[1].model.parameters()):
        assert torch.equal(a, b)
    for batch in (frames, frames[:3]):
        got = peng.infer_batch(batch)
        assert got.shape == batch.shape and got.dtype == np.uint8
        assert _levels(got, jeng.infer_batch(batch)) <= LEVELS
        assert _levels(got, solo.infer_batch(batch)) <= LEVELS
    # submit() through the collector and drainer: the slices joined in row order
    futs = [peng.submit(f) for f in frames[:5]]
    try:
        for f, fut in zip(frames[:5], futs):
            assert _levels(fut.result(timeout=60), solo.infer_one(f)) <= LEVELS
    finally:
        peng.stop()


@pytest.mark.parametrize("n, max_batch", [(2, 8), (2, 6), (3, 6), (3, 12)])
def test_bucket_for_equals_jax(narrow, n, max_batch):
    model, params = narrow
    jeng = JaxEngine(model.apply, params, image_size=SIZE, max_batch_size=max_batch,
                     compute_dtype=jnp.float32, warmup=False, mesh=jax_make_mesh(n))
    peng = InferenceEngine(_port_model(params), image_size=SIZE, max_batch_size=max_batch,
                           compute_dtype=torch.float32, warmup=False,
                           mesh=make_local_mesh(n, device="cpu"))
    for b in range(1, 2 * max_batch + 1):
        assert peng._bucket_for(b) == jeng._bucket_for(b), b
    jt = JaxTiler(model.apply, params, tile=SIZE, overlap=8, compute_dtype=jnp.float32,
                  mesh=jax_make_mesh(n), max_tiles_per_batch=max_batch)
    pt = TiledInference(_port_model(params), tile=SIZE, overlap=8, compute_dtype=torch.float32,
                        mesh=make_local_mesh(n, device="cpu"), max_tiles_per_batch=max_batch)
    for b in range(1, 2 * max_batch + 1):
        assert pt._bucket_for(b) == jt._bucket_for(b), b
    with pytest.raises(ValueError, match="must divide by mesh size"):
        InferenceEngine(_port_model(params), max_batch_size=max_batch + 1, warmup=False,
                        mesh=make_local_mesh(n, device="cpu"))


def test_tiler_over_a_mesh_equals_jax(narrow):
    """A 64x64 image in 16x16 tiles with overlap 4 (25 tiles: chunks of 8,
    8, 8 and a bucket of 2 for the last one)."""
    model, params = narrow
    img = np.random.default_rng(1).integers(0, 256, (64, 64), dtype=np.uint8)
    kw = dict(tile=16, overlap=4, max_tiles_per_batch=8)
    jt = JaxTiler(model.apply, params, compute_dtype=jnp.float32, mesh=jax_make_mesh(2), **kw)
    pt = TiledInference(_port_model(params), compute_dtype=torch.float32,
                        mesh=make_local_mesh(2, device="cpu"), **kw)
    solo = TiledInference(_port_model(params), compute_dtype=torch.float32, device="cpu", **kw)
    got = pt(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    assert _levels(got, jt(img)) <= LEVELS and _levels(got, solo(img)) <= LEVELS
    assert pt._buckets_seen == jt._buckets_seen == {2, 8}


def test_create_server_over_a_mesh_answers_http(tmp_path, capsys):
    """cli.serve's resolver builds the mesh (2 CPU replicas, max batch 3
    rounded up to 4); six concurrent /infer requests and a tile request."""
    mesh, max_batch = serve_cli.build_serving_mesh(2, 3, "cpu")
    assert mesh.size == 2 and max_batch == 4
    assert "rounded up to 4" in capsys.readouterr().out
    server = http_server.create_server(
        ONNX, host="127.0.0.1", port=_free_port(), mode="both", max_batch_size=max_batch,
        batch_timeout_ms=20.0, compute_dtype=torch.float32, image_size=SIZE, tile_overlap=8,
        log_dir=str(tmp_path), mesh=mesh)
    assert server.engine.mesh is mesh and server.tiler.mesh is mesh
    threading.Thread(target=server.run, daemon=True).start()
    try:
        _wait_ready(server.port)
        rng = np.random.default_rng(2)
        imgs = [rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8) for _ in range(6)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
            futs = [pool.submit(_http, server.port, "POST", "/infer", *_upload_png(im))
                    for im in imgs]
            results = [f.result(timeout=120) for f in futs]
        model, _ = load_model_for_eval(ONNX, compute_dtype=torch.float32, device="cpu")
        solo = InferenceEngine(model, image_size=SIZE, max_batch_size=1,
                               compute_dtype=torch.float32, warmup=False, device="cpu")
        for (status, _, data), img in zip(results, imgs):
            assert status == 200
            assert _levels(_pixels(data), solo.infer_one(img)) <= LEVELS
        fills = list(server.engine._batch_fill)
        assert fills and all(server.engine._bucket_for(b) % 2 == 0 for b in fills)
        big = rng.integers(0, 256, (40, 52), dtype=np.uint8)
        status, _, data = _http(server.port, "POST", "/infer?mode=tile", *_upload_png(big))
        solo_tiler = TiledInference(model, tile=SIZE, overlap=8, compute_dtype=torch.float32,
                                    device="cpu")
        assert status == 200 and _levels(_pixels(data), solo_tiler(big)) <= LEVELS
    finally:
        server.engine.stop()


@pytest.mark.parametrize("args", [(None, 8), (99, 8), (1, 8), (0, 6), (4, 6), (8, 8)])
def test_build_serving_mesh_prints_and_resolves_as_jax(monkeypatch, args):
    """JAX's resolver over its 8 CPU devices; the port's with the card
    count patched to 8 (``make_local_mesh`` reads the same count)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    out_j, out_p = io.StringIO(), io.StringIO()
    with redirect_stdout(out_j):
        jmesh, jmax = jax_serve_cli.build_serving_mesh(*args)
    with redirect_stdout(out_p):
        pmesh, pmax = serve_cli.build_serving_mesh(*args)
    assert out_p.getvalue() == out_j.getvalue() and pmax == jmax
    assert (pmesh is None) == (jmesh is None)
    if pmesh is not None:
        assert pmesh.size == jmesh.devices.size
        assert pmesh.devices == tuple(torch.device("cuda", i) for i in range(pmesh.size))


def test_build_serving_mesh_on_one_card_serves_single(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert serve_cli.build_serving_mesh(2, 8) == (None, 8)
    out = capsys.readouterr().out
    assert "requested --data_parallel 2, but only 1 device(s) available; using 1" in out
    assert "serving single-chip" in out


def test_cli_serve_data_parallel_reaches_engine_tiler_and_workers(monkeypatch):
    """``--data_parallel 2``: the engine and the tiler on the mesh; with
    ``--workers 2`` this process keeps the engine on the mesh and the
    workers proxy to it (``serve.ipc``, stubbed here)."""
    from image_enhancement_deglaring_tpu_torch.serve import ipc

    served, proxied = [], []
    monkeypatch.setattr(http_server.DeglareServer, "run", lambda self: served.append(self))

    class _Workers:
        def any_alive(self):
            return False

        def stop(self):
            pass

    monkeypatch.setattr(ipc, "serve_multiprocess",
                        lambda engine, **kw: proxied.append(engine) or _Workers())
    monkeypatch.setattr(signal, "signal", lambda *a: None)  # main() would take SIGTERM
    common = ["--model_path", ONNX, "--device", "cpu", "--data_parallel", "2",
              "--image_size", str(SIZE), "--max_batch_size", "3", "--compute_dtype", "float32"]
    serve_cli.main(common + ["--mode", "both", "--tile_overlap", "8"])
    (server,) = served
    assert server.engine.mesh.size == 2 and server.tiler.mesh.size == 2
    assert server.engine.max_batch_size == 4
    serve_cli.main(common + ["--workers", "2"])
    (engine,) = proxied
    assert engine.mesh.size == 2 and engine._worker is None  # main() stopped it


@pytest.mark.parametrize("mode", ["resize", "tile"])
def test_cli_enhance_data_parallel_equals_one_device(tmp_path, mode, capsys):
    inp = tmp_path / "in"
    inp.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (48, 48), dtype=np.uint8)).save(inp / f"img{i}.png")
    common = ["--input", str(inp), "--model_path", ONNX, "--image_size", str(SIZE),
              "--mode", mode, "--tile_overlap", "8", "--device", "cpu"]
    enhance_cli.main(common + ["--output_dir", str(tmp_path / "solo")])
    enhance_cli.main(common + ["--output_dir", str(tmp_path / "dp"), "--batch_size", "3",
                               "--data_parallel", "2"])
    assert "data-parallel over 2 chips" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "solo"))
    assert names == sorted(os.listdir(tmp_path / "dp")) and len(names) == 3
    for name in names:
        with Image.open(tmp_path / "solo" / name) as a, Image.open(tmp_path / "dp" / name) as b:
            assert _levels(a, b) <= LEVELS, name
