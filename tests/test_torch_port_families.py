"""``.pth`` artifacts and every model family served, against the JAX
package on the CPU.

- ``load_torch_state_dict``: raw state dicts and the reference's training
  checkpoints ({"model_state_dict": ...}, {"state_dict": ...}) of all three
  families give the JAX loader's arrays, equal; ``detect_model_arch``
  agrees with JAX's; ``load_model_for_eval``'s float32 CPU forward matches
  the JAX loader's forward on the same ``.pth`` (atol 2e-5, rtol 2e-5,
  ``tests/test_torch_import.py``'s tolerance); ``weights_only`` refuses a
  pickled non-tensor object unless ``allow_pickle=True``, and a missing or
  corrupt file surfaces as itself (ports of ``tests/test_torch_import.py``
  and ``tests/test_arch_detect.py``'s ``.pth`` cases).
- ``tests/torch_port_weights.state_dict_from_params``, which writes the
  seeded trees these tests save, writes what the JAX importers read back
  exactly.
- ``create_server`` from a ``.pth`` of OptimizedUNet and EnhancedUNet:
  ``/infer`` in resize and tile modes within one uint8 level of the JAX
  server on the same file (float32, 32x32: one level, as for
  LightweightUNet in ``tests/test_torch_port_serve.py``); ``/reload`` of an
  EnhancedUNet ``.pth`` swaps weights and BatchNorm statistics together,
  in the engine and the tiler (the port of ``tests/test_serve.py``'s
  ``test_http_reload_enhanced_rebinds_params_and_stats``); ``cli.serve
  --model enhanced --workers 2`` answers through its worker processes.
"""

import argparse
import base64
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_enhancement_deglaring_tpu.eval import load_model_for_eval as jax_load_model_for_eval
from image_enhancement_deglaring_tpu.modelio import detect_model_arch as jax_detect_model_arch
from image_enhancement_deglaring_tpu.modelio import load_torch_state_dict as jax_load_state_dict
from image_enhancement_deglaring_tpu.modelio.params_import import (
    enhanced_unet_params_from_state_dict as jax_enhanced_from_sd,
)
from image_enhancement_deglaring_tpu.modelio.params_import import (
    lightweight_unet_params_from_state_dict as jax_lightweight_from_sd,
)
from image_enhancement_deglaring_tpu.modelio.params_import import (
    optimized_unet_params_from_state_dict as jax_optimized_from_sd,
)
from image_enhancement_deglaring_tpu.serve import http_server as jax_http
from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
from image_enhancement_deglaring_tpu_torch.modelio import (
    detect_model_arch,
    load_torch_state_dict,
)
from image_enhancement_deglaring_tpu_torch.serve import http_server
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from tests.torch_port_weights import save_pth, seeded_tree, state_dict_from_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
WIDTH = 8  # narrow families keep the JAX compiles short
LEVELS = 1
ARCHS = ["lightweight", "optimized", "enhanced"]
JAX_IMPORTERS = {"lightweight": jax_lightweight_from_sd, "optimized": jax_optimized_from_sd,
                 "enhanced": jax_enhanced_from_sd}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pth_files(tmp_path_factory):
    """arch -> (raw .pth path, params, batch_stats) from seed 0, and the
    EnhancedUNet .pth of seed 1 under "enhanced_1"."""
    root = tmp_path_factory.mktemp("pth")
    out = {}
    for arch, seed in (("lightweight", 0), ("optimized", 0), ("enhanced", 0), ("enhanced", 1)):
        params, stats = seeded_tree(arch, seed, WIDTH)
        sd = state_dict_from_params(arch, params, stats)
        key = arch if seed == 0 else f"{arch}_{seed}"
        out[key] = (save_pth(root / f"{key}.pth", sd), params, stats)
    return out


def _assert_trees_equal(got, want):
    g, w = flatten_tree(got), flatten_tree(_np(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), w[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_from_params_is_what_the_jax_importer_reads(pth_files, arch):
    path, params, stats = pth_files[arch]
    sd = state_dict_from_params(arch, params, stats)
    back = JAX_IMPORTERS[arch](sd)
    if arch == "enhanced":
        _assert_trees_equal(back[0], params)
        _assert_trees_equal(back[1], stats)
    else:
        _assert_trees_equal(back, params)


@pytest.fixture(scope="module")
def jax_forwards(pth_files):
    """arch -> (input, the JAX loader's f32 forward on the raw .pth)."""
    x = np.random.default_rng(0).random((2, SIZE, SIZE, 1), dtype=np.float32)
    out = {}
    for arch in ARCHS:
        apply_fn, params = jax_load_model_for_eval(pth_files[arch][0], model_arch="auto")
        out[arch] = x, np.asarray(jax.jit(apply_fn)({"params": params}, jnp.asarray(x)))
    return out


@pytest.mark.parametrize("wrap", ["raw", "model_state_dict", "state_dict"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pth_loads_equal_jax(pth_files, jax_forwards, tmp_path, arch, wrap):
    _, params, stats = pth_files[arch]
    path = save_pth(tmp_path / f"{arch}.pth", state_dict_from_params(arch, params, stats), wrap)
    got, want = load_torch_state_dict(path), jax_load_state_dict(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert detect_model_arch(path) == jax_detect_model_arch(path) == arch
    model, loaded = load_model_for_eval(path, device="cpu")
    if arch == "enhanced":
        _assert_trees_equal(loaded["params"], params)
        _assert_trees_equal(loaded["batch_stats"], stats)
    else:
        _assert_trees_equal(loaded, params)
    x, want_y = jax_forwards[arch]
    with torch.no_grad():
        got_y = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_y, want_y, rtol=2e-5, atol=2e-5)


def test_detect_model_arch_census_equals_jax(tmp_path):
    """tests/test_arch_detect.py's .pth census: one key is enough."""
    cases = {
        "lightweight": {"enc1.0.weight": torch.zeros(8, 1, 3, 3)},
        "optimized": {"enc1.0.weight": torch.zeros(16, 1, 3, 3),
                      "attention4.fc.0.weight": torch.zeros(8, 128)},
        "enhanced": {"enc1.conv_block.0.weight": torch.zeros(16, 1, 3, 3)},
    }
    for arch, sd in cases.items():
        for ext in (".pth", ".pt"):
            p = str(tmp_path / f"{arch}{ext}")
            torch.save(sd, p)
            assert detect_model_arch(p) == jax_detect_model_arch(p) == arch


def test_load_torch_state_dict_refuses_pickles_unless_allowed(pth_files, tmp_path):
    """A checkpoint that pickles a non-tensor object (the training
    script's args) is refused without ``allow_pickle``; a missing or
    corrupt file raises as itself, with no advice to turn the check off."""
    sd = torch.load(pth_files["lightweight"][0], weights_only=True)
    path = str(tmp_path / "wrapped.pth")
    torch.save({"model_state_dict": sd, "args": argparse.Namespace(lr=1e-3)}, path)
    with pytest.raises(ValueError, match="weights_only"):
        load_torch_state_dict(path)
    with pytest.raises(ValueError, match="weights_only"):
        detect_model_arch(path)
    loaded = load_torch_state_dict(path, allow_pickle=True)
    assert set(loaded) == set(sd) == set(jax_load_state_dict(path, allow_pickle=True))
    with pytest.raises(FileNotFoundError):
        load_torch_state_dict(str(tmp_path / "nope.pth"))
    corrupt = tmp_path / "corrupt.pth"
    corrupt.write_bytes(b"PK\x03\x04 definitely not a checkpoint")
    with pytest.raises(Exception) as want:
        jax_load_state_dict(str(corrupt))
    with pytest.raises(want.type) as got:
        load_torch_state_dict(str(corrupt))
    assert "allow_pickle" not in str(got.value)


# ------------------------------------------------------------------ serving


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _wait_ready(port, ok=lambda: True, timeout=120):
    end = time.time() + timeout
    while time.time() < end and ok():
        try:
            if _http(port, "GET", "/ping")[0] == 200:
                return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"server on port {port} never became ready")


def _serve(server):
    threading.Thread(target=server.run, daemon=True).start()
    _wait_ready(server.port)
    return server.port


def _upload(img_u8: np.ndarray):
    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, format="PNG")
    body = (b'--fam\r\nContent-Disposition: form-data; name="image"; filename="t.png"\r\n'
            b"Content-Type: image/png\r\n\r\n" + buf.getvalue() + b"\r\n--fam--\r\n")
    return body, {"Content-Type": "multipart/form-data; boundary=fam"}


def _pixels(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(base64.b64decode(json.loads(data)["image"]))) as im:
        return np.asarray(im).astype(np.int16)


def _port_server(path, **kw):
    return http_server.create_server(path, host="127.0.0.1", port=_free_port(), mode="both",
                                     image_size=SIZE, tile_overlap=8, warmup=False,
                                     compute_dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("arch", ["optimized", "enhanced"])
def test_infer_each_family_equals_jax_server(pth_files, tmp_path, arch):
    path = pth_files[arch][0]
    logs = str(tmp_path / "logs")
    jax_server = jax_http.create_server(path, host="127.0.0.1", port=_free_port(), mode="both",
                                        image_size=SIZE, tile_overlap=8, warmup=False,
                                        compute_dtype=jnp.float32, log_dir=logs)
    server = _port_server(path, log_dir=logs)
    try:
        assert server.model_info == jax_server.model_info
        assert server.model_info["model"] == arch
        body, headers = _upload(np.random.default_rng(2).integers(0, 256, (40, 52, 3),
                                                                  dtype=np.uint8))
        ports = {"jax": _serve(jax_server), "port": _serve(server)}
        for route in ("/infer", "/infer?mode=tile"):
            got = {}
            for name, port in ports.items():
                status, data = _http(port, "POST", route, body, headers)
                assert status == 200, (name, data[:200])
                got[name] = _pixels(data)
            diff = np.abs(got["port"] - got["jax"])
            print(f"{arch} {route}: max |port - jax| {diff.max()} levels, "
                  f"{int((diff > 0).sum())} of {diff.size} pixels differ")
            assert got["port"].shape == (40, 52) and diff.max() <= LEVELS
    finally:
        jax_server.engine.stop()
        server.engine.stop()


def test_http_reload_enhanced_rebinds_params_and_stats(pth_files, tmp_path):
    """POST /reload of a second EnhancedUNet .pth (other weights, other
    running statistics): the answers, resize and tile, then equal a fresh
    server's on that file, and differ from before."""
    first, second = pth_files["enhanced"][0], pth_files["enhanced_1"][0]
    server = _port_server(first, allow_reload=True, log_dir=str(tmp_path / "a"))
    fresh = _port_server(second, log_dir=str(tmp_path / "b"))
    try:
        port, fresh_port = _serve(server), _serve(fresh)
        body, headers = _upload(np.random.default_rng(3).integers(0, 256, (SIZE, SIZE + 8),
                                                                  dtype=np.uint8))
        routes = ("/infer", "/infer?mode=tile")
        before = {r: _pixels(_http(port, "POST", r, body, headers)[1]) for r in routes}
        status, data = _http(port, "POST", "/reload", json.dumps({"model_path": second}).encode())
        assert status == 200, data
        assert json.loads(data)["model"] == "enhanced"
        for r in routes:
            after = _pixels(_http(port, "POST", r, body, headers)[1])
            assert np.any(after != before[r]), r
            np.testing.assert_array_equal(after, _pixels(_http(fresh_port, "POST", r, body,
                                                               headers)[1]), err_msg=r)
        # a statistics-only swap is visible too: the second file's weights
        # with the first file's statistics answer otherwise
        _, params1, _ = pth_files["enhanced_1"]
        mixed = save_pth(tmp_path / "mixed.pth",
                         state_dict_from_params("enhanced", params1, pth_files["enhanced"][2]))
        status, _ = _http(port, "POST", "/reload", json.dumps({"model_path": mixed}).encode())
        assert status == 200
        assert np.any(_pixels(_http(port, "POST", "/infer", body, headers)[1])
                      != _pixels(_http(fresh_port, "POST", "/infer", body, headers)[1]))
    finally:
        server.engine.stop()
        fresh.engine.stop()


def test_cli_serve_enhanced_pth_with_workers(pth_files, tmp_path):
    """``cli.serve --model enhanced --workers 2`` from a .pth (the refusal
    of other families is gone): /infer through a worker within one level of
    the engine called directly, then SIGTERM drains to exit 0."""
    path = pth_files["enhanced"][0]
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_enhancement_deglaring_tpu_torch.cli.serve",
         "--model_path", path, "--model", "enhanced", "--host", "127.0.0.1", "--port", str(port),
         "--workers", "2", "--device", "cpu", "--image_size", str(SIZE),
         "--compute_dtype", "float32", "--max_batch_size", "2", "--log_dir", str(tmp_path / "l")],
        cwd=REPO, env={**os.environ, "TMPDIR": str(tmp_path)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait_ready(port, ok=lambda: proc.poll() is None)
        img = np.random.default_rng(5).integers(0, 256, (SIZE, SIZE), dtype=np.uint8)
        status, data = _http(port, "POST", "/infer", *_upload(img))
        assert status == 200, data[:200]
        server = _port_server(path, log_dir=str(tmp_path / "direct"))
        try:
            want = server.engine.infer_batch(img[None])[0].astype(np.int16)
        finally:
            server.engine.stop()
        assert np.abs(_pixels(data) - want).max() <= LEVELS
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0, out
    finally:
        proc.kill()
        proc.wait(30)
