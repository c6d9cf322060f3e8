"""The port's HTTP serving front end against the JAX package's, on the CPU.

- The host image path (``serve.imaging``) against PIL, bit for bit: PNG
  decode of every bit depth, colour type and interlace, the luma
  conversion, the LANCZOS resize both ways, and the encoder read back by
  PIL.
- ``parse_multipart``, ``prometheus_text``, ``openapi_spec`` and
  ``docs_html`` against the JAX package's on the JAX tests' inputs and
  seeded fuzz, equal.
- The two ``DeglareServer``s side by side on 127.0.0.1, sharing one
  deterministic numpy stub engine: every request of the JAX live-server
  tests goes to both and gets the same status and bytes (for ``/stats`` and
  ``/metrics``, the same numbers but the host phase timings), ``/infer``
  the same pixels, JPEG uploads included (the port's own decoder,
  ``data.jpeg``).
- ``create_server`` on deploy/models/best_model.onnx, float32, 32x32, in
  both packages: one resized request (read: equal at every pixel). The
  f32 engines agree within one uint8 level, a float32 summation-order
  difference can flip one truncation, and the LANCZOS upsize does not
  widen a one-level step, so the gate is 1 level.
- ``TiledInference`` against JAX's on a seeded narrow model (read: equal
  at every pixel; gate 1 level, as above).
- Model loading, ``decode_inference_image``, and the CLIs against the JAX
  package's.
"""

import base64
import http.client
import io
import json
import os
import socket
import struct
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_enhancement_deglaring_tpu.cli import enhance as jax_enhance_cli
from image_enhancement_deglaring_tpu.cli import serve as jax_serve_cli
from image_enhancement_deglaring_tpu.cli import test_api as jax_test_api_cli
from image_enhancement_deglaring_tpu.data import pipeline as jax_pipeline
from image_enhancement_deglaring_tpu.eval import load_model_for_eval as jax_load_model_for_eval
from image_enhancement_deglaring_tpu.modelio import detect_model_arch as jax_detect_model_arch
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.serve import http_server as jax_http
from image_enhancement_deglaring_tpu.serve import metrics as jax_metrics
from image_enhancement_deglaring_tpu.serve import openapi as jax_openapi
from image_enhancement_deglaring_tpu.serve.tiling import TiledInference as JaxTiler
from image_enhancement_deglaring_tpu_torch.cli import enhance as enhance_cli
from image_enhancement_deglaring_tpu_torch.cli import serve as serve_cli
from image_enhancement_deglaring_tpu_torch.cli import test_api as test_api_cli
from image_enhancement_deglaring_tpu_torch.data import decode_inference_image
from image_enhancement_deglaring_tpu_torch.data.png import encode_png
from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
from image_enhancement_deglaring_tpu_torch.modelio import detect_model_arch, load_jax_params
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.parallel import make_local_mesh
from image_enhancement_deglaring_tpu_torch.serve import http_server, imaging, metrics, openapi
from image_enhancement_deglaring_tpu_torch.serve.tiling import TiledInference
from image_enhancement_deglaring_tpu_torch.tools import load_test_api
from image_enhancement_deglaring_tpu_torch.train.checkpoint import save_checkpoint
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PNG_FIXTURES = ["photo_noise.png", "photo_16bit.png", "photo_palette_trns.png",
                "photo_1bit.png", "photo_interlaced.png"]
SIZE = 64  # the stub servers' image size, the JAX serve tests'
CREATE_SIZE = 32
F32_LEVELS = 1  # f32 engines and tilers of the two packages, uint8 levels


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _assert_equals_pil(data: bytes) -> None:
    """decode_image and to_luma against PIL on one file."""
    with Image.open(io.BytesIO(data)) as im:
        want, mode = np.asarray(im), im.mode
        want_l = np.asarray(im.convert("L"))
    got = imaging.decode_image(data)
    assert got.mode == mode
    assert got.pixels.dtype == want.dtype and got.pixels.shape == want.shape
    np.testing.assert_array_equal(got.pixels, want)
    luma = imaging.to_luma(got.pixels, got.mode, got.palette)
    assert luma.dtype == np.uint8
    np.testing.assert_array_equal(luma, want_l)


# ------------------------------------------------------ image path vs PIL


@pytest.mark.parametrize("name", PNG_FIXTURES)
def test_decode_and_luma_equal_pil_on_fixtures(name):
    _assert_equals_pil(_fixture(name))


def _upload_mode_image(mode: str, seed: int) -> Image.Image:
    """The uploads of the JAX serve tests' exotic modes (test_serve.py:478):
    a random gray frame converted to ``mode``."""
    rng = np.random.default_rng(seed)
    img = Image.fromarray((rng.random((SIZE, SIZE)) * 255).astype(np.uint8))
    if mode in ("RGB", "RGBA"):
        img = Image.fromarray(rng.integers(0, 256, (23, 37, len(mode)), dtype=np.uint8), mode)
    elif mode == "I;16":
        img = img.convert("I").convert("I;16")
    elif mode != "L":
        img = img.convert(mode)
    return img


@pytest.mark.parametrize("mode", ["L", "LA", "P", "1", "I;16", "RGB", "RGBA"])
def test_decode_and_luma_equal_pil_on_uploaded_modes(mode):
    for seed in range(2):
        for optimize in (False, True):
            _assert_equals_pil(_pil_png(_upload_mode_image(mode, seed), optimize=optimize))


def _png_bytes(samples: np.ndarray, depth: int, colour: int, interlace: bool,
               plte: bytes | None = None, trns: bytes | None = None) -> bytes:
    """A PNG written here, independent of the port's codec: samples
    (H, W, S) at ``depth`` bits, rows under filter "up" (then "sub" on odd
    rows), Adam7 passes when ``interlace``."""
    h, w, s = samples.shape
    bpp = max(1, depth * s // 8)

    def pack(rows: np.ndarray) -> list[bytes]:
        out = []
        for row in rows:
            flat = row.reshape(-1).astype(np.uint32)
            if depth == 16:
                out.append(flat.astype(">u2").tobytes())
            elif depth == 8:
                out.append(flat.astype(np.uint8).tobytes())
            else:
                per = 8 // depth
                flat = np.concatenate([flat, np.zeros(-len(flat) % per, np.uint32)])
                groups = flat.reshape(-1, per)
                shifts = np.arange(8 - depth, -1, -depth)
                out.append((groups << shifts).sum(axis=1).astype(np.uint8).tobytes())
        return out

    def filtered(lines: list[bytes]) -> bytes:
        raw, prev = b"", bytes(len(lines[0])) if lines else b""
        for r, line in enumerate(lines):
            cur = np.frombuffer(line, np.uint8).astype(np.int32)
            if r % 2:  # sub
                left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
                raw += b"\x01" + ((cur - left) & 255).astype(np.uint8).tobytes()
            else:  # up
                up = np.frombuffer(prev, np.uint8).astype(np.int32)
                raw += b"\x02" + ((cur - up) & 255).astype(np.uint8).tobytes()
            prev = line
        return raw

    if interlace:
        raw = b""
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += filtered(pack(sub))
    else:
        raw = filtered(pack(samples))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    extra = (chunk(b"PLTE", plte) if plte else b"") + (chunk(b"tRNS", trns) if trns else b"")
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
            + extra + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


DEPTH_COLOUR = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3),
                (4, 3), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth,colour", DEPTH_COLOUR)
def test_decode_equals_pil_every_depth_and_colour_type(depth, colour, interlace):
    """Every valid (bit depth, colour type), plain and Adam7, at sizes
    whose rows end mid-byte and whose passes are partly empty; palettes
    shorter than the indices reach (PIL reads those entries as black)."""
    rng = np.random.default_rng(depth * 100 + colour * 10 + interlace)
    s = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    for h, w in ((13, 11), (3, 2), (1, 1), (9, 17)):
        samples = rng.integers(0, 1 << depth, (h, w, s), dtype=np.uint32)
        plte = trns = None
        if colour == 3:
            entries = int(rng.integers(1, (1 << depth) + 1))
            plte = rng.integers(0, 256, 3 * entries, dtype=np.uint8).tobytes()
            trns = rng.integers(0, 256, max(1, entries // 2), dtype=np.uint8).tobytes()
        _assert_equals_pil(_png_bytes(samples, depth, colour, interlace, plte, trns))


def test_jpeg_and_unreadable_bodies_raise_named_errors():
    """JPEG bodies decode as PIL decodes them (the JAX tests' two JPEG
    uploads); a JPEG cut after its header and other unreadable bodies
    raise ValueError naming what is wrong."""
    _assert_equals_pil(_fixture("photo_noise.jpg"))
    _assert_equals_pil(_cmyk_jpeg())
    with pytest.raises(ValueError, match="truncated"):
        imaging.decode_image(b"\xff\xd8\xff\xe0junk")
    with pytest.raises(ValueError, match="not a PNG"):
        imaging.decode_image(b"not-a-png")
    good = _fixture("photo_noise.png")
    with pytest.raises(ValueError):
        imaging.decode_image(good[: len(good) // 2])
    with pytest.raises(ValueError, match="mode"):
        imaging.to_luma(np.zeros((2, 2, 3), np.uint8), "YCbCr")


LANCZOS_GROUPS = {
    "down": [((1024, 768), (512, 512)), ((160, 160), (64, 64)), ((600, 37), (64, 64))],
    "up": [((512, 512), (1024, 768)), ((64, 64), (160, 160)), ((32, 32), (1200, 900))],
    "width_or_height_1": [((1, 7), (5, 3)), ((7, 1), (3, 9)), ((40, 52), (1, 64)),
                          ((64, 64), (64, 1)), ((1, 1), (3, 2))],
    "scale_above_3": [((4000, 30), (512, 512)), ((13, 2000), (512, 5)), ((700, 700), (64, 64))],
    "one_axis": [((64, 100), (64, 64)), ((100, 64), (64, 64)), ((64, 64), (64, 160))],
    "phone_photo": [((4032, 3024), (512, 512)), ((512, 512), (4032, 3024))],
    "seeded": None,
}


@pytest.mark.parametrize("group", list(LANCZOS_GROUPS))
def test_lanczos_equals_pil(group):
    rng = np.random.default_rng(len(group))
    cases = LANCZOS_GROUPS[group]
    if cases is None:
        cases = [((int(rng.integers(1, 260)), int(rng.integers(1, 260))),
                  (int(rng.integers(1, 260)), int(rng.integers(1, 260)))) for _ in range(40)]
    for (sw, sh), size in cases:
        # noise and a smooth ramp with flat runs: both hit the 0/255 clip
        a = rng.integers(0, 256, (sh, sw), dtype=np.uint8)
        a[: sh // 2] = (np.add.outer(np.arange(sh // 2), np.arange(sw)) * 5 % 256).astype(np.uint8)
        want = np.asarray(Image.fromarray(a).resize(size, Image.LANCZOS))
        got = imaging.resize_lanczos(a, size)
        assert got.dtype == np.uint8 and got.shape == want.shape, ((sw, sh), size)
        np.testing.assert_array_equal(got, want, err_msg=f"{(sw, sh)} -> {size}")


def test_lanczos_rejects_what_pil_would_not_take():
    with pytest.raises(ValueError, match="uint8"):
        imaging.resize_lanczos(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError, match="positive"):
        imaging.resize_lanczos(np.zeros((4, 4), np.uint8), (0, 2))


@pytest.mark.parametrize("level", [-1, 1, 9])
def test_encode_is_read_back_by_pil(level):
    rng = np.random.default_rng(level + 2)
    for shape in ((1, 1), (40, 52), (64, 64)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        data = encode_png(a, compress_level=level)
        with Image.open(io.BytesIO(data)) as im:
            assert im.mode == "L"
            np.testing.assert_array_equal(np.asarray(im), a)
    smaller = encode_png(np.zeros((64, 64), np.uint8), compress_level=9)
    assert len(smaller) <= len(encode_png(np.zeros((64, 64), np.uint8), compress_level=1))


# -------------------------------------------------- pure functions vs JAX


def _part(boundary: str, name: str, payload: bytes) -> bytes:
    return (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="{name}"; filename="f.bin"\r\n'
        "Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()


def _multipart_cases(group: str):
    """(body, content type) pairs of the JAX tests' multipart inputs."""
    if group == "roundtrip":
        yield (("--XBOUND\r\nContent-Disposition: form-data; name=\"image\"; "
                "filename=\"x.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
               + b"\x89PNGdata\r\n--XBOUND--\r\n", "multipart/form-data; boundary=XBOUND")
    elif group == "binary_tails":
        for p in (b"ends in lf\n", b"ends in crlf\r\n", b"ends in cr\r", b"\r\n\r\n",
                  b"\n" * 7, b"\x00\x01\r\n\x0a\x0d", b""):
            yield _part("B1", "image", p), "multipart/form-data; boundary=B1"
    elif group == "quoted":
        yield _part("a+b/c", "image", b"DATA"), 'multipart/form-data; boundary="a+b/c"'
        yield (b'--ZZ\r\nContent-Disposition: form-data; filename="a;name=evil.png"; '
               b'name="image"\r\n\r\nOK\r\n--ZZ--\r\n', "multipart/form-data; boundary=ZZ")
    elif group == "preamble":
        yield (b"this is a preamble to be ignored\r\n"
               + _part("MM", "image", b"\x89PNG\r\n\x1a\n blob \r\n")[:-len(b"--MM--\r\n")]
               + b'--MM\r\nContent-Disposition: form-data; name="meta"\r\n\r\nhello'
               + b"\r\n--MM--\r\nepilogue", "multipart/form-data; boundary=MM")
    elif group == "junk":
        rng = np.random.default_rng(42)
        bodies = [b"", b"--", b"\r\n\r\n\r\n", bytes(rng.integers(0, 256, 512, dtype=np.uint8)),
                  b"--bound\r\nContent-Disposition: form-data\r\n\r\nxx",
                  b"--bound\r\nContent-Disposition: form-data; name=\r\n\r\nxx\r\n--bound--",
                  '--bound\r\nContent-Disposition: form-data; name="imäge"\r\n\r\nd\r\n--bound--'
                  .encode()]
        for body in bodies:
            for ct in ("", "multipart/form-data", "multipart/form-data; boundary=",
                       "multipart/form-data; boundary=bound", "text/plain; charset=utf-8"):
                yield body, ct
    elif group == "fuzz":
        rng = np.random.default_rng(7)
        for _ in range(60):
            payload = bytes(rng.integers(0, 256, int(rng.integers(0, 2000)), dtype=np.uint8))
            body = _part("FZ", "image", payload)
            if rng.random() < 0.3:  # cut or corrupt the framing somewhere
                cut = int(rng.integers(0, len(body)))
                body = body[:cut] + bytes(rng.integers(0, 256, 8, dtype=np.uint8))
            yield body, "multipart/form-data; boundary=FZ"


@pytest.mark.parametrize("group", ["roundtrip", "binary_tails", "quoted", "preamble",
                                   "junk", "fuzz"])
def test_parse_multipart_equals_jax(group):
    n = 0
    for body, ct in _multipart_cases(group):
        assert http_server.parse_multipart(body, ct) == jax_http.parse_multipart(body, ct)
        n += 1
    assert n >= 1


def _stats_cases():
    yield {"requests_served": 7, "latency_ms_p50": 12.5, "latency_ms_p95": None,
           "latency_ms_p99": 40.0, "mean_batch_fill": 6.0, "max_batch_size": 8,
           "host_decode_ms_p50": 3.0, "host_engine_ms_p50": None, "host_encode_ms_p50": 1.5,
           "queue_depth": 4, "note": "ignored"}, None
    yield {"requests_served": 1, "host_decode_ms_p50": 2.0}, "321"
    yield {"requests_served": 0, "latency_ms_p50": None, "mean_batch_fill": None}, None
    rng = np.random.default_rng(3)
    keys = ["requests_served", "latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
            "mean_batch_fill", "max_batch_size", "queue_depth", "inflight_batches",
            "batches_dispatched", "host_decode_ms_p50", "host_engine_ms_p50",
            "host_encode_ms_p50", "model_path", "compute_dtype"]
    for i in range(30):
        stats = {}
        for k in keys:
            r = rng.random()
            if r < 0.2:
                continue
            stats[k] = (None if r < 0.35 else str(r) if k in ("model_path", "compute_dtype")
                        else int(rng.integers(0, 1000)) if r < 0.6 else float(rng.random() * 100))
        yield stats, (str(i) if i % 2 else None)


def test_prometheus_text_equals_jax():
    assert metrics.PROMETHEUS_CONTENT_TYPE == jax_metrics.PROMETHEUS_CONTENT_TYPE
    for stats, worker in _stats_cases():
        assert (metrics.prometheus_text(dict(stats), worker=worker)
                == jax_metrics.prometheus_text(dict(stats), worker=worker))


@pytest.mark.parametrize("allow_reload", [False, True])
@pytest.mark.parametrize("tile_enabled", [False, True])
def test_openapi_spec_and_docs_equal_jax(allow_reload, tile_enabled):
    spec = openapi.openapi_spec(allow_reload=allow_reload, tile_enabled=tile_enabled)
    want = jax_openapi.openapi_spec(allow_reload=allow_reload, tile_enabled=tile_enabled)
    assert spec == want
    assert openapi.docs_html(spec) == jax_openapi.docs_html(want)


# ----------------------------------------------- two servers side by side


STUB_STATS = {"requests_served": 11, "latency_ms_p50": 2.5, "latency_ms_p95": 4.0,
              "latency_ms_p99": None, "mean_batch_fill": 3.0, "max_batch_size": 4,
              "queue_depth": 0, "inflight_batches": 0}


class _StubEngine:
    """One deterministic numpy engine for both servers: ``submit`` returns
    a finished future of 255 - x."""

    def submit(self, img_u8):
        fut = Future()
        fut.set_result((255 - np.asarray(img_u8)).astype(np.uint8))
        return fut

    def stats(self):
        return dict(STUB_STATS)

    def stop(self):
        pass


class _StubTiler:
    def __call__(self, img_u8):
        return (255 - img_u8).astype(np.uint8)

    def num_tiles(self, h, w):
        return 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    hdrs = {k.lower(): v for k, v in resp.getheaders()}
    conn.close()
    return resp.status, hdrs, data


def _wait_ready(port, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if _http(port, "GET", "/ping")[0] == 200:
                return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"server on port {port} never became ready")


def _serve(server):
    threading.Thread(target=server.run, daemon=True).start()
    _wait_ready(server.port)
    return server.port


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(package, with_tiler) -> port: the JAX and the port's DeglareServer,
    without a tiler (the JAX tests' live_server) and with a stub tiler in
    mode "resize" (create_server's "both"), all sharing one stub engine."""
    engine, tiler = _StubEngine(), _StubTiler()
    logdir = str(tmp_path_factory.mktemp("apilogs"))
    ports = {}
    for name, cls in (("jax", jax_http.DeglareServer), ("port", http_server.DeglareServer)):
        for with_tiler in (False, True):
            server = cls(engine, host="127.0.0.1", port=_free_port(), image_size=SIZE,
                         tiler=tiler if with_tiler else None, log_dir=logdir)
            ports[(name, with_tiler)] = _serve(server)
    return ports


def _raw(port, data: bytes, *, half_close: bool = True, timeout: float = 30.0) -> bytes:
    """Send raw bytes on a fresh connection, half-close it, read to EOF."""
    out = b""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        try:
            s.sendall(data)
            if half_close:
                s.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        while True:
            try:
                chunk = s.recv(65536)
            except OSError:
                break
            if not chunk:
                break
            out += chunk
            if not half_close and b"\r\n\r\n" in out:
                break
    return out


def _responses(raw: bytes, heads=()) -> list[tuple[int, dict, bytes]]:
    """Split a byte stream into (status, headers, body) responses by
    Content-Length; the i-th response carries no body when i is in
    ``heads`` (an answer to HEAD)."""
    out = []
    while raw:
        head, _, raw = raw.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        status = int(lines[0].split(b" ", 2)[1])
        hdrs = {}
        for line in lines[1:]:
            k, _, v = line.decode().partition(":")
            hdrs[k.strip().lower()] = v.strip()
        n = 0 if len(out) in heads else int(hdrs.get("content-length", 0))
        out.append((status, hdrs, raw[:n]))
        raw = raw[n:]
    return out


def _pixels(body: bytes) -> np.ndarray:
    """The /infer answer's PNG, read by PIL: it must be mode L."""
    with Image.open(io.BytesIO(base64.b64decode(json.loads(body)["image"]))) as im:
        assert im.mode == "L"
        return np.asarray(im)


def _upload(payload: bytes, boundary: str = "testboundary123", name: str = "test.png"):
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="image"; filename="{name}"\r\n'
        "Content-Type: image/png\r\n\r\n"
    ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _upload_png(img_u8: np.ndarray):
    return _upload(_pil_png(Image.fromarray(img_u8)))


def _cmyk_jpeg() -> bytes:
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    Image.fromarray((rng.random((SIZE, SIZE)) * 255).astype(np.uint8)).convert(
        "CMYK").save(buf, format="JPEG")
    return buf.getvalue()


def _infer_uploads():
    rng = np.random.default_rng(42)
    yield "gray_non_square", _upload_png((rng.random((40, 52)) * 255).astype(np.uint8))
    yield "rgb", _upload_png((rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8))
    yield "rgba_non_square", _upload_png(rng.integers(0, 256, (90, 200, 4), dtype=np.uint8))
    for mode in ("LA", "P", "1", "I;16"):
        yield f"mode_{mode}", _upload(_pil_png(_upload_mode_image(mode, 1)), "modeb", "t.png")
    for name in PNG_FIXTURES:
        yield name, _upload(_fixture(name), "fixtureb", name)


INFER_IDS = [case for case, _ in _infer_uploads()]


@pytest.mark.parametrize("case", INFER_IDS)
def test_infer_same_pixels_from_both_servers(servers, case):
    body, headers = dict(_infer_uploads())[case]
    got = {}
    for name in ("jax", "port"):
        status, hdrs, data = _http(servers[(name, False)], "POST", "/infer", body, headers)
        assert status == 200, (name, data[:200])
        assert hdrs["content-type"] == "application/json"
        got[name] = _pixels(data)
    assert got["port"].shape == got["jax"].shape
    np.testing.assert_array_equal(got["port"], got["jax"])


@pytest.mark.parametrize("path", ["/infer?mode=tile", "/infer?mode=resize", "/infer?mode=bogus"])
def test_infer_mode_override_same_answers(servers, path):
    rng = np.random.default_rng(9)
    body, headers = _upload_png((rng.random((SIZE * 2, SIZE + 24)) * 255).astype(np.uint8))
    for with_tiler in (False, True):
        got = {name: _http(servers[(name, with_tiler)], "POST", path, body, headers)
               for name in ("jax", "port")}
        assert got["port"][0] == got["jax"][0]
        if got["jax"][0] == 200:
            np.testing.assert_array_equal(_pixels(got["port"][2]), _pixels(got["jax"][2]))
        else:
            assert got["port"][2] == got["jax"][2]


@pytest.mark.parametrize("upload", ["cmyk_jpeg", "photo_noise.jpg"])
def test_jpeg_upload_answers_500_naming_the_decoder(servers, upload):
    """The JAX serve tests' two JPEG uploads (tests/test_serve.py:489,
    :508): the port answers 200 with the JAX server's pixels, resize and
    tile modes, since it decodes JPEG as PIL does (the 500 this test once
    held is gone)."""
    payload = _cmyk_jpeg() if upload == "cmyk_jpeg" else _fixture(upload)
    body, headers = _upload(payload, "modeb", "t.jpg")
    for with_tiler, path in ((False, "/infer"), (True, "/infer?mode=tile")):
        got = {}
        for name in ("jax", "port"):
            status, _, data = _http(servers[(name, with_tiler)], "POST", path, body, headers)
            assert status == 200, (name, data[:200])
            got[name] = _pixels(data)
        assert got["port"].shape == got["jax"].shape
        np.testing.assert_array_equal(got["port"], got["jax"])


def test_bad_image_500_from_both(servers):
    body = (b'--b\r\nContent-Disposition: form-data; name="image"\r\n\r\n'
            b"not-a-png\r\n--b--\r\n")
    headers = {"Content-Type": "multipart/form-data; boundary=b"}
    for name in ("jax", "port"):
        status, _, data = _http(servers[(name, False)], "POST", "/infer", body, headers)
        assert status == 500 and set(json.loads(data)) == {"detail"}


def _chunked(body: bytes, sizes) -> bytes:
    out, pos, i = [], 0, 0
    while pos < len(body):
        n = min(sizes[i % len(sizes)], len(body) - pos)
        i += 1
        out.append(f"{n:x}\r\n".encode() + body[pos:pos + n] + b"\r\n")
        pos += n
    out.append(b"0\r\n\r\n")
    return b"".join(out)


def _raw_cases():
    """name -> (request bytes, indices of HEAD answers, half_close). The
    JAX live-server tests' requests, as bytes on one connection each."""
    big = jax_http.DeglareServer.MAX_BODY_BYTES + 1
    flood = b"".join(b"x-h%d: y\r\n" % i for i in range(jax_http.DeglareServer.MAX_HEADER_LINES + 8))
    trailers = b"x-junk: y\r\n" * (jax_http.DeglareServer.MAX_TRAILER_LINES + 8)
    rng = np.random.default_rng(11)
    return {
        "ping": (b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n", (), True),
        "ping_http10": (b"GET /ping HTTP/1.0\r\n\r\n", (), True),
        "unknown_route_404": (b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n", (), True),
        "get_infer_405": (b"GET /infer HTTP/1.1\r\nHost: x\r\n\r\n", (), True),
        "post_ping_405": (b"POST /ping HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n", (), True),
        "head_infer_405": (b"HEAD /infer HTTP/1.1\r\nHost: x\r\n\r\n", (0,), True),
        "head_ping": (b"HEAD /ping HTTP/1.1\r\nHost: x\r\n\r\n", (0,), True),
        "head_docs": (b"HEAD /docs HTTP/1.1\r\nHost: x\r\n\r\n", (0,), True),
        "head_oversized_413": (b"HEAD /ping HTTP/1.1\r\nHost: x\r\nContent-Length: "
                               + str(10**12).encode() + b"\r\n\r\n", (0,), True),
        "reload_disabled_404": (b"POST /reload HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n\r\n{}",
                                (), True),
        "missing_image_400": (b"POST /infer HTTP/1.1\r\nHost: x\r\nContent-Type: multipart/"
                              b"form-data; boundary=emptyb\r\nContent-Length: 12\r\n\r\n"
                              b"--emptyb--\r\n", (), True),
        "bad_content_length_400": (b"POST /infer HTTP/1.1\r\nHost: x\r\n"
                                   b"Content-Length: banana\r\n\r\n", (), True),
        "negative_content_length_400": (b"POST /infer HTTP/1.1\r\nHost: x\r\n"
                                        b"Content-Length: -5\r\n\r\n", (), True),
        "oversized_body_413": (b"POST /infer HTTP/1.1\r\nHost: x\r\nContent-Type: multipart/"
                               b"form-data; boundary=b\r\nContent-Length: "
                               + str(100 * 1024 * 1024).encode() + b"\r\n\r\n", (), True),
        "chunked_bad_framing_400": (b"POST /infer HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: "
                                    b"chunked\r\n\r\nzzz\r\nnot hex\r\n", (), True),
        "chunked_unterminated_data_400": (b"POST /infer HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: "
                                          b"chunked\r\n\r\n3\r\nabcXY", (), True),
        "chunked_oversized_413": (b"POST /infer HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: "
                                  b"chunked\r\n\r\n" + f"{big:x}\r\n".encode(), (), True),
        "chunked_trailer_flood_400": (b"POST /infer HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: "
                                      b"chunked\r\n\r\n1\r\nA\r\n0\r\n" + trailers, (), True),
        "header_flood_400": (b"GET /ping HTTP/1.1\r\nHost: x\r\n" + flood, (), True),
        "transfer_encoding_gzip_501": (b"POST /infer HTTP/1.1\r\nHost: x\r\n"
                                       b"Transfer-Encoding: gzip\r\n\r\n", (), True),
        "request_line_414": (b"GET /infer?pad=" + b"x" * (70 * 1024) + b" HTTP/1.1\r\n"
                             b"Host: t\r\n\r\n", (), False),
        "header_line_431": (b"GET /ping HTTP/1.1\r\nHost: t\r\nX-Pad: " + b"y" * (70 * 1024)
                            + b"\r\n\r\n", (), False),
        "keepalive_then_close": (b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n" * 3
                                 + b"GET /openapi.json HTTP/1.1\r\nHost: x\r\n\r\n"
                                 + b"GET /ping HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
                                 + b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n", (), True),
        "garbage_binary": (b"\x00\xff\xfe\x01garbage\r\n\r\n", (), True),
        "garbage_short_line": (b"GET\r\n\r\n", (), True),
        "garbage_body_cut": (b"POST /infer HTTP/1.1\r\nContent-Length: 10\r\n\r\nshort", (), True),
        "garbage_header_without_colon": (b"GET /ping HTTP/1.1\r\nHeaderWithoutColon\r\n\r\n",
                                         (), True),
        "garbage_random": (bytes(rng.integers(0, 256, 512, dtype=np.uint8)), (), True),
        "openapi_json": (b"GET /openapi.json HTTP/1.1\r\nHost: x\r\n\r\n", (), True),
        "docs": (b"GET /docs HTTP/1.1\r\nHost: x\r\n\r\n", (), True),
    }


@pytest.mark.parametrize("case", list(_raw_cases()))
def test_raw_request_same_bytes_from_both_servers(servers, case):
    """Same status, headers and body, byte for byte, from both servers;
    each still answers /ping afterwards."""
    data, heads, half_close = _raw_cases()[case]
    for with_tiler in (False, True):
        got = {name: _raw(servers[(name, with_tiler)], data, half_close=half_close)
               for name in ("jax", "port")}
        if half_close:
            assert got["port"] == got["jax"]
            _responses(got["port"], heads)  # well-formed
        else:  # the answer to an over-long line, then a reset: the head only
            assert got["port"].split(b"\r\n\r\n")[0] == got["jax"].split(b"\r\n\r\n")[0]
            assert got["jax"].startswith(b"HTTP/1.1 4")
    for name in ("jax", "port"):
        assert _http(servers[(name, False)], "GET", "/ping")[2] == b'{"message":"pong"}'


def test_chunked_infer_keeps_the_stream_in_sync_on_both(servers):
    """A chunked /infer upload with a chunk extension and a trailer, then a
    /ping on the same connection; and random chunkings of one body."""
    rng = np.random.default_rng(42)
    body, headers = _upload_png((rng.random((SIZE, SIZE)) * 255).astype(np.uint8))
    chunked = _chunked(body, [1, 7, 100, 4096]).replace(b"1\r\n", b"1;ext=val\r\n", 1)
    chunked = chunked[:-2] + b"X-Trailer: ignored\r\n\r\n"
    request = (b"POST /infer HTTP/1.1\r\nHost: x\r\n"
               + f"Content-Type: {headers['Content-Type']}\r\n".encode()
               + b"Transfer-Encoding: chunked\r\n\r\n" + chunked
               + b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n")
    answers = {}
    for name in ("jax", "port"):
        (s1, _, b1), (s2, _, b2) = _responses(_raw(servers[(name, False)], request))
        assert s1 == 200 and s2 == 200 and b2 == b'{"message":"pong"}'
        answers[name] = _pixels(b1)
        for _ in range(3):
            sizes = [int(x) for x in rng.integers(1, 9000, size=6)]
            (s, _, b), = _responses(_raw(servers[(name, False)],
                                         b"POST /infer HTTP/1.1\r\nHost: x\r\n"
                                         + f"Content-Type: {headers['Content-Type']}\r\n".encode()
                                         + b"Transfer-Encoding: chunked\r\n\r\n"
                                         + _chunked(body, sizes)))
            assert s == 200
            np.testing.assert_array_equal(_pixels(b), answers[name])
    np.testing.assert_array_equal(answers["port"], answers["jax"])


def test_keepalive_infer_and_concurrent_requests_on_both(servers):
    rng = np.random.default_rng(3)
    imgs = [(rng.random((SIZE, SIZE)) * 255).astype(np.uint8) for _ in range(6)]
    for name in ("jax", "port"):
        port = servers[(name, False)]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        for _ in range(2):
            conn.request("GET", "/ping")
            resp = conn.getresponse()
            assert resp.read() == b'{"message":"pong"}'
            assert resp.getheader("Connection") == "keep-alive"
        body, headers = _upload_png(imgs[0])
        conn.request("POST", "/infer", body=body, headers=headers)
        resp = conn.getresponse()
        np.testing.assert_array_equal(_pixels(resp.read()), 255 - imgs[0])
        conn.close()
        with ThreadPoolExecutor(6) as pool:
            results = list(pool.map(lambda im: _http(port, "POST", "/infer", *_upload_png(im)),
                                    imgs))
        for im, (status, _, data) in zip(imgs, results):
            assert status == 200
            np.testing.assert_array_equal(_pixels(data), 255 - im)


def test_stats_and_metrics_same_numbers_from_both(servers):
    body, headers = _upload_png(np.full((SIZE, SIZE), 100, np.uint8))
    stats, text = {}, {}
    for name in ("jax", "port"):
        port = servers[(name, False)]
        assert _http(port, "POST", "/infer", body, headers)[0] == 200
        status, _, data = _http(port, "GET", "/stats")
        assert status == 200
        stats[name] = json.loads(data)
        status, hdrs, data = _http(port, "GET", "/metrics")
        assert status == 200 and hdrs["content-type"] == metrics.PROMETHEUS_CONTENT_TYPE
        text[name] = data.decode()
        status, hdrs, data = _http(port, "HEAD", "/metrics")
        assert status == 200 and data == b"" and int(hdrs["content-length"]) > 0
    assert stats["port"].keys() == stats["jax"].keys()
    for k, v in stats["jax"].items():
        if k.startswith("host_"):
            assert v is not None and stats["port"][k] is not None and stats["port"][k] >= 0
        else:
            assert stats["port"][k] == v, k

    def series(t):  # the host phases carry this run's timings
        return [line.rsplit(" ", 1)[0] if "host_phase" in line else line
                for line in t.splitlines()]

    assert series(text["port"]) == series(text["jax"])


def test_cli_test_api_and_load_tool_against_the_port_server(servers, tmp_path, capsys):
    url = f"http://127.0.0.1:{servers[('port', False)]}"
    assert test_api_cli.main(["--test", "stats", "--url", url]) == 0
    assert test_api_cli.main(["--test", "ping", "--url", url]) == 0
    path = os.path.join(FIXTURES, "photo_noise.png")
    assert test_api_cli.test_infer(url, path, out_dir=str(tmp_path))
    with Image.open(tmp_path / "enhanced_photo_noise.png") as im:
        assert im.mode == "L" and im.size == (160, 160)
    # a JPEG upload's answer is saved as the JPEG the JAX CLI's PIL writes
    path = os.path.join(FIXTURES, "photo_noise.jpg")
    assert test_api_cli.test_infer(url, path, out_dir=str(tmp_path / "port"))
    assert jax_test_api_cli.test_infer(url, path, out_dir=str(tmp_path / "jax"))
    got = (tmp_path / "port" / "enhanced_photo_noise.jpg").read_bytes()
    assert got == (tmp_path / "jax" / "enhanced_photo_noise.jpg").read_bytes()
    assert got[:2] == b"\xff\xd8"
    # an extension neither PNG nor JPEG is refused, naming the two
    odd = tmp_path / "photo_noise.bmp"
    odd.write_bytes(b"unused")
    capsys.readouterr()
    assert test_api_cli.main(["--test", "infer", "--url", url, "--image", str(odd)]) == 1
    assert "PNG" in capsys.readouterr().out
    assert test_api_cli.main(["--test", "ping", "--url", "http://127.0.0.1:9"]) == 1
    capsys.readouterr()
    assert load_test_api.main(["--url", url, "--size", "64", "--requests", "6",
                               "--concurrency", "3"]) == 0
    closed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert closed["mode"] == "closed" and closed["requests_ok"] == 6 and closed["errors"] == 0
    assert load_test_api.main(["--url", url, "--size", "64", "--rate", "40",
                               "--duration", "0.25", "--connections", "4"]) == 0
    opened = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert opened["mode"] == "open" and opened["requests_ok"] == 10
    assert opened["latency_ms_p50"] <= opened["latency_ms_p95"] <= opened["latency_ms_p99"]
    assert load_test_api.main(["--selftest", "--size", "64", "--requests", "4",
                               "--concurrency", "2"]) == 0
    selftest = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert selftest["requests_ok"] == 4 and selftest["errors"] == 0


# ------------------------------------------ create_server, both packages


def test_create_server_on_best_model_both_packages(tmp_path):
    """f32, 32x32, the production weights: one resized request to each
    package's create_server; the same model_info; ?mode=tile on the
    port's (mode "both")."""
    logs = str(tmp_path / "logs")
    jax_server = jax_http.create_server(ONNX, host="127.0.0.1", port=_free_port(),
                                        mode="resize", image_size=CREATE_SIZE, warmup=False,
                                        compute_dtype=jnp.float32, log_dir=logs)
    server = http_server.create_server(ONNX, host="127.0.0.1", port=_free_port(),
                                       mode="both", image_size=CREATE_SIZE, warmup=False,
                                       tile_overlap=8, compute_dtype=torch.float32,
                                       log_dir=logs, device="cpu")
    try:
        assert server.model_info == jax_server.model_info == {
            "model_path": ONNX, "model": "lightweight", "quantize": "none",
            "compute_dtype": "float32"}
        assert server.tiler is not None and server.tiler.model is server.engine._model
        rng = np.random.default_rng(1)
        body, headers = _upload_png(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8))
        got = {}
        for name, srv in (("jax", jax_server), ("port", server)):
            status, _, data = _http(_serve(srv), "POST", "/infer", body, headers)
            assert status == 200, data[:200]
            got[name] = _pixels(data).astype(np.int16)
        diff = np.abs(got["port"] - got["jax"])
        print(f"create_server f32 32x32: max |port - jax| {diff.max()} levels, "
              f"{int((diff > 0).sum())} of {diff.size} pixels differ")
        assert got["port"].shape == (40, 52) and diff.max() <= F32_LEVELS
        status, _, data = _http(server.port, "POST", "/infer?mode=tile", body, headers)
        assert status == 200 and _pixels(data).shape == (40, 52)
    finally:
        jax_server.engine.stop()
        server.engine.stop()


def test_create_server_refuses_unported_options_and_needs_a_card():
    # a mesh owns the devices (serving over several is
    # tests/test_torch_port_serve_mesh.py): another device beside it raises
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        http_server.create_server(ONNX, warmup=False, device="cuda",
                                  mesh=make_local_mesh(2, device="cpu"))
    # quantize="int8" is served now (ROADMAP Queue 1 item 10)
    server = http_server.create_server(ONNX, warmup=False, device="cpu", quantize="int8")
    assert server.model_info["quantize"] == "int8" and server.engine.quantize == "int8"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            http_server.create_server(ONNX, warmup=False)


# -------------------------------------------------------- TiledInference


@pytest.fixture(scope="module")
def narrow_params():
    model = JaxUNet(features_start=4, num_groups=2)
    return jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 1)))["params"]


def _port_model(params, width=4, groups=2):
    model = LightweightUNet(features_start=width, num_groups=groups, dtype=torch.float32,
                            kernels=True, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return model


def test_tiler_equals_jax_with_padding_and_overlap(narrow_params):
    """tile 16, overlap 4 on a 12x37 image: padded to 16 rows, 3 tiles
    along x, one bucket of 4."""
    img = np.random.default_rng(4).integers(0, 256, (12, 37), dtype=np.uint8)
    jt = JaxTiler(JaxUNet(features_start=4, num_groups=2).apply, narrow_params, tile=16,
                  overlap=4, compute_dtype=jnp.float32, max_tiles_per_batch=4)
    pt = TiledInference(_port_model(narrow_params), tile=16, overlap=4,
                        compute_dtype=torch.float32, max_tiles_per_batch=4, device="cpu")
    modes = []
    pt.model.register_forward_hook(lambda *_: modes.append(torch.is_inference_mode_enabled()))
    want, got = jt(img), pt(img)
    diff = np.abs(got.astype(np.int16) - want)
    print(f"tiler: max |port - jax| {diff.max()} levels at {int((diff > 0).sum())} pixels")
    assert got.shape == img.shape and got.dtype == np.uint8 and diff.max() <= F32_LEVELS
    assert modes == [True]  # one forward, in inference mode (the card's kernels need it)
    assert pt.compiled_bucket_count == jt.compiled_bucket_count == 1
    for h, w in ((12, 37), (16, 16), (1, 1), (100, 17), (33, 64), (512, 700)):
        assert pt.num_tiles(h, w) == jt.num_tiles(h, w), (h, w)


def test_tiler_buckets_reload_and_refusals(narrow_params):
    pt = TiledInference(_port_model(narrow_params), tile=16, overlap=4,
                        compute_dtype=torch.float32, max_tiles_per_batch=4, device="cpu")
    img = np.random.default_rng(5).integers(0, 256, (40, 30), dtype=np.uint8)
    first = pt(img)  # 3 x 3 tiles: chunks of 4, 4, 1
    assert pt.compiled_bucket_count == 2 and pt._buckets_seen == {1, 4}
    bumped = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, narrow_params)
    old = pt.model
    pt.reload_params(bumped)
    assert pt.model is not old
    fresh = TiledInference(_port_model(bumped), tile=16, overlap=4,
                           compute_dtype=torch.float32, max_tiles_per_batch=4, device="cpu")
    np.testing.assert_array_equal(pt(img), fresh(img))
    assert not np.array_equal(pt(img), first)
    with pytest.raises(ValueError, match="overlap"):
        TiledInference(_port_model(narrow_params), tile=16, overlap=16, device="cpu")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        TiledInference(_port_model(narrow_params), tile=16, overlap=4, device="cuda",
                       mesh=make_local_mesh(2, device="cpu"))


# ----------------------------------------------------------------- loading


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The production weights as .onnx, as a flat .npz (the JAX names), the
    same nested under params/, and as the port's checkpoint directory."""
    root = tmp_path_factory.mktemp("artifacts")
    _, params = jax_load_model_for_eval(ONNX)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, params)).items()}
    np.savez(root / "weights.npz", **flat)
    np.savez(root / "nested.npz", **{f"params/{k}": v for k, v in flat.items()})
    np.savez(root / "optimized.npz", **flat, **{"attention4/fc1": np.zeros(2, np.float32)})
    save_checkpoint(str(root / "ckpt"), params=jax.tree_util.tree_map(np.asarray, params))
    return {"onnx": ONNX, "npz": str(root / "weights.npz"), "nested": str(root / "nested.npz"),
            "optimized": str(root / "optimized.npz"), "ckpt": str(root / "ckpt")}, params


@pytest.mark.parametrize("kind", ["onnx", "npz", "nested", "optimized", "ckpt"])
def test_detect_model_arch_equals_jax(artifacts, kind):
    paths, _ = artifacts
    assert detect_model_arch(paths[kind]) == jax_detect_model_arch(paths[kind])


@pytest.mark.parametrize("kind", ["onnx", "npz", "nested", "ckpt"])
def test_load_model_for_eval_params_equal_jax(artifacts, kind):
    paths, want = artifacts
    model, params = load_model_for_eval(paths[kind], device="cpu")
    got, ref = flatten_tree(params), flatten_tree(jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)
    assert model.kernels is True
    assert not model.training and next(model.parameters()).device.type == "cpu"
    assert sum(p.numel() for p in model.parameters()) == 486409


def test_load_model_for_eval_refusals(artifacts, tmp_path):
    paths, _ = artifacts
    # an empty .pth fails in torch.load, as in the JAX package
    pth = tmp_path / "model.pth"
    pth.write_bytes(b"")
    with pytest.raises(Exception) as want:
        jax_detect_model_arch(str(pth))
    with pytest.raises(want.type):
        detect_model_arch(str(pth))
    with pytest.raises(want.type):
        load_model_for_eval(str(pth), model_arch="lightweight", device="cpu")
    # a LightweightUNet tree with an SE gate's leaf: detected as
    # OptimizedUNet, whose tree it is not
    with pytest.raises(ValueError, match="does not match the model"):
        load_model_for_eval(paths["optimized"], device="cpu")
    with pytest.raises(FileNotFoundError):
        detect_model_arch(str(tmp_path / "missing.onnx"))
    other = tmp_path / "model.bin"
    other.write_bytes(b"")
    with pytest.raises(ValueError, match="autodetect"):
        detect_model_arch(str(other))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_model_for_eval(ONNX)


def test_decode_inference_image_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    for shape in ((40, 52), (30, 20, 3), (64, 64, 4), (32, 32)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        path = tmp_path / f"img{len(shape)}_{shape[0]}.png"
        path.write_bytes(_pil_png(Image.fromarray(a)))
        paths = [path]
        if shape[-1] != 4:  # and as a JPEG (RGBA has no JPEG form)
            paths.append(tmp_path / f"img{len(shape)}_{shape[0]}.jpg")
            Image.fromarray(a).save(paths[-1], quality=80)
        for size, path in ((s, p) for s in (32, 17) for p in paths):
            want = jax_pipeline.decode_inference_image(str(path), size, use_native=False)
            np.testing.assert_array_equal(decode_inference_image(str(path), size), want)
            if path.suffix == ".png":
                np.testing.assert_array_equal(decode_inference_image(a, size), want)
    f = rng.random((20, 20)).astype(np.float32)
    np.testing.assert_array_equal(decode_inference_image(f, 16),
                                  jax_pipeline.decode_inference_image(f, 16, use_native=False))
    with pytest.raises(ValueError, match="normalized"):
        decode_inference_image(f * 255, 16)
    # the native route: the JAX package's C++ library's numbers
    np.testing.assert_array_equal(decode_inference_image(f, 16, use_native=True),
                                  jax_pipeline.decode_inference_image(f, 16, use_native=True))


# -------------------------------------------------------------------- CLIs


def test_cli_parsers_defaults_equal_jax():
    port = vars(serve_cli.parse_args([]))
    assert port.pop("device") == "cuda"
    assert port == vars(jax_serve_cli.parse_args([]))
    port = vars(enhance_cli.parse_args(["--input", "x"]))
    assert port.pop("device") == "cuda"
    assert port == vars(jax_enhance_cli.parse_args(["--input", "x"]))


@pytest.mark.parametrize("flags,item", [
    (["--workers", "2", "--mode", "tile"], "requires --mode resize"),
])
def test_cli_serve_refuses_unported_flags(flags, item):
    """What the JAX CLI refuses, before the model loads (``--data_parallel``
    is served now: tests/test_torch_port_serve_mesh.py)."""
    with pytest.raises(SystemExit, match=item):
        serve_cli.main(["--model_path", ONNX, "--device", "cpu"] + flags)


def test_cli_serve_profile_port_captures_the_serving_process(monkeypatch, tmp_path, capsys):
    """``--profile_port`` starts the capture endpoint before the model
    loads (it raised naming ROADMAP Queue 1 item 15 before the port had
    it): a capture taken while the engine's thread serves requests
    answers, and the process lives through its start and stop. It holds
    the capturing thread's host ops only, so none of the engine's (its
    device kernels are in a capture on a card: ``chip_smoke.py`` 15b)."""
    import urllib.request

    from image_enhancement_deglaring_tpu_torch.utils import profiling

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(profiling.tempfile, "tempdir", None)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    answers, served = [], []

    def run(self):
        self.engine.start()
        frame = np.zeros((32, 32), np.uint8)
        with ThreadPoolExecutor(1) as pool:
            pending = pool.submit(lambda: urllib.request.urlopen(
                f"http://127.0.0.1:{port}/trace?ms=500", timeout=60).read())
            while not pending.done():  # requests all through the capture
                served.append(self.engine.submit(frame).result(timeout=60))
            answers.append(json.loads(pending.result()))

    monkeypatch.setattr(http_server.DeglareServer, "run", run)
    serve_cli.main(["--model_path", ONNX, "--device", "cpu", "--profile_port", str(port),
                    "--image_size", "32", "--max_batch_size", "2", "--compute_dtype", "float32"])
    assert f"http://127.0.0.1:{port}/trace?ms=N" in capsys.readouterr().out
    (answer,) = answers
    assert answer["ms"] == 500 and answer["trace"].startswith(str(tmp_path))
    with open(answer["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert len(served) > 1 and all(out.shape == (32, 32) for out in served)
    assert not [e for e in events if e.get("name") == "aten::conv2d"]  # the engine's thread


def test_cli_serve_quantize_int8_serves(monkeypatch):
    """``--quantize int8`` reaches the engine (it raised naming ROADMAP
    Queue 1 item 10 before the port had it)."""
    served = []
    monkeypatch.setattr(http_server.DeglareServer, "run", lambda self: served.append(self))
    serve_cli.main(["--model_path", ONNX, "--device", "cpu", "--quantize", "int8",
                    "--image_size", "32", "--max_batch_size", "2",
                    "--compute_dtype", "float32"])
    (server,) = served
    assert server.model_info["quantize"] == "int8" and server.engine._int8 is not None
    assert server.engine._worker is None  # main() stopped the engine


@pytest.mark.parametrize("flags,item", [(["--data_parallel", "2"], "Input path not found")])
def test_cli_enhance_refuses_unported_flags(flags, item, tmp_path):
    """``--data_parallel`` is taken now (tests/test_torch_port_serve_mesh.py):
    over two CPU replicas a missing input still exits as the JAX CLI does."""
    with pytest.raises(SystemExit, match=item):
        enhance_cli.main(["--input", str(tmp_path / "missing"), "--model_path", ONNX,
                          "--device", "cpu"] + flags)


def test_cli_serve_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--model_path", ONNX])


def test_cli_enhance_equals_jax_output_files(tmp_path):
    """A directory of gray 32x32 PNGs and a gray 32x32 JPEG through both
    CLIs (f32, batch 1): the same file names, PNGs whose pixels are within
    one level; then the port's tile mode on one of them. (At the model's
    size and in gray, the JAX CLI's native preprocessing is the identity,
    as the port's is.)"""
    inp = tmp_path / "in"
    inp.mkdir()
    rng = np.random.default_rng(8)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (CREATE_SIZE, CREATE_SIZE), dtype=np.uint8)).save(
            inp / f"scan{i}.png")
    Image.fromarray(rng.integers(0, 256, (CREATE_SIZE, CREATE_SIZE), dtype=np.uint8)).save(
        inp / "photo.jpg", quality=85)
    common = ["--input", str(inp), "--model_path", ONNX, "--image_size", str(CREATE_SIZE)]
    jax_enhance_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    enhance_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for n in names:
        with Image.open(tmp_path / "jax" / n) as a, Image.open(tmp_path / "port" / n) as b:
            assert a.mode == b.mode == "L"
            diff = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
        assert diff.max() <= F32_LEVELS, n
    tile_out = tmp_path / "port_tile"
    enhance_cli.main(["--input", str(inp / "scan0.png"), "--model_path", ONNX, "--mode", "tile",
                      "--image_size", "16", "--tile_overlap", "4", "--output_dir", str(tile_out),
                      "--device", "cpu"])
    with Image.open(tile_out / "scan0.png") as im:
        assert im.size == (CREATE_SIZE, CREATE_SIZE)
