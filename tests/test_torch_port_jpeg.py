"""The port's JPEG decoder (``data/jpeg.py``) and its gray encoder
(``data/jpeg_encode.py``) against PIL, on the CPU.

PIL 12.1.0 decodes with libjpeg-turbo 3.1.3 (the jpeg62 API, fancy
upsampling, the integer IDCT). Every case holds ``decode_jpeg`` to
``np.asarray(PIL.Image.open(...))`` and ``serve.imaging.to_luma`` to
``convert("L")`` with ``np.array_equal``:

- the matrix: gray, RGB and CMYK (PIL writes CMYK with the Adobe marker);
  quality 50/75/95/100; PIL's subsampling 0/1/2 and cv2's 4:1:1, 4:4:0,
  4:2:2 and 4:2:0; baseline, progressive and optimized tables; restart
  markers from PIL's ``restart_marker_blocks``/``restart_marker_rows``
  and cv2's ``IMWRITE_JPEG_RST_INTERVAL``; sizes that are no MCU multiple
  (1x1, 7x9, 17x33, 63x65); seeded noise and smooth gradients; colour
  spaces written by hand (Adobe transform 0 and 2, "RGB" component ids,
  SOF1, 16-bit quantization tables, fill bytes); the committed fixtures;
- files cut short: the port raises if and only if PIL raises, at every
  cut in the last 16 bytes and at seeded cut points;
- the 63x65 cases and the cut files again with one MCU row per band,
  64-byte reader windows and output bands of one row group, so that every
  boundary a phone photo's decode crosses falls inside these small files;
- SOF3, SOF5, SOF9 and 12-bit headers refused by name, and frame headers
  over PIL's decompression bomb limit refused by both; floods of RST
  markers, stuffed bytes, garbage and fill bytes decoded as PIL does;
- seeded byte flips in the entropy data: no gate on equality (PIL's
  libjpeg-turbo runs SIMD code whose 16-bit arithmetic overflows on
  corrupt coefficients where ``jidctint.c`` does not); the port answers
  with pixels of PIL's shape or a ValueError;
- ``tests/fixtures/jpeg/manifest.json`` against PIL, and the port against
  the manifest (the card's machine checks the port against it too);
- ``encode_jpeg_gray`` byte for byte against ``Image.fromarray(a,
  "L").save(buf, "JPEG")`` (quality 75) on noise, flat and smooth images at
  sizes that are and are not multiples of 8, and read back by PIL.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from image_enhancement_deglaring_tpu_torch.data import jpeg
from image_enhancement_deglaring_tpu_torch.data.jpeg import decode_jpeg
from image_enhancement_deglaring_tpu_torch.data.jpeg_encode import encode_jpeg_gray
from image_enhancement_deglaring_tpu_torch.serve.imaging import to_luma

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
JPEG_FIXTURES = os.path.join(FIXTURES, "jpeg")
SIZES = [(1, 1), (7, 9), (17, 33), (63, 65)]
QUALITIES = [50, 75, 95, 100]
PIL_VARIANTS = {"baseline": {}, "progressive": {"progressive": True},
                "optimize": {"optimize": True},
                "restart_blocks": {"restart_marker_blocks": 2},
                "restart_rows": {"restart_marker_rows": 1}}
CV2_SAMPLING = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
CV2_VARIANTS = {"baseline": [], "rst1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
                "rst3": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
                "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1]}


def _pixels(kind: str, h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Seeded noise, or a smooth gradient (channels offset) that makes the
    upsampler's edge rules visible."""
    if kind == "noise":
        a = np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)
    else:
        y, x = np.mgrid[0:h, 0:w]
        a = np.stack([(x * 255 // max(w - 1, 1) + y * 3 + 37 * c) % 256
                      for c in range(channels)], -1).astype(np.uint8)
    return a[..., 0] if channels == 1 else a


def _pil_jpeg(a: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(a, "L" if mode == "L" else "RGB")
    (img.convert("CMYK") if mode == "CMYK" else img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _segments(data: bytes):
    """(marker, offset, length) of the marker segments before the first SOS."""
    pos, out = 2, []
    while True:
        marker, length = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, pos, length))
        if marker == 0xDA:
            return out
        pos += 2 + length


def _replace_segment(data: bytes, marker: int, body: bytes | None) -> bytes:
    """The first ``marker`` segment's body replaced (None drops it)."""
    for m, pos, length in _segments(data):
        if m == marker:
            seg = b"" if body is None else (
                bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body)
            return data[:pos] + seg + data[pos + 2 + length:]
    raise AssertionError(f"no marker 0x{marker:02X}")


def _insert_before(data: bytes, marker: int, seg: bytes) -> bytes:
    pos = next(p for m, p, _ in _segments(data) if m == marker)
    return data[:pos] + seg + data[pos:]


def _hand_made():
    """Colour spaces and header forms that PIL and cv2 do not write as such."""
    rgb = _pixels("noise", 17, 33, 3, 11)
    base = _pil_jpeg(rgb, "RGB", quality=90, subsampling=0)
    app14 = lambda t: b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([t])  # noqa: E731
    no_jfif = _replace_segment(base, 0xE0, None)
    # 3 components, no JFIF, Adobe transform 0: libjpeg takes them as RGB
    yield "adobe_rgb_transform0", _insert_before(no_jfif, 0xDB, app14(0))
    # ... and with transform 1, or component ids "R" "G" "B"
    yield "adobe_ycc_transform1", _insert_before(no_jfif, 0xDB, app14(1))
    segs = {m: p for m, p, _ in _segments(no_jfif)}
    b = bytearray(no_jfif)
    for i, cid in enumerate(b"RGB"):  # in the frame header and the scan header
        b[segs[0xC0] + 10 + 3 * i] = cid
        b[segs[0xDA] + 5 + 2 * i] = cid
    yield "component_ids_rgb", bytes(b)
    # 4 components, Adobe transform 2: YCCK, converted to CMYK
    cmyk = _pil_jpeg(_pixels("smooth", 17, 33, 3, 0), "CMYK", quality=90)
    b = bytearray(cmyk)
    at = cmyk.index(b"Adobe")
    b[at + 11] = 2
    yield "adobe_ycck_transform2", bytes(b)
    # SOF1 (extended sequential) for SOF0, same data
    b = bytearray(base)
    b[next(p for m, p, _ in _segments(base) if m == 0xC0) + 1] = 0xC1
    yield "sof1_extended", bytes(b)
    # DQT with 16-bit entries (Pq = 1) holding the same values
    segs = _segments(base)
    out = base
    for m, pos, length in reversed(segs):
        if m == 0xDB:
            body, new, i = base[pos + 4:pos + 2 + length], b"", 0
            while i < len(body):
                new += bytes([0x10 | (body[i] & 15)]) + np.frombuffer(
                    body[i + 1:i + 65], np.uint8).astype(">u2").tobytes()
                i += 65
            out = out[:pos] + b"\xff\xdb" + (len(new) + 2).to_bytes(2, "big") + new \
                + out[pos + 2 + length:]
    yield "dqt_16bit", out
    # fill bytes before markers, a comment and an APP segment
    extra = _insert_before(base, 0xDB, b"\xff\xfe\x00\x05hi!" + b"\xff\xe5\x00\x04ab")
    yield "fill_bytes_com_app", _insert_before(extra, 0xC4, b"\xff\xff\xff")


def _matrix():
    """(id, JPEG bytes) of the matrix; the quality and subsampling turn
    over with the case number, so each meets every size, kind and mode."""
    i = 0
    for mode, channels in (("L", 1), ("RGB", 3), ("CMYK", 4)):
        for (h, w) in SIZES:
            for kind in ("noise", "smooth"):
                a = _pixels(kind, h, w, min(channels, 3), seed=i)
                for variant, kw in PIL_VARIANTS.items():
                    q = QUALITIES[i % 4]
                    kw = dict(kw, quality=q)
                    if mode != "L":
                        kw["subsampling"] = i % 3
                    sub = f"-s{kw['subsampling']}" if mode != "L" else ""
                    yield f"pil-{mode}-{h}x{w}-{kind}-q{q}{sub}-{variant}", _pil_jpeg(a, mode, **kw)
                    i += 1
    for sampling, flag in CV2_SAMPLING.items():
        for (h, w) in SIZES:
            for kind in ("noise", "smooth"):
                variant = list(CV2_VARIANTS)[i % len(CV2_VARIANTS)]
                q = QUALITIES[i % 4]
                a = _pixels(kind, h, w, 3, seed=i)
                params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag]
                yield (f"cv2-{sampling}-{h}x{w}-{kind}-q{q}-{variant}",
                       cv2.imencode(".jpg", a, params + CV2_VARIANTS[variant])[1].tobytes())
                i += 1
    g = _pixels("noise", 63, 65, 1, seed=i)
    yield "cv2-gray-rst1", cv2.imencode(".jpg", g, [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])[1].tobytes()
    yield from _hand_made()
    with open(os.path.join(FIXTURES, "photo_noise.jpg"), "rb") as f:
        yield "fixture-photo_noise", f.read()


MATRIX = dict(_matrix())


def _assert_equals_pil(data: bytes) -> None:
    with Image.open(io.BytesIO(data)) as im:
        want, mode = np.asarray(im), im.mode
        want_l = np.asarray(im.convert("L"))
    got = decode_jpeg(data)
    assert got.mode == mode and got.palette is None
    assert got.pixels.dtype == want.dtype and got.pixels.shape == want.shape
    diff = np.abs(got.pixels.astype(int) - want)
    assert np.array_equal(got.pixels, want), \
        f"{int((diff > 0).sum())} samples differ, max {diff.max()}"
    assert np.array_equal(to_luma(got.pixels, got.mode), want_l)


@pytest.mark.parametrize("case", list(MATRIX))
def test_decode_jpeg_equals_pil(case):
    _assert_equals_pil(MATRIX[case])


def _small_bands(monkeypatch) -> None:
    """One MCU row per band, a reader refill every 64 bytes, output bands
    of one row group."""
    monkeypatch.setattr(jpeg, "_BAND_BLOCKS", 1)
    monkeypatch.setattr(jpeg, "_WINDOW", 64)
    monkeypatch.setattr(jpeg, "_REFILL_BITS", 8 * 64)
    monkeypatch.setattr(jpeg, "_BAND_PIXELS", 1)


@pytest.mark.parametrize("case", [n for n in MATRIX if "63x65" in n or n == "cv2-gray-rst1"])
def test_decode_in_small_bands_equals_pil(case, monkeypatch):
    _small_bands(monkeypatch)
    _assert_equals_pil(MATRIX[case])


def test_cmyk_luma_equals_pil_convert():
    """to_luma's CMYK rule against PIL's convert("L") over seeded
    quadruples and the corners of the cube."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (200_000, 4), dtype=np.uint8)
    corners = np.array(np.meshgrid(*[[0, 1, 127, 128, 254, 255]] * 4)).reshape(4, -1).T
    q = np.concatenate([q, corners.astype(np.uint8)])[None]
    want = np.asarray(Image.fromarray(q, "CMYK").convert("L"))
    assert np.array_equal(to_luma(q, "CMYK"), want)


def _pil_raises(data: bytes) -> bool:
    try:
        np.asarray(Image.open(io.BytesIO(data)))
    except Exception:
        return True
    return False


def _truncation_files():
    """Files whose cuts are held against PIL: each scan type, restarts of
    both writers, and one larger than PIL's 64 KiB read."""
    big = _pixels("noise", 160, 160, 3, 5)
    yield "baseline-420", _pil_jpeg(_pixels("noise", 63, 65, 3, 1), "RGB", quality=75,
                                    subsampling=2)
    yield "baseline-gray", _pil_jpeg(_pixels("smooth", 63, 65, 1, 2), "L", quality=95)
    yield "baseline-cmyk", _pil_jpeg(_pixels("noise", 17, 33, 3, 3), "CMYK", quality=50)
    yield "progressive", _pil_jpeg(_pixels("noise", 63, 65, 3, 4), "RGB", quality=75,
                                   progressive=True)
    yield "restart-blocks", _pil_jpeg(_pixels("noise", 63, 65, 3, 6), "RGB", quality=95,
                                      restart_marker_blocks=3)
    yield "cv2-411-rst", cv2.imencode(".jpg", _pixels("noise", 63, 65, 3, 7), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes()
    yield "baseline-over-64k", _pil_jpeg(big, "RGB", quality=100, subsampling=0)


def _check_truncation(name: str) -> None:
    data = dict(_truncation_files())[name]
    rng = np.random.default_rng(len(data))
    cuts = sorted(set(range(len(data) - 16, len(data)))
                  | set(rng.integers(2, len(data), 4).tolist()))
    for cut in cuts:
        short = data[:cut]
        pil = _pil_raises(short)
        if pil:
            with pytest.raises(ValueError):
                decode_jpeg(short)
        else:
            np.testing.assert_array_equal(decode_jpeg(short).pixels,
                                          np.asarray(Image.open(io.BytesIO(short))))
    # the whole file decodes; a cut inside the scan data raises "truncated"
    decode_jpeg(data)
    with pytest.raises(ValueError, match="truncated"):
        decode_jpeg(data[:len(data) * 2 // 3])


@pytest.mark.parametrize("name", [n for n, _ in _truncation_files()])
def test_truncated_jpeg_raises_where_pil_raises(name):
    _check_truncation(name)


@pytest.mark.parametrize("name", [n for n, _ in _truncation_files()])
def test_truncated_in_small_bands_raises_where_pil_raises(name, monkeypatch):
    _small_bands(monkeypatch)
    _check_truncation(name)


def _floods():
    """A small file padded with up to a MiB of what a hostile upload may
    hold: RST markers past the last restart interval or between header
    markers, stuffed FF bytes in the scan, garbage between markers, a run
    of fill bytes, empty comments."""
    data = _pil_jpeg(_pixels("noise", 9, 11, 3, 8), "RGB", quality=90)
    eoi, n = len(data) - 2, 1 << 19
    yield "rst_past_the_intervals", data[:eoi] + b"\xff\xd0" * n + data[eoi:]
    yield "stuffed_bytes", data[:eoi] + b"\xff\x00" * n + data[eoi:]
    yield "garbage_between_markers", data[:2] + b"\xff\x00\x17" * n + data[2:]
    yield "fill_run", data[:eoi] + b"\xff" * (2 * n) + data[eoi:]
    sof = data.index(b"\xff\xc0")
    yield "rst_between_headers", data[:sof] + b"\xff\xd0" * n + data[sof:]
    yield "comments_between_headers", data[:sof] + b"\xff\xfe\x00\x02" * (n // 8) + data[sof:]


@pytest.mark.parametrize("name", [n for n, _ in _floods()])
def test_marker_floods_decode_as_pil(name):
    """Markers are searched for over windows of the file and segments past
    the scan's restart intervals are never built, so none of these costs
    a Python step per byte or per RST marker."""
    _assert_equals_pil(dict(_floods())[name])


@pytest.mark.parametrize("width,height", [(65535, 65535), (13377, 13378)])
def test_decompression_bomb_refused_as_pil_refuses(width, height):
    """A frame header claiming more than twice PIL's MAX_IMAGE_PIXELS
    (13377 x 13378 is just over it) on a 7x9 file's data: PIL refuses it at
    open, the port before it allocates anything."""
    data = _pil_jpeg(_pixels("noise", 7, 9, 3, 0), "RGB")
    sof = next(p for m, p, _ in _segments(data) if m == 0xC0)
    b = bytearray(data)
    b[sof + 5:sof + 9] = struct.pack(">HH", height, width)
    assert width * height > 2 * Image.MAX_IMAGE_PIXELS
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(bytes(b)))
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_jpeg(bytes(b))


@pytest.mark.parametrize("what,marker,precision", [
    ("lossless JPEG (SOF3)", 0xC3, 8), ("hierarchical JPEG (SOF5)", 0xC5, 8),
    ("arithmetic-coded JPEG (SOF9)", 0xC9, 8), ("12-bit JPEG precision", 0xC0, 12)])
def test_refused_jpeg_processes_name_themselves(what, marker, precision):
    data = _pil_jpeg(_pixels("noise", 7, 9, 3, 0), "RGB")
    sof = next(p for m, p, _ in _segments(data) if m == 0xC0)
    b = bytearray(data)
    b[sof + 1], b[sof + 4] = marker, precision
    with pytest.raises(ValueError, match=what.split(" (")[0] if precision == 8 else "12-bit"):
        decode_jpeg(bytes(b))
    if precision != 8:  # PIL refuses other precisions too
        assert _pil_raises(bytes(b))


def test_byte_flips_answer_pixels_or_value_error():
    """No gate on equality (see the module docstring): the agreement is
    printed. The port must answer with pixels of PIL's shape or raise
    ValueError, never another exception."""
    rng = np.random.default_rng(7)
    equal = total = 0
    for name in [n for n in MATRIX if n.startswith(("pil-RGB-63x65-noise", "pil-L-63x65-smooth",
                                                     "pil-CMYK-17x33-noise"))][::2]:
        data = MATRIX[name]
        start = data.index(b"\xff\xda") + 16
        for _ in range(12):
            b = bytearray(data)
            pos = int(rng.integers(start, len(data) - 2))
            b[pos] ^= 1 << int(rng.integers(0, 8))
            try:
                want = np.asarray(Image.open(io.BytesIO(bytes(b))))
            except Exception:
                want = None
            try:
                got = decode_jpeg(bytes(b)).pixels
            except ValueError:
                continue
            if want is not None:
                assert got.shape == want.shape
                total += 1
                equal += np.array_equal(got, want)
    print(f"byte flips: {equal} of {total} decodes equal to PIL's")


def _manifest() -> dict:
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_fixture_manifest_equals_pil_and_the_port():
    manifest = _manifest()
    names = sorted([f"jpeg/{n}" for n in os.listdir(JPEG_FIXTURES) if n.endswith(".jpg")]
                   + ["photo_noise.jpg"])
    assert names == sorted(manifest)
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        entry = manifest[name]
        with Image.open(io.BytesIO(data)) as im:
            pixels = np.asarray(im)
            assert (im.mode, list(pixels.shape), _sha(pixels), _sha(np.asarray(im.convert("L"))),
                    len(data)) == (entry["mode"], entry["shape"], entry["sha256"],
                                   entry["luma_sha256"], entry["bytes"]), name
        got = decode_jpeg(data)
        assert (got.mode, _sha(got.pixels), _sha(to_luma(got.pixels, got.mode))) == (
            entry["mode"], entry["sha256"], entry["luma_sha256"]), name


def test_jpeg_module_imports_neither_pil_nor_cv2():
    code = ("import sys; import image_enhancement_deglaring_tpu_torch.data.jpeg; "
            "import image_enhancement_deglaring_tpu_torch.data.jpeg_encode; "
            "bad = [m for m in ('PIL', 'cv2', 'jax', 'torch') if m in sys.modules]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ------------------------------------------------------------ the encoder


def _gray(kind: str, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(h * 1000 + w)
    if kind == "noise":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "flat":
        return np.full((h, w), 255, np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return np.clip((np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(1, 1), (8, 8), (37, 53), (64, 64), (3, 200), (160, 160)])
@pytest.mark.parametrize("kind", ["noise", "flat", "smooth"])
def test_encode_jpeg_gray_equals_pil_byte_for_byte(kind, h, w):
    a = _gray(kind, h, w)
    buf = io.BytesIO()
    Image.fromarray(a, "L").save(buf, "JPEG")
    got = encode_jpeg_gray(a)
    assert got == buf.getvalue()
    with Image.open(io.BytesIO(got)) as im:
        assert im.mode == "L" and im.size == (w, h)


def test_encode_jpeg_gray_refuses_what_it_cannot_write():
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 3), np.uint8),
                np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            encode_jpeg_gray(bad)
