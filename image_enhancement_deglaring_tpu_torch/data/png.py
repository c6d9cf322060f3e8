"""PNG codec on the standard library (``zlib``, ``struct``) and numpy.

The JAX package reads and writes images with PIL; the machine with the
card has neither PIL nor cv2, so the port reads and writes its PNGs here.
It reads every PNG: bit depths 1, 2, 4, 8 and 16, gray, RGB, palette,
gray+alpha and RGBA, plain or Adam7-interlaced, all five scanline
filters, into the arrays ``np.asarray(PIL.Image.open(path))`` gives:
(H, W) for one sample per pixel and (H, W, C) otherwise, in PIL's mode
(``decode_png_image`` names it). As PIL, it refuses an image of more than
twice PIL's ``Image.MAX_IMAGE_PIXELS`` before it inflates anything, and
inflates no more than the image's scanlines. It writes 8-bit gray,
gray+alpha, RGB and RGBA, under one filter or under the filters PIL's
encoder picks.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}      # channels written -> colour type
FILTERS = (0, 1, 2, 3, 4)                    # none, sub, up, average, paeth


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG file (chunk {kind!r} runs past the end)")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG file (no IEND)")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(kinds: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Rows whose filters are none, sub or up, a run of rows of one filter
    at a time: sub is a running sum along each row, up adds the row above;
    uint8 sums wrap modulo 256."""
    out = np.empty(filt.shape, np.uint8)
    starts = np.flatnonzero(np.diff(kinds.astype(np.int16), prepend=-1))
    for r0, r1 in zip(starts, list(starts[1:]) + [len(kinds)]):
        kind, run = kinds[r0], filt[r0:r1]
        if kind == 0:
            out[r0:r1] = run
        elif kind == 1:
            np.cumsum(run, axis=1, dtype=np.uint8, out=out[r0:r1])
        else:
            # one call down the run, not a call per row: a row loop is
            # faster alone, but each numpy call of over ~500 elements lets
            # go of the GIL and waits for it again, and the server decodes
            # in many threads at once, where those waits add up
            np.cumsum(run, axis=0, dtype=np.uint8, out=out[r0:r1])
            if r0:
                out[r0:r1] += out[r0 - 1]
    return out


def _unfilter_wavefront(kinds: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Any filters: pixel (r, x) needs (r, x-1), (r-1, x) and (r-1, x-1),
    so all pixels of one anti-diagonal r + x = t are computed at once. In
    the flattened image with a zero row and column in front (row stride
    w + 1), an anti-diagonal and its three neighbours are slices of
    stride w: views, no index arrays."""
    h, w, bpp = filt.shape
    stride = w + 1
    rec = np.zeros(((h + 1) * stride, bpp), np.int16)
    f = np.zeros_like(rec)
    f.reshape(h + 1, stride, bpp)[1:, 1:] = filt
    kinds = kinds.astype(np.intp)
    for t in range(h + w - 1):
        r0, r1 = max(0, t - w + 1), min(h - 1, t) + 1
        start = (r0 + 1) * stride + t - r0 + 1
        end = start + (r1 - r0 - 1) * w + 1
        a = rec[start - 1:end - 1:w]
        b = rec[start - stride:end - stride:w]
        c = rec[start - stride - 1:end - stride - 1:w]
        k = kinds[r0:r1, None]
        pred = np.choose(k, (0, a, b, (a + b) >> 1, _paeth(a, b, c)))
        rec[start:end:w] = (f[start:end:w] + pred) & 255
    return rec.reshape(h + 1, stride, bpp)[1:, 1:].astype(np.uint8)


# (bit depth, colour type) -> PIL's mode of the decoded image, as
# PIL.PngImagePlugin maps them: 2- and 4-bit gray is scaled to 8 bits,
# 16-bit samples keep their high byte, except 16-bit gray ("I;16"), and
# 16-bit gray+alpha becomes RGBA (L, L, L, A)
_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
          (8, 2): "RGB", (16, 2): "RGB",
          (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
          (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples per pixel
_MAX_PIXELS = 2 * 89478485  # PIL's bomb limit: twice Image.MAX_IMAGE_PIXELS
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngImage(NamedTuple):
    """A decoded PNG: ``pixels`` as ``np.asarray(PIL.Image.open(...))``
    gives them, ``mode`` PIL's mode name, ``palette`` the (256, 3) uint8
    colours of a "P" image (entries the file does not give are black, as
    in PIL), else None."""
    pixels: np.ndarray
    mode: str
    palette: np.ndarray | None


def _unpack(raw: np.ndarray, w: int, h: int, depth: int, samples: int) -> np.ndarray:
    """Filtered scanlines of one (sub)image -> samples (h, w, samples),
    uint8 or uint16 (big-endian in the file)."""
    row_bytes = (w * depth * samples + 7) // 8
    if raw.size != h * (1 + row_bytes):
        raise ValueError(f"PNG image data holds {raw.size} bytes, want {h * (1 + row_bytes)}")
    rows = raw.reshape(h, 1 + row_bytes)
    bpp = max(1, depth * samples // 8)  # the filters' byte distance
    kinds, filt = rows[:, 0], rows[:, 1:].reshape(h, row_bytes // bpp, bpp)
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"PNG filter type {int(kinds.max())} is invalid")
    data = (_unfilter_rows(kinds, filt) if not kinds.size or kinds.max() <= 2
            else _unfilter_wavefront(kinds, filt)).reshape(h, row_bytes)
    if depth == 8:
        return data.reshape(h, w, samples)
    if depth == 16:
        pairs = data.reshape(h, w, samples, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    per_byte = 8 // depth  # sub-byte samples, first sample in the high bits
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    values = (data[:, :, None] >> shifts) & ((1 << depth) - 1)
    return values.reshape(h, row_bytes * per_byte)[:, :w, None]


def decode_png_image(data: bytes) -> PngImage:
    """PNG bytes -> PngImage: bit depths 1, 2, 4, 8 and 16, colour types 0,
    2, 3, 4 and 6, plain or Adam7-interlaced, as PIL decodes them."""
    header, idat, plte = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, _compression, _filter_method, interlace = header
    mode = _MODES.get((depth, colour))
    if mode is None:
        raise ValueError(f"PNG bit depth {depth} with colour type {colour} is invalid")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is invalid")
    samples = _SAMPLES[colour]
    pixels = max(1, w) * max(1, h)
    if pixels > _MAX_PIXELS:  # PIL's _decompression_bomb_check, before any allocation
        raise ValueError(f"Image size ({pixels} pixels) exceeds limit of {_MAX_PIXELS} "
                         "pixels, could be decompression bomb DOS attack.")
    passes = [(w, h)] if interlace == 0 else [
        (-(-(w - x0) // dx), -(-(h - y0) // dy)) for x0, y0, dx, dy in _ADAM7]
    want = sum(ph * (1 + (pw * depth * samples + 7) // 8) for pw, ph in passes
               if pw > 0 and ph > 0)
    # as PIL, inflate no more than the image holds and ignore data past it
    raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), max(want, 1)),
                        np.uint8)
    if interlace == 0:
        img = _unpack(raw, w, h, depth, samples)
    else:
        img = np.zeros((h, w, samples), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no scanlines at all
            n = ph * (1 + (pw * depth * samples + 7) // 8)
            img[y0::dy, x0::dx] = _unpack(raw[pos:pos + n], pw, ph, depth, samples)
            pos += n
        if pos != raw.size:
            raise ValueError(f"PNG image data holds {raw.size} bytes, want {pos}")
    palette = None
    if mode == "P":
        if plte is None or len(plte) % 3:
            raise ValueError("PNG palette image without a valid PLTE chunk")
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        palette[:len(entries)] = entries
    elif depth == 16 and mode != "I;16":
        img = (img >> 8).astype(np.uint8)
        if colour == 4:
            img = img[..., [0, 0, 0, 1]]
    elif depth < 8 and mode == "L":
        img = img * np.uint8(255 // ((1 << depth) - 1))
    elif mode == "1":
        img = img != 0
    return PngImage(img[..., 0] if img.shape[-1] == 1 else img, mode, palette)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> pixels, as ``np.asarray(PIL.Image.open(...))`` gives
    them (palette indices for a palette image)."""
    return decode_png_image(data).pixels


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _filter(img: np.ndarray, kind: int) -> np.ndarray:
    """Filtered scanlines (H, W, C) of ``img`` under filter ``kind``."""
    if kind in (0, 1, 2):  # none, sub, up: uint8 differences wrap modulo 256
        out = img.copy()
        if kind == 1:
            out[:, 1:] -= img[:, :-1]
        elif kind == 2:
            out[1:] -= img[:-1]
        return out
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = _paeth(a, b, c) if kind == 4 else (a + b) >> 1
    return ((x - pred) & 255).astype(np.uint8)


# PIL's encoder (Pillow's ZipEncode.c, ``optimize=False``) filters each
# scanline by the first of these that gives the least sum of its bytes
# read as signed; it never tries average
_ADAPTIVE_ORDER = (0, 2, 1, 4)


def _adaptive(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row filter types (H,) and filtered scanlines (H, W*C), chosen
    as PIL chooses them."""
    h = img.shape[0]
    cand = np.stack([_filter(img, k).reshape(h, -1) for k in _ADAPTIVE_ORDER])
    cost = np.minimum(cand, 256 - cand.astype(np.int32)).sum(axis=2)
    pick = cost.argmin(axis=0)  # the first of equal sums, as PIL keeps it
    return np.asarray(_ADAPTIVE_ORDER, np.uint8)[pick], cand[pick, np.arange(h)]


def encode_png(img: np.ndarray, *, filter_type: int | str = 2,
               compress_level: int = -1, text: dict[str, str] | None = None) -> bytes:
    """uint8 (H, W) or (H, W, C), C in 1..4, -> PNG bytes, every scanline
    under ``filter_type`` (0 none, 1 sub, 2 up, 3 average, 4 paeth), or
    under the filter PIL's encoder picks for it (``"adaptive"``: the
    scanlines equal those of ``Image.save(..., "PNG")``), the data
    deflated at zlib ``compress_level`` (-1: zlib's default, 6). ``text``
    adds one Latin-1 ``tEXt`` chunk per keyword (``png_text`` reads them)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encode takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"PNG encode takes (H, W) or (H, W, 1..4), got {img.shape}")
    h, w, ch = img.shape
    if filter_type == "adaptive":
        kinds, rows = _adaptive(img)
    elif filter_type in FILTERS:
        kinds, rows = np.full(h, filter_type, np.uint8), _filter(img, filter_type).reshape(h, -1)
    else:
        raise ValueError(f"filter_type must be one of {FILTERS} or 'adaptive', got {filter_type}")
    raw = np.concatenate([kinds[:, None], rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    texts = b"".join(chunk(b"tEXt", k.encode("latin-1") + b"\0" + v.encode("latin-1"))
                     for k, v in (text or {}).items())
    return (_SIGNATURE + chunk(b"IHDR", ihdr) + texts
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level)) + chunk(b"IEND", b""))


def png_text(data: bytes) -> dict[str, str]:
    """The ``tEXt`` chunks of PNG bytes, keyword -> text."""
    out = {}
    for kind, body in _chunks(data):
        if kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            out[key.decode("latin-1")] = value.decode("latin-1")
    return out


def png_header(data: bytes) -> tuple[int, int, str]:
    """(width, height, PIL's mode) from the chunks before the image data,
    as ``PIL.Image.open`` reads them without decoding the pixels: a bad
    signature, a chunk that runs past the end or fails its CRC before the
    first IDAT raises, a truncated image data stream does not."""
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            mode = _MODES.get((depth, colour))
            if mode is None:
                raise ValueError(f"PNG bit depth {depth} with colour type {colour} is invalid")
            return w, h, mode
        if kind == b"IDAT":
            break
    raise ValueError("PNG file has no IHDR chunk")


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
