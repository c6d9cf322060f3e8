"""PNG codec on the standard library (``zlib``, ``struct``) and numpy.

The JAX package reads and writes images with PIL; the machine with the
card has neither PIL nor cv2, so the port reads and writes its PNGs here.
It covers what the data pipeline needs: 8-bit grayscale, gray+alpha, RGB
and RGBA, non-interlaced, all five scanline filters. It raises on palette
images, 16-bit samples and interlaced files.

Arrays are uint8, (H, W) for grayscale and (H, W, C) otherwise, as
``np.asarray(PIL.Image.open(path))`` gives them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}         # colour type -> channels
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}
FILTERS = (0, 1, 2, 3, 4)                    # none, sub, up, average, paeth


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
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
    """Rows whose filters are none, sub or up: each row at once (sub is a
    running sum along the row, modulo 256)."""
    out = np.empty(filt.shape, np.uint8)
    prev = np.zeros(filt.shape[1:], np.uint8)
    for r, kind in enumerate(kinds):
        row = filt[r]
        if kind == 1:
            row = np.cumsum(row, axis=0, dtype=np.uint64).astype(np.uint8)
        elif kind == 2:
            row = row + prev  # uint8 arithmetic wraps modulo 256
        out[r] = row
        prev = out[r]
    return out


def _unfilter_wavefront(kinds: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Any filters: pixel (r, x) needs (r, x-1), (r-1, x) and (r-1, x-1),
    so all pixels of one anti-diagonal r + x = t are computed at once."""
    h, w, _ = filt.shape
    rec = np.zeros((h + 1, w + 1, filt.shape[2]), np.int32)  # zero row and column in front
    f32 = filt.astype(np.int32)
    kinds = kinds.astype(np.int64)
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        x = t - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        pred = np.choose(kinds[r][:, None], (np.zeros_like(a), a, b, (a + b) >> 1,
                                             _paeth(a, b, c)))
        rec[r + 1, x + 1] = (f32[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, _compression, _filter_method, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} not supported (palette or unknown)")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} not supported (8 only)")
    if interlace != 0:
        raise ValueError("interlaced PNG not supported")
    ch = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"PNG image data holds {raw.size} bytes, want {h * (1 + w * ch)}")
    rows = raw.reshape(h, 1 + w * ch)
    kinds, filt = rows[:, 0], rows[:, 1:].reshape(h, w, ch)
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"PNG filter type {int(kinds.max())} is invalid")
    img = (_unfilter_rows(kinds, filt) if not kinds.size or kinds.max() <= 2
           else _unfilter_wavefront(kinds, filt))
    return img[..., 0] if ch == 1 else img


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _filter(img: np.ndarray, kind: int) -> np.ndarray:
    """Filtered scanlines (H, W, C) of ``img`` under filter ``kind``."""
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = _paeth(a, b, c) if kind == 4 else (np.zeros_like(x), a, b, (a + b) >> 1)[kind]
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(img: np.ndarray, *, filter_type: int = 2) -> bytes:
    """uint8 (H, W) or (H, W, C), C in 1..4, -> PNG bytes, every scanline
    under ``filter_type`` (0 none, 1 sub, 2 up, 3 average, 4 paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encode takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"PNG encode takes (H, W) or (H, W, 1..4), got {img.shape}")
    if filter_type not in FILTERS:
        raise ValueError(f"filter_type must be one of {FILTERS}, got {filter_type}")
    h, w, ch = img.shape
    rows = _filter(img, filter_type).reshape(h, w * ch)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
