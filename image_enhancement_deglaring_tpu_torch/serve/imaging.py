"""The server's host image path, without PIL.

The JAX server decodes uploads with PIL, converts them to luma with
``Image.convert("L")`` and resizes with ``Image.LANCZOS`` both ways; the
machine with the card has no PIL, and the pixel values are the API's
contract. This module computes the same values bit for bit:

- ``decode_image``: PNG bytes of any bit depth, colour type or interlace
  (``data.png``), and JPEG bytes (``FF D8 FF`` first, PIL's test): baseline,
  extended and progressive Huffman JPEGs, as PIL's libjpeg-turbo decodes
  them (``data.jpeg``). Any other body raises a ValueError.
- ``to_luma``: ``np.array(img.convert("L"))`` by Pillow's rules
  (``Convert.c``): RGB/RGBA/palette colours by ``(R*19595 + G*38470 +
  B*7471 + 0x8000) >> 16``, alpha ignored; CMYK through ``cmyk2rgb``
  first (each of C, M, Y to ``255-K - MULDIV255(v, 255-K)``); LA its L;
  "1" to 0/255; "I;16" clipped to 255.
- ``resize_lanczos``: ``Image.resize(size, Image.LANCZOS)`` of a uint8
  image by Pillow's ``Resample.c``: ``sinc(x)·sinc(x/3)`` on support
  ``3·max(scale, 1)`` centred at ``(i + 0.5)·scale``, normalised in
  double, rounded to int32 with 22 fraction bits (half away from zero),
  each output ``clip8(2^21 + sum(in·k)) >> 22`` summed over its taps in
  int32; the horizontal pass first (its uint8 result feeds the vertical
  pass), a pass skipped where the size does not change.

The response PNG is written by ``data.png.encode_png`` (any zlib level).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..data.jpeg import decode_jpeg
from ..data.png import decode_png_image

_PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0
_BLOCK_ELEMENTS = 1 << 16  # int32 sums per block of a pass: 256 KB, in cache
_LUMA = (19595, 38470, 7471)  # Convert.c's L24 weights, summing to 2^16


def decode_image(data: bytes):
    """Image bytes -> ``data.png.PngImage`` (pixels, PIL mode, palette)."""
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(bytes(data))
    return decode_png_image(bytes(data))


def _luma(rgb: np.ndarray) -> np.ndarray:
    """uint8 (..., >=3) -> uint8 (...), Pillow's integer luma."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * _LUMA[0] + g * _LUMA[1] + b * _LUMA[2] + 0x8000) >> 16).astype(np.uint8)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """uint8 (..., 4) -> uint8 (..., 3), Pillow's ``cmyk2rgb``: with nk =
    255 - K, each of C, M, Y to ``clip8(nk - MULDIV255(v, nk))``."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - ((t + (t >> 8)) >> 8), 0, 255).astype(np.uint8)


def to_luma(img: np.ndarray, pil_mode: str, palette: np.ndarray | None = None) -> np.ndarray:
    """Pixels of PIL mode ``pil_mode`` -> uint8 (H, W), equal to
    ``np.array(PIL.Image.open(...).convert("L"))``. ``palette`` ((N, 3)
    uint8) is required for mode "P"."""
    img = np.asarray(img)
    if pil_mode == "L":
        return img.astype(np.uint8, copy=False)
    if pil_mode in ("RGB", "RGBA"):
        return _luma(img)
    if pil_mode == "P":
        if palette is None:
            raise ValueError("mode P needs its palette")
        return _luma(np.asarray(palette, np.uint8))[img]
    if pil_mode == "CMYK":
        return _luma(_cmyk_to_rgb(img))
    if pil_mode == "LA":
        return img[..., 0].astype(np.uint8, copy=False)
    if pil_mode == "1":
        return np.where(img, np.uint8(255), np.uint8(0))
    if pil_mode == "I;16":
        return np.minimum(img, 255).astype(np.uint8)
    raise ValueError(f"no luma conversion for PIL mode {pil_mode!r}")


def _lanczos(x: float) -> float:
    """Resample.c's ``lanczos_filter``: sinc(x)·sinc(x/3) on [-3, 3),
    with libm's sin, in double."""
    if not -3.0 <= x < 3.0:
        return 0.0

    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0)


@functools.lru_cache(maxsize=16)
def _pass_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """One pass's int32 weights as Resample.c's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` make them: (out_size, taps) input indices and
    weights, taps at most 2·ceil(support) + 1; an output with fewer inputs
    is padded with weight 0 on its first input."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ss = 1.0 / filterscale
    one = float(1 << _PRECISION_BITS)
    taps = min(2 * math.ceil(support) + 1, in_size)
    index = np.zeros((out_size, taps), np.intp)
    weight = np.zeros((out_size, taps), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # C's (int) truncates
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        index[xx] = xmin
        index[xx, :xmax] += np.arange(xmax)
        for x, w in enumerate(k):
            if ww != 0.0:
                w /= ww
            weight[xx, x] = int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
    index.flags.writeable = weight.flags.writeable = False
    return index, weight


def _resample_rows(img: np.ndarray, out_size: int) -> np.ndarray:
    """Resample.c's pass along axis 0 of uint8 (H, W): each output row is
    ``clip8(2^21 + sum(in·k)) >> 22`` over its taps, summed in int32 as
    the C code sums them. A block of output rows at a time, small enough
    to stay in cache, one tap at a time over the block (its input rows
    gathered as uint8, widened in the product)."""
    index, weight = _pass_taps(img.shape[0], out_size)
    out = np.empty((out_size, img.shape[1]), np.uint8)
    block = max(1, _BLOCK_ELEMENTS // img.shape[1])
    sums = np.empty((block, img.shape[1]), np.int32)
    prods, rows = np.empty_like(sums), np.empty(sums.shape, np.uint8)
    for r0 in range(0, out_size, block):
        r1 = min(r0 + block, out_size)
        s, p, g = sums[:r1 - r0], prods[:r1 - r0], rows[:r1 - r0]
        s.fill(1 << (_PRECISION_BITS - 1))
        for t in range(index.shape[1]):
            np.take(img, index[r0:r1, t], axis=0, out=g)
            np.multiply(g, weight[r0:r1, t, None], out=p)
            s += p
        np.right_shift(s, _PRECISION_BITS, out=s)
        out[r0:r1] = np.clip(s, 0, 255, out=s)
    return out


def resize_lanczos(img_u8: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) -> uint8 (h, w) for ``size = (w, h)``, equal to
    ``np.array(Image.fromarray(img_u8).resize(size, Image.LANCZOS))``."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"resize_lanczos takes uint8 (H, W), got {img.dtype} {img.shape}")
    w, h = size
    if w < 1 or h < 1:
        raise ValueError(f"target size must be positive, got {size}")
    if img.shape[1] != w:
        img = np.ascontiguousarray(_resample_rows(np.ascontiguousarray(img.T), w).T)
    if img.shape[0] != h:
        img = _resample_rows(img, h)
    return img
