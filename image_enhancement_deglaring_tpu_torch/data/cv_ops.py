"""The three OpenCV operations that heavy augmentation calls, in numpy.

The card's machine has no cv2, so the port keeps its own copies of
``cv2.getRotationMatrix2D`` / ``cv2.warpAffine`` (constant-0 border),
``cv2.GaussianBlur(img, (3, 3), 0)`` and ``cv2.createCLAHE(...).apply``.
Each is vectorized over the pixels; ``tests/test_torch_port_augment.py``
holds them against cv2 5.0.0.
"""

from __future__ import annotations

import math

import numpy as np

INTER_LINEAR = 1
INTER_NEAREST = 0


def rotation_matrix(center: tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: a (2, 3) float64 matrix rotating by
    ``angle`` degrees (counter-clockwise, y down) about ``center`` = (x, y)
    and scaling by ``scale``."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def warp_affine(img: np.ndarray, m: np.ndarray, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags=interpolation,
    borderMode=BORDER_CONSTANT, borderValue=0)`` for a float32 (H, W) image:
    each output pixel (x, y) samples the input at ``inv(m) @ (x, y, 1)``,
    bilinear or nearest, with pixels outside the input reading 0."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    inv = invert_affine(np.asarray(m, np.float64)).astype(np.float32)
    xs = np.arange(w, dtype=np.float64)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    # cv2 5 takes each row's offset in float32, then one fused multiply-add
    # per pixel: the float32 product is exact in float64, so rounding the
    # float64 sum once is the fma. At 512^2 the coordinates' last bit
    # decides nearest-neighbour ties, so the order matters.
    sx = (np.float64(inv[0, 0]) * xs + (inv[0, 1] * ys + inv[0, 2])).astype(np.float32)
    sy = (np.float64(inv[1, 0]) * xs + (inv[1, 1] * ys + inv[1, 2])).astype(np.float32)
    # one ring of zeros around the input: a tap outside it reads the border
    pad = np.zeros((h + 2, w + 2), np.float32)
    pad[1:-1, 1:-1] = img
    if interpolation == INTER_NEAREST:
        ix = np.rint(sx).astype(np.int64)
        iy = np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        return np.where(inside, pad[np.clip(iy, -1, h) + 1, np.clip(ix, -1, w) + 1],
                        np.float32(0))
    if interpolation != INTER_LINEAR:
        raise ValueError(f"interpolation must be INTER_LINEAR or INTER_NEAREST, got {interpolation}")
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = sx - x0
    fy = sy - y0
    # taps further out than the ring all read 0: clip them onto it
    ix = np.clip(x0.astype(np.int64), -1, w) + 1
    iy = np.clip(y0.astype(np.int64), -1, h) + 1
    ix1 = np.clip(x0.astype(np.int64) + 1, -1, w) + 1
    iy1 = np.clip(y0.astype(np.int64) + 1, -1, h) + 1
    # cv2 5's vector loop: three lerps a + t * (b - a), each one fma. Its
    # scalar tail (the last W % 16 columns) rounds otherwise, up to ~4e-6.
    top = _fma(fx, pad[iy, ix1] - pad[iy, ix], pad[iy, ix])
    bottom = _fma(fx, pad[iy1, ix1] - pad[iy1, ix], pad[iy1, ix])
    return _fma(fy, bottom - top, top)


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c rounded once (the float32 product is exact in
    float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def gaussian_blur_3x3(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (3, 3), 0)``: sigma 0 at ksize 3 is cv2's fixed
    [1, 2, 1] / 4 kernel, applied along rows then columns, reflect-101
    borders."""
    img = np.asarray(img, np.float32)
    p = np.pad(img, 1, mode="reflect")  # numpy's "reflect" is cv2's reflect-101
    q, h = np.float32(0.25), np.float32(0.5)
    # cv2's symmetric-kernel form: the outer taps summed first
    rows = (p[:, :-2] + p[:, 2:]) * q + p[:, 1:-1] * h
    return (rows[:-2] + rows[2:]) * q + rows[1:-1] * h


def clahe_u8(u8: np.ndarray, clip_limit: float, grid: tuple[int, int] = (8, 8)) -> np.ndarray:
    """``cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=grid).apply(u8)``
    on a uint8 (H, W) image, bit for bit: per-tile histograms over the input
    padded (reflect-101) to a multiple of the grid, clipped at
    ``max(int(clip * tile_px / 256), 1)`` with the excess spread evenly and
    its remainder by a stride, LUTs ``round(cdf * 255 / tile_px)``, and the
    four nearest tiles' LUTs blended bilinearly in float32."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8 or u8.ndim != 2:
        raise ValueError(f"clahe_u8 takes a uint8 (H, W) image, got {u8.dtype} {u8.shape}")
    h, w = u8.shape
    gx, gy = grid
    src = u8
    if w % gx or h % gy:
        # cv2 pads by grid - (size % grid) on both axes, a whole tile where
        # the axis divides already
        src = np.pad(u8, ((0, gy - h % gy), (0, gx - w % gx)), mode="reflect")
    th, tw = src.shape[0] // gy, src.shape[1] // gx
    tile_px = th * tw
    tiles = src[:gy * th, :gx * tw].reshape(gy, th, gx, tw).transpose(0, 2, 1, 3)
    ids = np.arange(gy * gx, dtype=np.int64).reshape(gy, gx, 1, 1) * 256 + tiles
    hist = np.bincount(ids.ravel(), minlength=gy * gx * 256).reshape(gy * gx, 256)
    limit = max(int(clip_limit * tile_px / 256), 1)
    clipped = np.maximum(hist - limit, 0).sum(axis=1, keepdims=True)
    hist = np.minimum(hist, limit) + clipped // 256
    residual = clipped - (clipped // 256) * 256
    step = np.maximum(256 // np.maximum(residual, 1), 1)
    i = np.arange(256)[None, :]
    hist += ((i % step == 0) & (i // step < residual)).astype(hist.dtype)
    scale = np.float32(255) / np.float32(tile_px)
    lut = np.clip(np.rint(np.cumsum(hist, axis=1).astype(np.float32) * scale), 0, 255)
    lut = lut.astype(np.float32).reshape(gy, gx, 256)

    def axis(n, t, tiles_n):
        f = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(t)) - np.float32(0.5)
        lo = np.floor(f)
        a = (f - lo).astype(np.float32)
        lo = lo.astype(np.int64)
        return np.maximum(lo, 0), np.minimum(lo + 1, tiles_n - 1), a, np.float32(1) - a

    ty1, ty2, ya, ya1 = axis(h, th, gy)
    tx1, tx2, xa, xa1 = axis(w, tw, gx)
    v = u8.astype(np.int64)
    l11 = lut[ty1[:, None], tx1[None, :], v]
    l12 = lut[ty1[:, None], tx2[None, :], v]
    l21 = lut[ty2[:, None], tx1[None, :], v]
    l22 = lut[ty2[:, None], tx2[None, :], v]
    res = ((l11 * xa1 + l12 * xa) * ya1[:, None] + (l21 * xa1 + l22 * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
