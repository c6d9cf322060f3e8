"""SD1 triptych pipeline: path discovery, seeded split, host decode.

Counterpart of ``image_enhancement_deglaring_tpu.data.pipeline`` on its
numpy path. Each sample is one (S, 3S) image laid out [ground-truth |
glared | glare-mask]; it is read with the port's PNG codec (``data.png``)
or JPEG decoder (``data.jpeg``) into the array PIL gives, turned to
grayscale and resized here. The split is the JAX package's (and the
reference's): sort paths, shuffle with ``np.random.RandomState(seed)``, cut
at ``1 - val_split``.

The resize is a numpy bilinear resize to OpenCV's ``INTER_LINEAR`` rule
for uint8 images, which the JAX package runs wherever cv2 is installed:
half-pixel centres, 11-bit fixed-point weights, and OpenCV's rounding of
the vertical pass. ``use_native=True`` runs the per-pixel work in the
port's copy of the JAX package's C++ library (``native/``), which resizes
in float and rounds once: at identity size it equals the numpy path, at a
resize it is within one uint8 step of it.
"""

from __future__ import annotations

import os

import numpy as np


_IMG_EXTS = (".png", ".jpg", ".jpeg")
_COEF_BITS = 11                 # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def list_image_paths(data_dir: str) -> list[str]:
    """Recursive scan for images, sorted."""
    paths = []
    for root, _, files in os.walk(data_dir):
        for f in files:
            if f.lower().endswith(_IMG_EXTS):
                paths.append(os.path.join(root, f))
    paths.sort()
    return paths


def seeded_split(paths: list[str], val_split: float, seed: int | None):
    """The reference's train/val split: sorted paths shuffled by
    ``RandomState(seed)``, cut at ``1 - val_split``."""
    paths = sorted(paths)
    if seed is not None:
        rng = np.random.RandomState(seed)
        rng.shuffle(paths)
    else:
        np.random.shuffle(paths)
    split_idx = int(len(paths) * (1 - val_split))
    return paths[:split_idx], paths[split_idx:]


def _to_gray_uint8(img: np.ndarray) -> np.ndarray:
    """Luminance grayscale with uint8 rounding (cv2's RGB2GRAY weights)."""
    if img.ndim == 2:
        return img
    r = img[..., 0].astype(np.float32)
    g = img[..., 1].astype(np.float32)
    b = img[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return np.clip(np.rint(y), 0, 255).astype(np.uint8)


def _linear_taps(src: int, dst: int, clamp_weight: bool):
    """Source index and 11-bit weights of the two taps of each output
    coordinate, as OpenCV computes them: ``f = (d + 0.5) * scale - 0.5`` in
    float32, ``i = floor(f)``, weights ``round((1 - (f - i)) * 2048)`` and
    ``round((f - i) * 2048)``. Along x (``clamp_weight``) a tap left of or
    at the last column takes the border column with weight (2048, 0);
    along y the weights stay and the rows are clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    frac = f - i.astype(np.float32)
    if clamp_weight:
        low, high = i < 0, i >= src - 1
        frac[low | high] = 0.0
        i[low] = 0
        i[high] = src - 1
    w0 = np.rint((np.float32(1.0) - frac) * _COEF_SCALE).astype(np.int64)
    w1 = np.rint(frac * _COEF_SCALE).astype(np.int64)
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), w0, w1


def _resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W) image to (size, size) by
    OpenCV's INTER_LINEAR rule (``cv2.resize(img, (size, size))``)."""
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    x0, x1, a0, a1 = _linear_taps(w, size, clamp_weight=True)
    y0, y1, b0, b1 = _linear_taps(h, size, clamp_weight=False)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0 + src[:, x1] * a1  # (h, size), weights summing to ~2^11
    # the vertical pass of OpenCV's uint8 specialisation: each product
    # shifted down by 16 after dropping 4 bits, then rounded by 2 bits
    top = (b0[:, None] * (rows[y0] >> 4)) >> 16
    bottom = (b1[:, None] * (rows[y1] >> 4)) >> 16
    return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)


def read_image(path) -> np.ndarray:
    """The pixels ``np.asarray(PIL.Image.open(path))`` gives, for a PNG or a
    JPEG (``serve.imaging.decode_image``)."""
    from ..serve.imaging import decode_image

    with open(path, "rb") as f:
        return decode_image(f.read()).pixels


def decode_triptych(path: str, image_size: int = 512, *, with_mask: bool = False,
                    use_native: bool | None = None):
    """Decode one SD1 sample -> (glared, ground_truth[, mask]) float32 in
    [0, 1], each (H, W) at ``image_size``: split the thirds, grayscale,
    resize, /255. ``use_native=True`` runs the split, luma, resize and /255
    in the native library (``native/``; raises if it cannot be built), and
    refuses ``with_mask``; None or False take the numpy path."""
    img = read_image(path)
    if use_native:
        if with_mask:
            raise RuntimeError("native decode does not support with_mask=True")
        from .. import native

        return native.triptych_preprocess(img, image_size)
    third = img.shape[1] // 3
    gt = _to_gray_uint8(img[:, :third])
    glared = _to_gray_uint8(img[:, third : 2 * third])
    gt = _resize_uint8(gt, image_size).astype(np.float32) / 255.0
    glared = _resize_uint8(glared, image_size).astype(np.float32) / 255.0
    if with_mask:
        mask = _to_gray_uint8(img[:, 2 * third : 3 * third])
        mask = _resize_uint8(mask, image_size).astype(np.float32) / 255.0
        return glared, gt, mask
    return glared, gt


def decode_inference_image(path_or_array, image_size: int = 512, *,
                           use_native: bool | None = None) -> np.ndarray:
    """Single-image inference preprocessing: gray, resize, [0,1] (H, W)
    (reference: src/preprocess.py:54-90).

    A path (PNG or JPEG) is decoded into the array
    ``np.asarray(PIL.Image.open(path))`` gives (``read_image``). Array inputs may be uint8 [0,255]
    or float [0,1]; floats are converted to the uint8 path up front, and a
    float array holding [0,255] values raises rather than saturating every
    pixel to white. ``use_native=True`` runs the luma, resize and /255 in
    the native library (``native/``; raises if it cannot be built)."""
    if isinstance(path_or_array, (str, os.PathLike)):
        img = read_image(path_or_array)
    else:
        img = np.asarray(path_or_array)
        if np.issubdtype(img.dtype, np.floating):
            mx = float(img.max(initial=0.0))
            if mx > 1.0 + 1e-6:
                raise ValueError(
                    "float image values must be normalized to [0,1] "
                    f"(max={mx:g}); divide by 255 first or pass uint8")
            img = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    if use_native:
        from .. import native

        return native.inference_preprocess(img, image_size)
    gray = _to_gray_uint8(img) if img.ndim == 3 else img
    gray = _resize_uint8(gray, image_size)
    return gray.astype(np.float32) / 255.0
