"""Image ops on NHWC tensors: grayscale, triptych split, resize, dtype ladders.

Counterpart of ``image_enhancement_deglaring_tpu.ops.image``, as torch
functions on (..., H, W, C) tensors, so that they run wherever the tensor
lies. The reference does all of this on the host with cv2/PIL
(reference: src/preprocess.py:21-45, src/optimized_dataset.py:56-79);
host decode (PNG bytes -> uint8 array) stays in the data layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: ITU-R BT.601 luminance weights used by the reference
#: (reference: src/preprocess.py:32-36) and by cv2's RGB2GRAY.
LUMA_WEIGHTS = (0.299, 0.587, 0.114)

# jnp.pad's modes -> F.pad's
_PAD_MODES = {"edge": "replicate", "constant": "constant", "reflect": "reflect",
              "wrap": "circular"}


def rgb_to_gray_luminance(img: torch.Tensor) -> torch.Tensor:
    """Luminance grayscale of (..., H, W, C>=3); keeps a trailing 1-channel.

    Uses 0.299 R + 0.587 G + 0.114 B; alpha (if any) is ignored, matching
    the reference's RGBA handling (reference: src/preprocess.py:30-33).
    """
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    w = LUMA_WEIGHTS
    return (w[0] * r + w[1] * g + w[2] * b)[..., None]


def split_triptych(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split a horizontal [ground-truth | glared | mask] triptych.

    Input (..., H, 3*W, C) -> three (..., H, W, C) views
    (reference: src/preprocess.py:21-27, scripts/split_image.py:40-44).
    """
    third = img.shape[-2] // 3
    return (img[..., :, :third, :], img[..., :, third:2 * third, :],
            img[..., :, 2 * third:3 * third, :])


def _nchw(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (prod(...), C, H, W)."""
    return img.reshape((-1,) + tuple(img.shape[-3:])).permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor, lead: tuple) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).reshape(lead + tuple(y.shape[-2:]) + (y.shape[1],))


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of float (..., H, W, C) to (..., height, width, C).

    Half-pixel centres with antialias OFF, the convention of
    ``jax.image.resize(method="bilinear", antialias=False)`` and of
    cv2.resize(INTER_LINEAR) in the reference data path
    (reference: src/optimized_dataset.py:74-75).
    """
    y = F.interpolate(_nchw(img), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return _nhwc(y, tuple(img.shape[:-3]))


def from_uint8(img: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> float [0,1] (reference: src/preprocess.py:44-45)."""
    return img.to(dtype) / torch.tensor(255.0, dtype=dtype, device=img.device)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8, clipping first, truncating
    (reference: src/preprocess.py:107-110)."""
    return (torch.clamp(img.float(), 0.0, 1.0) * 255.0).to(torch.uint8)


def pad_to_multiple(img: torch.Tensor, multiple: int, *, mode: str = "edge"):
    """Pad H and W of (..., H, W, C) up to the next multiple.

    Returns (padded, (orig_h, orig_w)). ``mode`` is ``jnp.pad``'s name:
    "edge", "constant", "reflect" or "wrap".
    """
    if mode not in _PAD_MODES:
        raise ValueError(f"mode must be one of {sorted(_PAD_MODES)}, got {mode!r}")
    h, w = img.shape[-3], img.shape[-2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return img, (h, w)
    y = F.pad(_nchw(img), (0, pw, 0, ph), mode=_PAD_MODES[mode])
    return _nhwc(y, tuple(img.shape[:-3])), (h, w)
