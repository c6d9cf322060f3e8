"""Deterministic host-side augmentation.

Counterpart of ``image_enhancement_deglaring_tpu.data.augment`` with the
same ``rng`` call order, so a per-index seed gives both packages the same
arrays. ``optimized_augment`` is the production stack: HorizontalFlip
(p=.5) on image and target, then OneOf(p=.5) of brightness/contrast
(w=.8) or Gaussian noise (w=.2) on the image only.
"""

from __future__ import annotations

import numpy as np


def _brightness_contrast(img: np.ndarray, rng: np.random.Generator,
                         limit: float = 0.2) -> np.ndarray:
    alpha = 1.0 + rng.uniform(-limit, limit)  # contrast
    beta = rng.uniform(-limit, limit)  # brightness (by max, float images)
    return np.clip(img * alpha + beta, 0.0, 1.0).astype(np.float32)


def _gauss_noise(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    # albumentations GaussNoise default var_limit=(10, 50) on the 0-255 scale
    var = rng.uniform(10.0, 50.0) / (255.0 ** 2)
    noise = rng.normal(0.0, np.sqrt(var), img.shape).astype(np.float32)
    return np.clip(img + noise, 0.0, 1.0).astype(np.float32)


def optimized_augment(image: np.ndarray, target: np.ndarray, rng: np.random.Generator):
    """Light augmentation used by the production training path."""
    if rng.random() < 0.5:
        image = image[:, ::-1].copy()
        target = target[:, ::-1].copy()
    if rng.random() < 0.5:
        if rng.random() < 0.8:
            image = _brightness_contrast(image, rng)
        else:
            image = _gauss_noise(image, rng)
    return image, target


def heavy_augment(image: np.ndarray, target: np.ndarray, rng: np.random.Generator):
    """The full stack (affine warps, blur, CLAHE) needs cv2's warps and
    CLAHE, which the port does not have yet."""
    raise NotImplementedError(
        "heavy augmentation (cv2 affine warps, blur, CLAHE) is not ported yet "
        "(ROADMAP Queue 1 item 17); use augment='optimized' or 'none'")
