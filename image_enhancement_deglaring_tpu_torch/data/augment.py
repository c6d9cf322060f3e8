"""Deterministic host-side augmentation.

Counterpart of ``image_enhancement_deglaring_tpu.data.augment`` with the
same ``rng`` call order, so a per-index seed gives both packages the same
arrays. ``optimized_augment`` is the production stack: HorizontalFlip
(p=.5) on image and target, then OneOf(p=.5) of brightness/contrast
(w=.8) or Gaussian noise (w=.2) on the image only. ``heavy_augment`` is
the full stack; its cv2 operations are the port's numpy copies in
``cv_ops``.
"""

from __future__ import annotations

import numpy as np

from . import cv_ops


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


def _affine(img: np.ndarray, scale: float, tx: float, ty: float, angle: float,
            interpolation: int = cv_ops.INTER_LINEAR) -> np.ndarray:
    """Rotate/scale about the image center + translate, constant-0 border
    (A.Affine's defaults: out-of-frame area is black, not mirrored)."""
    h, w = img.shape[:2]
    m = cv_ops.rotation_matrix((w / 2, h / 2), angle, scale)
    m[0, 2] += tx * w
    m[1, 2] += ty * h
    return cv_ops.warp_affine(img, m, interpolation)


def heavy_augment(image: np.ndarray, target: np.ndarray, rng: np.random.Generator):
    """The full stack (reference: src/dataset.py:96-116): rotate90 / flips /
    affine on image and target, then noise-or-blur and
    brightness/gamma/CLAHE on the image only. Returns float32 in [0, 1]."""
    # RandomRotate90(p=.5): the factor is uniform over {0,1,2,3} when it fires
    if rng.random() < 0.5:
        k = int(rng.integers(0, 4))
        if k:
            image = np.rot90(image, k).copy()
            target = np.rot90(target, k).copy()
    # HorizontalFlip(p=.5)
    if rng.random() < 0.5:
        image = image[:, ::-1].copy()
        target = target[:, ::-1].copy()
    # VerticalFlip(p=.3)
    if rng.random() < 0.3:
        image = image[::-1].copy()
        target = target[::-1].copy()
    # Affine(scale .9-1.1, translate 6.25%, rotate +-15, p=.5); the target is
    # the albumentations 'mask', warped nearest-neighbour
    if rng.random() < 0.5:
        scale = rng.uniform(0.9, 1.1)
        tx = rng.uniform(-0.0625, 0.0625)
        ty = rng.uniform(-0.0625, 0.0625)
        angle = rng.uniform(-15.0, 15.0)
        image = _affine(image, scale, tx, ty, angle)
        target = _affine(target, scale, tx, ty, angle, interpolation=cv_ops.INTER_NEAREST)
    # OneOf(noise, blur)(p=.5), image only; GaussianBlur(blur_limit=3) is ksize 3
    if rng.random() < 0.5:
        if rng.random() < 0.5:
            image = _gauss_noise(image, rng)
        else:
            image = cv_ops.gaussian_blur_3x3(image)
    # OneOf(brightness/contrast, gamma, CLAHE)(p=.5), image only
    if rng.random() < 0.5:
        pick = rng.random()
        if pick < 1 / 3:
            image = _brightness_contrast(image, rng)
        elif pick < 2 / 3:
            # RandomGamma(gamma_limit=(80, 120)): gamma = U(80,120)/100
            gamma = rng.uniform(80.0, 120.0) / 100.0
            image = np.clip(image, 0.0, 1.0) ** gamma
        else:
            image = _clahe(image, rng)
    return image.astype(np.float32), target.astype(np.float32)


def _clahe(image: np.ndarray, rng: np.random.Generator, clip_limit: float = 4.0) -> np.ndarray:
    """A.CLAHE(clip_limit=4.0, tile_grid_size=(8, 8)): the limit is drawn
    from U(1, clip_limit); CLAHE runs on the uint8 rendering and returns
    to [0, 1]."""
    limit = rng.uniform(1.0, clip_limit)
    u8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    return cv_ops.clahe_u8(u8, limit).astype(np.float32) / 255.0
