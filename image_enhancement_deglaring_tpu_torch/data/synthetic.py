"""Synthetic SD1-format data generator.

Counterpart of ``image_enhancement_deglaring_tpu.data.synthetic``, with
the same numpy ``Generator`` stream, so one seed gives both packages the
same arrays. Samples honor the SD1 data contract: (size, 3*size) RGBA
PNGs laid out [ground-truth | glared | mask], document-like pages (light
paper, dark text-ish strokes) with additive Gaussian glare blobs. Files
are written with the port's own PNG codec (``data.png``).
"""

from __future__ import annotations

import os

import numpy as np

from .png import write_png


def _document_page(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Grayscale 'document': light background with dark line strokes."""
    page = np.full((h, w), 235.0, dtype=np.float32)
    page += rng.normal(0, 3.0, (h, w))
    n_lines = int(rng.integers(15, 30))
    for _ in range(n_lines):
        y = int(rng.integers(10, h - 16))
        x0 = int(rng.integers(5, w // 3))
        x1 = int(rng.integers(w // 2, w - 5))
        thickness = int(rng.integers(2, 5))
        x = x0  # broken "words"
        while x < x1:
            seg = int(rng.integers(8, 40))
            gap = int(rng.integers(4, 15))
            page[y : y + thickness, x : min(x + seg, x1)] = rng.uniform(20, 80)
            x += seg + gap
    return np.clip(page, 0, 255)


def _glare_field(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Additive glare: a few smooth Gaussian blobs, values in [0, 255]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    glare = np.zeros((h, w), dtype=np.float32)
    for _ in range(int(rng.integers(1, 4))):
        cy = rng.uniform(0.1 * h, 0.9 * h)
        cx = rng.uniform(0.1 * w, 0.9 * w)
        sy = rng.uniform(0.08, 0.25) * h
        sx = rng.uniform(0.08, 0.25) * w
        amp = rng.uniform(120, 220)
        glare += amp * np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
    return np.clip(glare, 0, 255)


def make_triptych(rng: np.random.Generator, size: int = 512) -> np.ndarray:
    """One RGBA (size, 3*size, 4) uint8 triptych [gt | glared | mask]."""
    gt = _document_page(rng, size, size)
    glare = _glare_field(rng, size, size)
    glared = np.clip(gt + glare, 0, 255)
    mask = np.clip(glare * 1.2, 0, 255)

    trip = np.concatenate([gt, glared, mask], axis=1).astype(np.uint8)
    return np.stack([trip, trip, trip, np.full_like(trip, 255)], axis=-1)


def generate_synthetic_sd1(out_dir: str, *, n_train: int = 16, n_val: int = 4,
                           size: int = 512, seed: int = 0) -> dict[str, list[str]]:
    """Write an SD1-shaped dataset tree {out_dir}/train, {out_dir}/val."""
    rng = np.random.default_rng(seed)
    written: dict[str, list[str]] = {}
    for split, n in (("train", n_train), ("val", n_val)):
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        paths = []
        for i in range(n):
            path = os.path.join(d, f"synthetic_{i:04d}.png")
            write_png(path, make_triptych(rng, size))
            paths.append(path)
        written[split] = paths
    return written
