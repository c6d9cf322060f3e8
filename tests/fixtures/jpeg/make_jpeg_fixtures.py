"""Writes the JPEG fixtures of this folder and their manifest.

    python tests/fixtures/jpeg/make_jpeg_fixtures.py

The JPEGs are written by PIL (and one by cv2) from seeded numpy pages, so
that a machine without PIL (the one with the card) can hold the port's
decoder against what PIL decodes: ``manifest.json`` gives each file's PIL
mode, shape and the sha256 of ``np.asarray(PIL.Image.open(path))``, and of
its ``convert("L")``, keyed by its path under ``tests/fixtures``; it also
covers ``photo_noise.jpg``, which the JAX tests upload. ``tests/test_torch_port_jpeg.py`` checks the
manifest against PIL and the port against the manifest; it regenerates
nothing.
"""

import hashlib
import io
import json
import os

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def page(h: int, w: int, seed: int) -> np.ndarray:
    """A photographed document page: paper shading, a glare blob, rows of
    dark strokes, sensor noise; (h, w, 3) uint8 with a warm cast."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 200 + 30 * np.sin(x / w * 3) * np.cos(y / h * 2)
    img += 80 * np.exp(-(((x - w * 0.6) / (w * 0.2)) ** 2 + ((y - h * 0.4) / (h * 0.15)) ** 2))
    for r in range(int(h * 0.1), int(h * 0.9), 18):
        length = rng.integers(w // 4, int(w * 0.8))
        strokes = (np.abs(y - r) < 3) & (x > w * 0.1) & (x < w * 0.1 + length)
        img = np.where(strokes & (np.sin(x * 0.9 + r) > -0.2), 40, img)
    img = img + rng.normal(0, 2, (h, w))
    return np.clip(np.stack([img, img * 0.97 + 4, img * 0.92 + 8], -1), 0, 255).astype(np.uint8)


def pil_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


FILES = {
    # a phone photo of a page at the served size: 4:2:0, restart markers
    "page_512_420_restarts.jpg": lambda: pil_jpeg(
        Image.fromarray(page(512, 512, 0)), quality=85, subsampling=2, restart_marker_rows=1),
    # a phone camera's frame (12 MP, 4:2:0): the commonest real upload
    "page_4032x3024_420.jpg": lambda: pil_jpeg(
        Image.fromarray(page(3024, 4032, 5)), quality=85, subsampling=2),
    "page_512_progressive.jpg": lambda: pil_jpeg(
        Image.fromarray(page(512, 512, 1)), quality=85, subsampling=2, progressive=True),
    "page_1024x768_422.jpg": lambda: pil_jpeg(
        Image.fromarray(page(768, 1024, 2)), quality=75, subsampling=1),
    "page_small_cmyk_adobe.jpg": lambda: pil_jpeg(
        Image.fromarray(page(48, 64, 3)).convert("CMYK"), quality=90),
    "page_200x120_411_cv2.jpg": lambda: cv2.imencode(
        ".jpg", page(120, 200, 4), [cv2.IMWRITE_JPEG_QUALITY, 90,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes(),
}


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    manifest = {}
    files = {f"jpeg/{name}": make() for name, make in FILES.items()}
    for name, data in files.items():
        with open(os.path.join(HERE, "..", name), "wb") as f:
            f.write(data)
    with open(os.path.join(HERE, "..", "photo_noise.jpg"), "rb") as f:
        files["photo_noise.jpg"] = f.read()
    for name, data in files.items():
        with Image.open(io.BytesIO(data)) as im:
            pixels, luma = np.asarray(im), np.asarray(im.convert("L"))
            manifest[name] = {"mode": im.mode, "shape": list(pixels.shape),
                              "sha256": digest(pixels), "luma_sha256": digest(luma),
                              "bytes": len(data)}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
