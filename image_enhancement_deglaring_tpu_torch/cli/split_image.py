"""Triptych splitter CLI (reference: scripts/split_image.py:7-74).

    python -m image_enhancement_deglaring_tpu_torch.cli.split_image strip.png [-o OUT_DIR]

Splits a [ground-truth | glared | mask] strip into three PNGs named
{base}_ground_truth.png / {base}_glared.png / {base}_mask.png, as the JAX
CLI does with PIL: the first two thirds are width // 3 wide, the last
takes the remainder. The port reads PNG with its own codec and JPEG with
its own decoder (``data.jpeg``), into the pixels PIL reads, and writes
each crop as a PNG under the row filters PIL's encoder picks.
"""

from __future__ import annotations

import argparse
import os
import sys


def split_image(image_path: str, output_dir: str | None = None) -> bool:
    from ..data.png import encode_png
    from ..serve.imaging import decode_image

    output_dir = output_dir or (os.path.dirname(image_path) or ".")
    os.makedirs(output_dir, exist_ok=True)
    try:
        with open(image_path, "rb") as f:
            data = f.read()
        img = decode_image(data)
        if img.mode not in ("L", "LA", "RGB", "RGBA"):
            raise ValueError(f"mode {img.mode}: the port writes 8-bit L, LA, RGB "
                             "and RGBA PNGs only")
    except Exception as e:
        print(f"Error opening image: {e}")
        return False

    base = os.path.splitext(os.path.basename(image_path))[0]
    height, width = img.pixels.shape[:2]
    part = width // 3
    names = ("ground_truth", "glared", "mask")
    print("Images saved to:")
    for i, name in enumerate(names):
        crop = img.pixels[:, part * i:part * (i + 1) if i < 2 else width]
        path = os.path.join(output_dir, f"{base}_{name}.png")
        with open(path, "wb") as f:
            f.write(encode_png(crop, filter_type="adaptive"))
        print(f"  {name.replace('_', ' ').capitalize()}: {path}")
    return True


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Split a combined image into ground truth, glared image, and glare mask."
    )
    p.add_argument("image_path")
    p.add_argument("--output-dir", "-o", default=None)
    args = p.parse_args(argv)
    if not os.path.exists(args.image_path):
        print(f"Error: Image file not found: {args.image_path}")
        return 1
    return 0 if split_image(args.image_path, args.output_dir) else 1


if __name__ == "__main__":
    sys.exit(main())
