"""Dataset contract validator (reference: scripts/check_png.py:9-132).

Counterpart of ``image_enhancement_deglaring_tpu.data.validate`` on the
port's PNG codec instead of PIL. Checks every image under
{data_dir}/train and {data_dir}/val for:
- dimensions == required (1536x512 by default),
- RGBA mode (4 channels): PIL's mode, read from the IHDR colour type and
  bit depth by the rules ``data.png`` follows,
- fully decodable pixel data (truncated/corrupt files).

A JPEG is read as far as its frame header: its SOF marker gives the size
and the mode PIL would open it in (1 component "L", 3 "RGB", 4 "CMYK"),
so it is flagged as not RGBA, as the JAX validator flags it; its pixels
are not decoded until the port has a JPEG decoder (ROADMAP.md Queue 1
item 16), so a truncated JPEG is not reported under invalid pixels.
"""

from __future__ import annotations

import struct
from pathlib import Path

_JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}
# start-of-frame markers: every 0xC0-0xCF but DHT (C4), JPG (C8) and DAC (CC)
_SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_header(data: bytes) -> tuple[int, int, str]:
    """(width, height, PIL's mode) from a JPEG's frame header."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # no length field
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker in _SOF_MARKERS:
            if pos + 10 > len(data):
                break
            height, width = struct.unpack(">HH", data[pos + 5:pos + 9])
            components = data[pos + 9]
            mode = _JPEG_MODES.get(components)
            if mode is None:
                raise ValueError(f"JPEG with {components} components")
            return width, height, mode
        if marker == 0xDA:  # start of scan before any frame header
            break
        pos += 2 + length
    raise ValueError("JPEG file has no frame header")


def check_png_dimensions(data_dir: str = "SD1", required_width: int = 1536,
                         required_height: int = 512):
    """Returns (incorrect_dimensions, invalid_channels, invalid_pixels, total)."""
    from .pipeline import list_image_paths
    from .png import decode_png_image, png_header

    data_path = Path(data_dir)
    if not data_path.is_dir():
        raise FileNotFoundError(f"Directory '{data_dir}' does not exist")

    incorrect_dimensions: list[tuple[str, int, int]] = []
    invalid_channels: list[tuple[str, str]] = []
    invalid_pixels: list[str] = []
    total = 0

    for subdir in ("train", "val"):
        sub = data_path / subdir
        if not sub.is_dir():
            continue
        # scan EXACTLY what the loader consumes (pipeline.list_image_paths:
        # recursive, any case, .png/.jpg/.jpeg) — a validator that sees a
        # narrower set than the training pipeline would report all-clear on
        # files that later break mid-epoch. Non-RGBA (incl. every JPEG,
        # which cannot carry alpha) is flagged by the mode check below.
        for png in (Path(p) for p in list_image_paths(str(sub))):
            total += 1
            rel = f"{subdir}/{png.relative_to(sub)}"
            try:
                data = png.read_bytes()
                jpeg = data[:2] == b"\xff\xd8"
                w, h, mode = jpeg_header(data) if jpeg else png_header(data)
                if (w, h) != (required_width, required_height):
                    incorrect_dimensions.append((rel, w, h))
                if mode != "RGBA":
                    invalid_channels.append((rel, mode))
                if not jpeg:
                    # the full decode: a truncated or bit-flipped file
                    # raises here, not at the header
                    decode_png_image(data)
            except Exception:
                invalid_pixels.append(rel)
    return incorrect_dimensions, invalid_channels, invalid_pixels, total


def main(data_dir: str = "SD1", required_width: int = 1536,
         required_height: int = 512) -> int:
    bad_dims, bad_chan, bad_pix, total = check_png_dimensions(
        data_dir, required_width, required_height)
    dims = f"{required_width}x{required_height}"
    print(f"Checked {total} image files in {data_dir}/train and {data_dir}/val")
    ok = True
    if bad_dims:
        ok = False
        print(f"✗ {len(bad_dims)} files with incorrect dimensions:")
        for rel, w, h in bad_dims:
            print(f"  {data_dir}/{rel}: {w}x{h} (should be {dims})")
    else:
        print(f"✓ All PNG files have the correct dimensions ({dims})")
    if bad_chan:
        ok = False
        print(f"✗ {len(bad_chan)} files with incorrect format:")
        for rel, mode in bad_chan:
            print(f"  {data_dir}/{rel}: {mode} (should be RGBA)")
    else:
        print("✓ All PNG files have the correct format (RGBA)")
    if bad_pix:
        ok = False
        print(f"✗ {len(bad_pix)} files with invalid pixel values")
    else:
        print("✓ All PNG files have valid grayscale pixel values [0-255]")
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "SD1"))
