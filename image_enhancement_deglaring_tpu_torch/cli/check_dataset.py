"""Dataset validator CLI (reference: scripts/check_png.py).

    python -m image_enhancement_deglaring_tpu_torch.cli.check_dataset SD1 \
        [--width 1536 --height 512]

The JAX CLI's flags and report, on the port's validator (``data.validate``,
the port's PNG codec instead of PIL).
"""

import argparse
import os
import sys

from ..data.validate import main as validate_main


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Validate an SD1 dataset directory (triptych dimensions, "
                    "RGBA mode, gray value range)")
    p.add_argument("data_dir", nargs="?", default="SD1",
                   help="dataset root (default: SD1)")
    # the reference hardcodes the SD1 contract (check_png.py:9); these
    # let the same validator gate synthetic / re-scaled datasets too
    p.add_argument("--width", type=int, default=1536,
                   help="required triptych width (default: SD1's 1536)")
    p.add_argument("--height", type=int, default=512,
                   help="required triptych height (default: SD1's 512)")
    args = p.parse_args(argv)
    if not os.path.isdir(args.data_dir):
        print(f"Error: dataset directory not found: {args.data_dir}")
        return 1
    return validate_main(args.data_dir, required_width=args.width,
                         required_height=args.height)


if __name__ == "__main__":
    sys.exit(main())
