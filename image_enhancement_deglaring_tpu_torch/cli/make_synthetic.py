"""Synthetic SD1 dataset generator CLI.

    python -m image_enhancement_deglaring_tpu_torch.cli.make_synthetic --out_dir SD1 [--size 512]

The JAX CLI's flags and output on the port's ``generate_synthetic_sd1``:
the same seeded triptychs (1536x512 RGBA [ground-truth | glared | mask] at
the default size, reference: scripts/check_png.py:9), written by the port's
PNG codec. The real SD1 dataset is not redistributable.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a synthetic SD1-format dataset")
    p.add_argument("--out_dir", type=str, default="SD1")
    p.add_argument("--n_train", type=int, default=64)
    p.add_argument("--n_val", type=int, default=16)
    p.add_argument("--size", type=int, default=512,
                   help="per-panel size (panels are size x size; files are 3*size wide)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..data import generate_synthetic_sd1

    written = generate_synthetic_sd1(args.out_dir, n_train=args.n_train,
                                     n_val=args.n_val, size=args.size,
                                     seed=args.seed)
    print(f"Wrote {len(written['train'])} train + {len(written['val'])} val "
          f"triptychs under {args.out_dir}/")


if __name__ == "__main__":
    main()
