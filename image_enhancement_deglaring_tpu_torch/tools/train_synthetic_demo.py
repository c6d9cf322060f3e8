"""End to end on synthetic data: synthesize an SD1-format dataset, train
the production U-Net on the card, evaluate, and report PSNR/SSIM against
the identity baseline.

    python -m image_enhancement_deglaring_tpu_torch.tools.train_synthetic_demo \
        [--data_dir $TMPDIR/sd1_synthetic] [--n_train 96] [--n_val 24] \
        [--epochs 100] [--batch_size 8] [--size 512] [--resident] [--device cuda]

Counterpart of the JAX package's ``scripts/train_synthetic_demo.py``, with
its flags and defaults (the data directory under ``$TMPDIR``), plus
``--device`` (default cuda; without a card that raises unless ``--device
cpu`` is given). The dataset is reused when its manifest names the same
counts and size, else regenerated (seed 0). Training is bf16 with the
optimized host augmentation, or ``--resident`` (the set cached on the
device, device augmentation). The final evaluation reads the held-out
``val/`` when ``--n_val`` made one, else the 80/20 split's val part.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    default_dir = os.path.join(tempfile.gettempdir(), "sd1_synthetic")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", default=default_dir)
    p.add_argument("--out_dir", default=os.path.join(default_dir, "models"))
    p.add_argument("--n_train", type=int, default=96)
    p.add_argument("--n_val", type=int, default=24)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--patience", type=int, default=40)
    p.add_argument("--size", type=int, default=512,
                   help="square image size (512 = the SD1 contract)")
    p.add_argument("--resident", action="store_true",
                   help="cache the decoded dataset on the device and augment there")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    args = p.parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..data import generate_synthetic_sd1, make_dataloaders, make_eval_loader
    from ..eval import evaluate
    from ..modelio.params_import import load_jax_params
    from ..models import LightweightUNet
    from ..ops.metrics import batched_psnr_ssim
    from ..train import train_model

    device = resolve_device(args.device)
    train_dir = os.path.join(args.data_dir, "train")
    # reuse only a dataset made with every same generation parameter
    manifest_path = os.path.join(args.data_dir, "dataset_manifest.json")
    wanted = {"n_train": args.n_train, "n_val": args.n_val, "size": args.size}
    have = None
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            have = json.load(f)
    n_existing = (len([f for f in os.listdir(train_dir) if f.endswith(".png")])
                  if os.path.isdir(train_dir) else 0)
    if have != wanted or n_existing != args.n_train:
        if n_existing:
            print(f"dataset at {args.data_dir} has {n_existing} train triptychs, "
                  f"want {args.n_train}; regenerating")
            for sub in ("train", "val"):
                shutil.rmtree(os.path.join(args.data_dir, sub), ignore_errors=True)
        print(f"Generating synthetic SD1 ({args.n_train}+{args.n_val} triptychs)...")
        generate_synthetic_sd1(args.data_dir, n_train=args.n_train, n_val=args.n_val,
                               size=args.size, seed=0)
        with open(manifest_path, "w") as f:
            json.dump(wanted, f)

    train_loader, val_loader = make_dataloaders(
        train_dir, batch_size=args.batch_size, val_split=0.2, seed=42, image_size=args.size,
        cache_images=True, augment="none" if args.resident else "optimized")
    print(f"train/val samples: {train_loader.num_samples}/{val_loader.num_samples}")

    xs, ys = next(iter(val_loader))
    p0, s0 = batched_psnr_ssim(torch.from_numpy(xs), torch.from_numpy(ys))
    print(f"identity baseline: PSNR {float(p0.mean()):.2f} dB, SSIM {float(s0.mean()):.4f}")

    model = LightweightUNet(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(42))
    t0 = time.time()
    best_params, _best_ms, best_val, _ = train_model(
        model, train_loader, val_loader, epochs=args.epochs, output_dir=args.out_dir,
        save_every=1000, validation_metrics_every=25, progress=False,
        patience=args.patience, resident=args.resident, device_augment=args.resident,
        device=device)
    print(f"trained in {time.time() - t0:.0f}s; best val L1 {best_val:.4f}")

    val_dir = os.path.join(args.data_dir, "val")
    if args.n_val > 0 and os.path.isdir(val_dir):
        heldout = make_eval_loader(val_dir, batch_size=args.batch_size, seed=42,
                                   image_size=args.size, cache_images=True)
        eval_loader, which = heldout, f"held-out val/ ({heldout.num_samples})"
    else:
        eval_loader, which = val_loader, "train-split val"
    load_jax_params(model, best_params)  # the best epoch's weights
    metrics = evaluate(model, eval_loader, device=device, batch_size=args.batch_size,
                       progress=False)
    print(f"final ({which}): L1 {metrics['l1_loss']:.4f}, "
          f"PSNR {metrics['psnr']:.2f} dB, SSIM {metrics['ssim']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
