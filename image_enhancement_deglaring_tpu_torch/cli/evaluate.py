"""Evaluation CLI (reference: evaluate.py:18-37 flags, :326-381 flow).

    python -m image_enhancement_deglaring_tpu_torch.cli.evaluate \
        --data_dir SD1/val --model_path deploy/models/best_model.onnx [--device cuda]

The same flags, defaults, printed lines and ``evaluation_results.txt`` as
the JAX CLI, plus ``--device`` (default ``cuda``; without a card that
raises unless ``--device cpu`` is given). ``--model`` takes every family.
``--n_devices > 1`` (ROADMAP.md Queue 1 item 13) exits before the model
loads; a ``.pth`` artifact raises in ``load_model_for_eval`` (item 12).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate glare removal model on validation set")
    p.add_argument("--data_dir", type=str, default="SD1/val")
    p.add_argument("--model_path", type=str, default="./best_model.ckpt",
                   help=".onnx, .pth, or orbax checkpoint directory")
    # reference choices are optimized/lightweight (reference: evaluate.py:24);
    # "auto" (artifact-based detection) and "enhanced" are supersets
    p.add_argument("--model", type=str,
                   choices=["auto", "optimized", "lightweight", "enhanced"],
                   default="auto")
    # like the reference (evaluate.py:338-345), the artifact extension wins
    # when it contradicts this flag (with a printed note); the loader
    # dispatches on extension, so an undeterminable path is an error, not a
    # silently mislabeled run
    p.add_argument("--model_type", type=str, choices=["pth", "onnx", "ckpt"],
                   default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_visualizations", action="store_true")
    p.add_argument("--visualizations_dir", type=str, default="./eval_visualizations")
    p.add_argument("--max_vis_samples", type=int, default=10)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["bfloat16", "float32"])
    p.add_argument("--n_devices", type=int, default=1,
                   help="shard eval batches across this many devices")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.n_devices > 1:
        raise SystemExit(f"--n_devices {args.n_devices} is not ported yet "
                         "(ROADMAP Queue 1 item 13)")
    import torch

    from ..data import GlareRemovalDataset, list_image_paths
    from ..data.dataset import _Loader
    from ..eval import evaluate, load_model_for_eval, write_results_file
    from ..utils import set_seed

    set_seed(args.seed)

    # extension-based autodetect (reference: evaluate.py:338-345)
    lower = args.model_path.lower()
    if lower.endswith(".onnx"):
        detected = "onnx"
    elif lower.endswith((".pth", ".pt")):
        detected = "pth"
    elif lower.endswith(".npz") or os.path.isdir(args.model_path):
        detected = "ckpt"
    else:
        raise SystemExit(
            f"cannot determine the artifact format of {args.model_path}: "
            "the loader dispatches on extension (.onnx / .pth / .npz / "
            "orbax checkpoint directory) — rename the artifact accordingly")
    if args.model_type is not None and args.model_type != detected:
        print(f"Model path implies {detected!r}; overriding "
              f"--model_type {args.model_type!r}")
    model_type = detected
    print(f"Evaluating {model_type.upper()} model from {args.model_path}")

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model, _params = load_model_for_eval(args.model_path, model_arch=args.model,
                                         compute_dtype=dtype, device=args.device)

    paths = list_image_paths(args.data_dir)
    if not paths:
        raise SystemExit(f"No images found in {args.data_dir}")
    print(f"Found {len(paths)} validation images in {args.data_dir}")
    ds = GlareRemovalDataset(paths, image_size=args.image_size, seed=args.seed,
                             augment="none", cache_images=False,
                             num_workers=args.num_workers)
    loader = _Loader(ds, args.batch_size, shuffle=False, drop_last=False,
                     seed=args.seed, num_workers=args.num_workers)

    metrics = evaluate(
        model, loader, device=args.device,
        save_visualizations=args.save_visualizations,
        visualizations_dir=args.visualizations_dir,
        max_vis_samples=args.max_vis_samples, batch_size=args.batch_size,
    )
    print(f"Evaluation on {metrics['num_samples']} samples:")
    print(f"L1 Loss: {metrics['l1_loss']:.4f}")
    print(f"PSNR: {metrics['psnr']:.2f} dB")
    print(f"SSIM: {metrics['ssim']:.4f}")
    out = write_results_file(metrics, args.model_path, args.data_dir, model_type)
    print(f"Evaluation completed. Results saved to {out}")


if __name__ == "__main__":
    main()
