"""Evaluation CLI (reference: evaluate.py:18-37 flags, :326-381 flow).

    python -m image_enhancement_deglaring_tpu_torch.cli.evaluate \
        --data_dir SD1/val --model_path deploy/models/best_model.onnx [--device cuda]

The same flags, defaults, printed lines and ``evaluation_results.txt`` as
the JAX CLI, plus ``--device`` (default ``cuda``; without a card that
raises unless ``--device cpu`` is given). ``--model`` takes every family,
from ``.onnx``, ``.pth``/``.pt``, ``.npz`` or a checkpoint directory.
``--n_devices N`` evaluates over N ranks started from this command
(``parallel.distributed.launch_local``: one per card, clamped to the cards
there are; with ``--device cpu``, N CPU processes under Gloo), each
running its rows of every batch; rank 0 prints and writes the results.
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


def _artifact_type(args) -> str:
    """The artifact's format from its extension (reference:
    evaluate.py:338-345); an undeterminable path exits."""
    lower = args.model_path.lower()
    if lower.endswith(".onnx"):
        return "onnx"
    if lower.endswith((".pth", ".pt")):
        return "pth"
    if lower.endswith(".npz") or os.path.isdir(args.model_path):
        return "ckpt"
    raise SystemExit(
        f"cannot determine the artifact format of {args.model_path}: "
        "the loader dispatches on extension (.onnx / .pth / .npz / "
        "orbax checkpoint directory) — rename the artifact accordingly")


def main(argv=None):
    args = parse_args(argv)
    import torch

    from .._device import resolve_device
    from ..parallel import distributed

    resolve_device(args.device)
    _artifact_type(args)  # a bad path fails here, before any rank starts
    available = (torch.cuda.device_count() if torch.device(args.device).type == "cuda"
                 else max(args.n_devices, 1))
    n_dev = min(max(args.n_devices, 1), available)
    if args.n_devices > available:
        print(f"requested --n_devices {args.n_devices}, but only {available} available; "
              f"using {n_dev}")
    if n_dev > 1:
        distributed.launch_local(_evaluate, n_dev, args, device=args.device)
    else:
        _evaluate(args)


def _evaluate(args) -> None:
    """The evaluation of one process: alone, or one rank of a process group."""
    import torch

    from ..data import GlareRemovalDataset, list_image_paths
    from ..data.dataset import _Loader
    from ..eval import evaluate, load_model_for_eval, write_results_file
    from ..parallel import distributed
    from ..utils import set_seed

    mesh = (distributed.global_mesh(device=args.device)
            if distributed.process_count() > 1 else None)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    device = args.device if mesh is None else mesh.device
    set_seed(args.seed)

    model_type = _artifact_type(args)
    if args.model_type is not None and args.model_type != model_type:
        say(f"Model path implies {model_type!r}; overriding --model_type {args.model_type!r}")
    say(f"Evaluating {model_type.upper()} model from {args.model_path}")

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model, _params = load_model_for_eval(args.model_path, model_arch=args.model,
                                         compute_dtype=dtype, device=device)

    paths = list_image_paths(args.data_dir)
    if not paths:
        raise SystemExit(f"No images found in {args.data_dir}")
    say(f"Found {len(paths)} validation images in {args.data_dir}")
    ds = GlareRemovalDataset(paths, image_size=args.image_size, seed=args.seed,
                             augment="none", cache_images=False,
                             num_workers=args.num_workers)
    loader = _Loader(ds, args.batch_size, shuffle=False, drop_last=False,
                     seed=args.seed, num_workers=args.num_workers)

    metrics = evaluate(
        model, loader, device=device,
        save_visualizations=args.save_visualizations,
        visualizations_dir=args.visualizations_dir,
        max_vis_samples=args.max_vis_samples, batch_size=args.batch_size, mesh=mesh,
    )
    if mesh is not None and mesh.rank != 0:
        return
    print(f"Evaluation on {metrics['num_samples']} samples:")
    print(f"L1 Loss: {metrics['l1_loss']:.4f}")
    print(f"PSNR: {metrics['psnr']:.2f} dB")
    print(f"SSIM: {metrics['ssim']:.4f}")
    out = write_results_file(metrics, args.model_path, args.data_dir, model_type)
    print(f"Evaluation completed. Results saved to {out}")


if __name__ == "__main__":
    main()
