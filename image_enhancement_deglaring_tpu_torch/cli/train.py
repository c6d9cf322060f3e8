"""Training CLI, the port's counterpart of ``image_enhancement_deglaring_tpu.cli.train``.

    python -m image_enhancement_deglaring_tpu_torch.cli.train --data_dir DIR \\
        [--output_dir ./models] [--epochs 50] [--batch_size 32] ... [--device cuda]

The same flags and defaults as the JAX CLI, plus ``--device`` (default
``cuda``; without a card that raises unless ``--device cpu`` is given).
It writes ``best_model/`` and ``checkpoint_epoch_N/`` during the run, then
``final_model/`` and ``model_weights.npz`` (the best parameters under the
JAX package's flat names, nested under ``params/`` and ``batch_stats/``
for EnhancedUNet), and ``logs/metrics.jsonl``. ``--resident_data`` caches
the decoded set on the device and augments there (``--augment optimized``
becomes ``device``); ``--augment device`` alone augments streamed batches
on the device. Flags of parts the port does not have yet raise and name
the ROADMAP Queue 1 item that brings them.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train glare removal model")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./models")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.002362532125818593)
    p.add_argument("--val_split", type=float, default=0.2)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--model", type=str, default="basic",
                   choices=["basic", "enhanced", "optimized"])
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default="image-deglaring")
    p.add_argument("--wandb_entity", type=str, default=None)
    p.add_argument("--use_amp", action="store_true",
                   help="mixed precision = bf16 compute (the default); conflicts with "
                        "--compute_dtype float32")
    p.add_argument("--prefetch_factor", type=int, default=2,
                   help="batches decoded + copied to the device ahead of the step")
    p.add_argument("--persistent_workers", action="store_true",
                   help="accepted for command compatibility (the threaded loader is "
                        "always persistent)")
    p.add_argument("--weight_decay", type=float, default=0.00006753784966611083)
    p.add_argument("--clip_grad_norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_images_every", type=int, default=5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--validation_metrics_every", type=int, default=5)
    p.add_argument("--cache_images", action="store_true")
    p.add_argument("--augment", type=str, default="optimized",
                   choices=["optimized", "heavy", "none", "device"])
    p.add_argument("--resident_data", action="store_true")
    p.add_argument("--resident_segments", type=int, default=8)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel devices (0 = all local; the port trains on one)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint directory to resume from")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--watch_every", type=int, default=0,
                   help="log parameter histograms every N epochs (0 = off)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch profiler trace of the first epoch's first steps "
                        "here (TensorBoard / chrome://tracing)")
    p.add_argument("--profile_steps", type=int, default=5,
                   help="number of train steps to trace when --profile_dir is set")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    """Flags whose parts of the port do not exist yet, with their queue item."""
    todo = [
        (args.distributed or any(a is not None for a in (
            args.coordinator_address, args.num_processes, args.process_id)),
         "--distributed (and its coordinator flags)", 13),
        (args.n_devices > 1, f"--n_devices {args.n_devices}", 13),
    ]
    for bad, flag, item in todo:
        if bad:
            raise SystemExit(f"{flag} is not ported yet (ROADMAP Queue 1 item {item})")


def main(argv=None):
    args = parse_args(argv)
    if args.use_amp and args.compute_dtype == "float32":
        raise SystemExit("--use_amp requests mixed precision (bf16) but --compute_dtype "
                         "float32 forbids it — drop one")
    if args.model != "basic" and args.remat:
        # only LightweightUNet has block rematerialization: checked before
        # any decode, not silently dropped
        raise SystemExit("--remat is supported only for --model basic")
    _refuse_unported(args)
    from ..utils.envfile import load_dotenv

    load_dotenv()  # reference parity: .env at train start (optimized_train.py:18-19)
    import numpy as np
    import torch

    from .._device import resolve_device
    from ..data import make_dataloaders
    from ..models import (EnhancedUNet, LightweightUNet, OptimizedUNet, count_parameters,
                          get_model_size_mb)
    from ..train import PreemptionGuard, save_checkpoint, train_model
    from ..utils import ExperimentLogger, flatten_tree, set_seed

    device = resolve_device(args.device)
    generator = set_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)

    # --augment device: the loaders only decode; the optimized stack runs
    # on the device inside the step
    augment = args.augment
    if args.resident_data:
        if augment == "heavy":
            raise SystemExit("--resident_data caches raw pixels on the device; the heavy "
                             "stack is host-only (cv2 warps/CLAHE). Use --augment "
                             "optimized|device|none.")
        if augment == "optimized":
            print("--resident_data: running the optimized augmentation stack on the "
                  "device (same distributions, the device generator's stream)")
            augment = "device"
    device_augment = augment == "device"
    train_loader, val_loader = make_dataloaders(
        args.data_dir, batch_size=args.batch_size, val_split=args.val_split, seed=args.seed,
        image_size=args.image_size, num_workers=args.num_workers,
        cache_images=args.cache_images, augment="none" if device_augment else augment)
    print(f"Training samples: {train_loader.num_samples}, "
          f"Validation samples: {val_loader.num_samples}")

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    # the kernels are forward-only: training runs the composition
    if args.model == "enhanced":
        model = EnhancedUNet(dtype=dtype, generator=generator)
    elif args.model == "optimized":
        model = OptimizedUNet(dtype=dtype, generator=generator)
    else:
        model = LightweightUNet(dtype=dtype, remat=args.remat, generator=generator)

    logger = ExperimentLogger(os.path.join(args.output_dir, "logs"), use_wandb=args.use_wandb,
                              project=args.wandb_project, entity=args.wandb_entity,
                              config=vars(args))
    guard = PreemptionGuard()
    with guard:
        best_params, best_model_state, best_val, _state = train_model(
            model, train_loader, val_loader, epochs=args.epochs, lr=args.lr,
            weight_decay=args.weight_decay, clip_grad_norm=args.clip_grad_norm,
            patience=args.patience, output_dir=args.output_dir, save_every=args.save_every,
            validation_metrics_every=args.validation_metrics_every,
            log_images_every=args.log_images_every, seed=args.seed, logger=logger,
            resume_from=args.resume, watch_every=args.watch_every,
            profile_dir=args.profile_dir, profile_steps=args.profile_steps,
            device_augment=device_augment, resident=args.resident_data,
            prefetch=args.prefetch_factor, preempt_guard=guard,
            resident_segments=args.resident_segments, device=device)
    if guard.preempt_checkpoint is not None:
        # the exact-resume checkpoint is on disk; skip the final artifacts
        # (the grace window may not cover them) and exit 0
        logger.finish()
        print(f"Training preempted; resume with --resume {guard.preempt_checkpoint}",
              flush=True)
        return

    # best_model_state holds EnhancedUNet's BatchNorm statistics of the
    # same epoch: final_model must stay loadable
    save_checkpoint(os.path.join(args.output_dir, "final_model"), params=best_params,
                    model_state=best_model_state, val_loss=best_val)
    weights_tree = ({"params": best_params, "batch_stats": best_model_state["batch_stats"]}
                    if "batch_stats" in best_model_state else best_params)
    np.savez(os.path.join(args.output_dir, "model_weights.npz"), **flatten_tree(weights_tree))
    print(f"Training completed. Best validation loss: {best_val:.4f}")
    print(f"Final model size: {get_model_size_mb(best_params):.2f} MB "
          f"({count_parameters(best_params):,} parameters)")
    logger.finish()


if __name__ == "__main__":
    main()
