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
on the device.

Data parallelism, one process per device (``parallel.distributed``):
``--n_devices N`` starts N ranks on this machine from this command (one
per card, clamped to the cards there are; with ``--device cpu``, N CPU
processes under Gloo); ``--distributed`` joins a process group with
``--coordinator_address host:port --num_processes N --process_id I`` (or
torchrun's variables), one command per process. ``--batch_size`` is the
global batch and must divide by the ranks; rank 0 writes the logs and
checkpoints.
"""

from __future__ import annotations

import argparse
import os
import sys


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
                   help="data-parallel devices (0 = all local): one process per device")
    p.add_argument("--distributed", action="store_true",
                   help="join a process group (NCCL on cuda, Gloo on cpu) and train "
                        "data-parallel over every rank; run the same command once per "
                        "process — each feeds its slice of every batch, rank 0 writes "
                        "checkpoints/logs")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (or torchrun's MASTER_ADDR/MASTER_PORT)")
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


def main(argv=None):
    args = parse_args(argv)
    if args.use_amp and args.compute_dtype == "float32":
        raise SystemExit("--use_amp requests mixed precision (bf16) but --compute_dtype "
                         "float32 forbids it — drop one")
    if args.model != "basic" and args.remat:
        # only LightweightUNet has block rematerialization: checked before
        # any decode, not silently dropped
        raise SystemExit("--remat is supported only for --model basic")
    from ..utils.envfile import load_dotenv

    load_dotenv()  # reference parity: .env at train start (optimized_train.py:18-19)
    from .._device import resolve_device
    from ..parallel import distributed

    resolve_device(args.device)
    if args.distributed:
        distributed.initialize(coordinator_address=args.coordinator_address,
                               num_processes=args.num_processes, process_id=args.process_id,
                               device=args.device)
    elif any(a is not None for a in (args.coordinator_address, args.num_processes,
                                     args.process_id)):
        # without this, N hosts launched with coordinator flags but a
        # forgotten --distributed would run N independent trainings
        # writing one output_dir
        raise SystemExit("--coordinator_address/--num_processes/--process_id require "
                         "--distributed (refusing to fall back to an independent "
                         "single-host run)")
    if args.distributed:
        world = distributed.process_count()
        # what the runtime resolved to: N independent "distributed" runs
        # writing one output_dir are worse than a loud warning
        print(f"Distributed runtime: {world} process(es), {world} global device(s)")
        if world == 1:
            print("WARNING: --distributed resolved to a SINGLE process. If this is one host "
                  "of several, the coordinator was not given — pass --coordinator_address/"
                  "--num_processes/--process_id explicitly (explicit arguments fail loudly "
                  "instead of degrading).", file=sys.stderr)
        if args.n_devices > 1 or (world > 1 and args.n_devices):
            raise SystemExit("--distributed spans the global mesh; --n_devices applies to "
                             "single-host runs only")
        if args.batch_size % world:
            raise SystemExit(f"--batch_size {args.batch_size} (global) must divide by "
                             f"{world} global devices")
        try:
            _train(args)
        finally:
            distributed.shutdown()
        return
    # clamp the request to the devices there are before checking the batch
    # against it
    available = distributed.local_device_count(args.device, args.n_devices)
    n_dev = min(args.n_devices or available, available)
    if args.n_devices and args.n_devices > available:
        print(f"requested --n_devices {args.n_devices}, but only {available} available; "
              f"using {n_dev}")
    if n_dev > 1:
        if args.batch_size % n_dev:
            raise SystemExit(f"--batch_size {args.batch_size} must divide by {n_dev} devices")
        distributed.launch_local(_train, n_dev, args, device=args.device)
    else:
        _train(args)


def _train(args) -> None:
    """The run of one process: alone, or one rank of a process group."""
    import numpy as np
    import torch

    from .._device import resolve_device
    from ..data import make_dataloaders
    from ..models import (EnhancedUNet, LightweightUNet, OptimizedUNet, count_parameters,
                          get_model_size_mb)
    from ..parallel import distributed
    from ..train import PreemptionGuard, save_checkpoint, train_model
    from ..utils import ExperimentLogger, flatten_tree, set_seed

    mesh = (distributed.global_mesh(device=args.device)
            if distributed.process_count() > 1 or args.distributed else None)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    is_host0 = mesh is None or mesh.rank == 0
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
            if is_host0:
                print("--resident_data: running the optimized augmentation stack on the "
                      "device (same distributions, the device generator's stream)")
            augment = "device"
    device_augment = augment == "device"
    train_loader, val_loader = make_dataloaders(
        args.data_dir, batch_size=args.batch_size, val_split=args.val_split, seed=args.seed,
        image_size=args.image_size, num_workers=args.num_workers,
        cache_images=args.cache_images, augment="none" if device_augment else augment)
    if is_host0:
        print(f"Training samples: {train_loader.num_samples}, "
              f"Validation samples: {val_loader.num_samples}")
    if mesh is not None and not args.resident_data:
        # each rank feeds its slice of every (identically seeded) batch; the
        # resident loaders stay global, every rank caching the whole set
        train_loader = distributed.LocalSliceLoader(train_loader)
        val_loader = distributed.LocalSliceLoader(val_loader)

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    # knobs off: on the card GroupNorm+SiLU trains through the kernel pair
    # (ops.fused_kernels.gn_silu_train); K3 is forward-only
    if args.model == "enhanced":
        model = EnhancedUNet(dtype=dtype, generator=generator)
    elif args.model == "optimized":
        model = OptimizedUNet(dtype=dtype, generator=generator)
    else:
        model = LightweightUNet(dtype=dtype, remat=args.remat, generator=generator)

    # rank 0 owns the metrics stream
    logger = ExperimentLogger(os.path.join(args.output_dir, "logs"), use_wandb=args.use_wandb,
                              project=args.wandb_project, entity=args.wandb_entity,
                              config=vars(args)) if is_host0 else None
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
            resident_segments=args.resident_segments, device=device, mesh=mesh)
    if guard.preempt_checkpoint is not None:
        # the exact-resume checkpoint is on disk; skip the final artifacts
        # (the grace window may not cover them) and exit 0
        if is_host0:
            logger.finish()
            print(f"Training preempted; resume with --resume {guard.preempt_checkpoint}",
                  flush=True)
        return
    if not is_host0:
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
