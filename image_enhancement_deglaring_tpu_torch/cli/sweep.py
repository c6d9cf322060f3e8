"""Sweep CLI, the port's counterpart of ``image_enhancement_deglaring_tpu.cli.sweep``
(reference: sweep.py:23-38 flags; search space sweep.py:54-88).

    python -m image_enhancement_deglaring_tpu_torch.cli.sweep --data_dir DIR \\
        [--output_dir ./models] [--sweep_count 20] [--max_epochs 50] ... [--device cuda]

The same flags and defaults as the JAX CLI, plus ``--device`` (default
``cuda``; without a card that raises unless ``--device cpu`` is given).
It writes ``sweep_results.json``, ``sweep_journal.jsonl`` and
``best_trial_params.npz`` (the best trial's best-epoch weights under the
JAX package's flat names) into ``--output_dir``, and ``--resume DIR``
continues a preempted sweep. On the card it runs deterministic algorithms
(cuDNN's and cuBLAS's), so that a group that re-runs after a preemption
reaches the same val losses and the resumed sweep equals an uninterrupted
one. ``--parallel_trials`` caps the trials that
train at once in one group: their stacked state and activations share the
card's memory (about 0.3 GiB per trial-image of batch at 512^2 in bf16).
Several devices split each group's trial axis over one process per device
(``parallel.sweep``): ``--n_devices N`` starts N ranks on this machine
from this command (0, the default, takes every local card; a request for
more than there are is clamped; on the CPU N Gloo processes), and
``--distributed --coordinator_address H:P --num_processes N --process_id
I`` runs once per process (or under torchrun). Rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run a hyperparameter sweep for glare removal model")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./models")
    p.add_argument("--sweep_count", type=int, default=20)
    p.add_argument("--val_split", type=float, default=0.2)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--early_stop_patience", type=int, default=10,
                   help="retire a trial after this many epochs without val "
                        "improvement (reference sweep.py:35 passes the same "
                        "patience into every trial's train_model); 0 = off")
    p.add_argument("--early_stop_min_iter", type=int, default=10,
                   help="Hyperband min_iter (reference sweep.py:51)")
    p.add_argument("--eta", type=int, default=3,
                   help="successive-halving keep ratio (Hyperband eta)")
    p.add_argument("--parallel_trials", type=int, default=0,
                   help="cap trials per lock-step group (0 = whole group); bounds "
                        "the group's device memory")
    p.add_argument("--halving", type=str, default="compact", choices=["compact", "mask"],
                   help="successive-halving mode of the JAX CLI, pinned in the journal; "
                        "either shrinks the trial group (the same results)")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--method", type=str, default="tpe", choices=["tpe", "random", "wandb"],
                   help="tpe/random: local proposals, trials in lock-step groups, "
                        "works air-gapped, journal+--resume for preemption. wandb: "
                        "the W&B SERVER proposes every trial (wandb.agent, "
                        "reference sweep semantics) — sequential trials, requires "
                        "network + auth; rejoin a crashed sweep with --wandb_sweep_id")
    p.add_argument("--wandb_sweep_id", type=str, default=None,
                   help="with --method wandb: attach to this existing server-side "
                        "sweep instead of registering a new one (sweep.py:241)")
    # the reference's train_sweep builds any of the three families from the
    # sweep config (reference: sweep.py:135-143; fixed to 'basic' at :86)
    p.add_argument("--model", type=str, default="basic",
                   choices=["basic", "enhanced", "optimized"],
                   help="architecture every trial trains (reference fixes 'basic'; "
                        "'enhanced' sweeps BatchNorm stats + dropout per trial)")
    p.add_argument("--cache_images", action="store_true")
    p.add_argument("--resident_data", action="store_true",
                   help="decode the dataset once, keep it in device memory for the "
                        "whole sweep and run every epoch from there; the optimized "
                        "augmentation stack runs on the device")
    p.add_argument("--n_devices", type=int, default=0,
                   help="trial-parallel devices (0 = all local): one process per device, "
                        "each group's trial axis split over them")
    p.add_argument("--distributed", action="store_true",
                   help="join a process group (torch.distributed) and split each group's "
                        "trial axis over every rank of it; launch the same command once "
                        "per process. Every rank loads the same data; rank 0 writes the "
                        "results and artifacts")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # the reference's sweep fixes mixed_precision ON for every trial
    # (reference: sweep.py:80-87): bf16 compute, float32 parameters
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="trial compute dtype; params/optimizer stay f32")
    # the reference's sweep lives inside W&B (reference: sweep.py:231-241);
    # mirroring is opt-in here and degrades to local JSONL without network
    p.add_argument("--use_wandb", action="store_true",
                   help="mirror each finished trial to W&B as its own run")
    # --sweep_project/--sweep_entity are the reference's flag names
    # (reference: sweep.py:28-29); --wandb_* match the train CLI
    p.add_argument("--wandb_project", "--sweep_project", type=str,
                   default="image-deglaring-sweep")
    p.add_argument("--wandb_entity", "--sweep_entity", type=str, default=None,
                   help="W&B entity (team) for mirrored trial runs")
    p.add_argument("--prefetch_factor", type=int, default=2,
                   help="device-prefetch depth per trial group")
    p.add_argument("--persistent_workers", action="store_true",
                   help="accepted for reference-command compatibility (the threaded "
                        "loader is always persistent)")
    p.add_argument("--resume", type=str, default=None, metavar="SWEEP_DIR",
                   help="continue a preempted sweep: pass its output dir (the one "
                        "holding sweep_journal.jsonl) with the SAME flags as the "
                        "original run. Finished trial groups restore from the "
                        "journal without retraining; the completed sweep is "
                        "identical to an uninterrupted one (on the card the CLI "
                        "runs deterministic algorithms for this)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to sweep on (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.resume is not None:
        # the journal lives in the sweep's output dir; resuming INTO a
        # different dir would split it from the artifacts it indexes
        args.output_dir = args.resume
    from ..parallel import distributed

    if args.distributed:
        if args.method == "wandb":
            raise SystemExit("--method wandb runs trials sequentially from server proposals; "
                             "it does not compose with --distributed (use --method tpe for "
                             "multi-host lock-step sweeps)")
        distributed.initialize(coordinator_address=args.coordinator_address,
                               num_processes=args.num_processes, process_id=args.process_id,
                               device=args.device)
    elif any(a is not None for a in (args.coordinator_address, args.num_processes,
                                     args.process_id)):
        # explicit coordinator flags without --distributed would run N
        # INDEPENDENT sweeps writing one shared output_dir
        raise SystemExit("--coordinator_address/--num_processes/--process_id require "
                         "--distributed (refusing to fall back to an independent "
                         "single-host sweep)")
    if args.distributed:
        try:
            world = distributed.process_count()
            print(f"Distributed runtime: {world} process(es), {world} global device(s)")
            if world == 1:
                print("WARNING: --distributed resolved to a SINGLE process. If this is one "
                      "host of a pod, pass --coordinator_address/--num_processes/--process_id "
                      "explicitly.", file=sys.stderr)
            if world > 1 and args.n_devices:
                raise SystemExit("--distributed spans the global mesh; --n_devices applies "
                                 "to single-host runs only")
            _sweep(args)
        finally:
            distributed.shutdown()
        return
    # clamp like cli.train: a silently smaller mesh would leave the
    # operator believing more trial parallelism is active than is
    available = distributed.local_device_count(args.device, args.n_devices)
    n_dev = min(args.n_devices or available, available)
    if args.n_devices and args.n_devices > available:
        print(f"requested --n_devices {args.n_devices}, but only {available} available; "
              f"using {n_dev}")
    if n_dev > 1:
        distributed.launch_local(_sweep, n_dev, args, device=args.device)
    else:
        _sweep(args)


def _sweep(args) -> None:
    """The sweep of one process: alone, or one rank of a process group."""
    import torch

    from .._device import resolve_device
    from ..data import make_dataloaders
    from ..parallel import distributed
    from ..data.pipeline import list_image_paths, seeded_split
    from ..models import EnhancedUNet, LightweightUNet, OptimizedUNet
    from ..parallel.sweep import SearchSpace, run_sweep
    from ..utils import ExperimentLogger, set_seed

    mesh = (distributed.global_mesh(device=args.device)
            if distributed.process_count() > 1 or args.distributed else None)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    is_host0 = mesh is None or mesh.rank == 0
    if device.type == "cuda":
        # a group re-run after a preemption must reach the journaled run's
        # val losses: cuDNN's default weight-gradient algorithms may sum in
        # an order that varies from call to call. Deterministic cuBLAS reads
        # a fixed workspace size, before its first call in the process
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.benchmark = False
    set_seed(args.seed)
    loaders_cache = {}

    # --resident_data: host loaders only decode (augment='none'); the
    # optimized augmentation stack runs on the device
    augment_fn = None
    if args.resident_data:
        from ..ops.augment_device import device_augment_batch

        augment_fn = device_augment_batch

    def loader_factory(batch_size):
        if batch_size not in loaders_cache:
            loaders_cache[batch_size] = make_dataloaders(
                args.data_dir, batch_size=batch_size, val_split=args.val_split,
                seed=args.seed, image_size=args.image_size, num_workers=args.num_workers,
                cache_images=args.cache_images,
                augment="none" if args.resident_data else "optimized")
        return loaders_cache[batch_size]

    # rank 0 owns the telemetry (every rank computes the same results)
    wandb_mirror = None
    if args.use_wandb and is_host0:
        try:
            from ..parallel.sweep import WandbSweepMirror

            wandb_mirror = WandbSweepMirror(project=args.wandb_project,
                                            entity=args.wandb_entity)
        except Exception as e:  # wandb missing/unconfigured: JSONL only
            print(f"wandb unavailable ({e}); sweep telemetry stays local")

    logger = (ExperimentLogger(f"{args.output_dir}/sweep_logs", config=vars(args))
              if is_host0 else None)

    # restrict sampled batch sizes to those the train split can fill: a
    # sampled bs > split size would train ZERO steps per epoch (drop_last)
    n_train = len(seeded_split(list_image_paths(args.data_dir), args.val_split, args.seed)[0])
    space = SearchSpace()
    usable = tuple(b for b in space.batch_sizes if b <= n_train)
    if not usable:
        raise SystemExit(f"train split has only {n_train} images — below the smallest "
                         f"sweep batch size {min(space.batch_sizes)}")
    if usable != space.batch_sizes:
        if is_host0:
            print(f"Note: train split has {n_train} images; restricting sweep batch sizes "
                  f"to {usable}")
        space = SearchSpace(batch_sizes=usable)

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    ctor = {"basic": LightweightUNet, "enhanced": EnhancedUNet,
            "optimized": OptimizedUNet}[args.model]

    def model_factory():
        # every group starts from the same seeded init, as the JAX group
        # starts from model.init(PRNGKey(seed)); under vmap the model trains
        # on the composition (the GroupNorm+SiLU kernel pair has no vmap rule)
        return ctor(dtype=dtype, generator=torch.Generator().manual_seed(args.seed))

    if args.method == "wandb":
        if args.resume:
            raise SystemExit("--method wandb sweeps resume SERVER-side: rerun with "
                             "--wandb_sweep_id <id> instead of --resume")
        from ..parallel.sweep import run_wandb_agent_sweep

        try:
            result = run_wandb_agent_sweep(
                model_factory, loader_factory, n_trials=args.sweep_count,
                max_epochs=args.max_epochs, min_iter=args.early_stop_min_iter, eta=args.eta,
                seed=args.seed, output_dir=args.output_dir, space=space, logger=logger,
                project=args.wandb_project, entity=args.wandb_entity,
                early_stop_patience=args.early_stop_patience, prefetch=args.prefetch_factor,
                sweep_id=args.wandb_sweep_id, mesh=mesh, device=device)
        except Exception as e:
            raise SystemExit(
                f"--method wandb needs a reachable, authenticated W&B server "
                f"({type(e).__name__}: {e}). Air-gapped or offline, use --method tpe — "
                f"same Bayesian family, local proposals, trials in lock-step groups.")
        best = result["best"]
        if not is_host0:
            return
        print(f"Sweep {result['sweep_id']} completed (server-driven). "
              + ("No trial reached a finite validation loss" if best is None else
                 f"Best trial: id={best['trial_id']} batch_size={best['batch_size']} "
                 f"lr={best['lr']:.6g} wd={best['wd']:.6g} "
                 f"val_loss={best['best_val_loss']:.4f}"))
        return

    from ..train.preempt import PreemptionGuard

    guard = PreemptionGuard()
    # result-determining flags beyond the schedule (which run_sweep pins
    # itself): a --resume with any of these drifted would mix incomparable
    # restored and live trial results
    fingerprint = {
        "model": args.model,
        "data_dir": os.path.abspath(args.data_dir),
        "image_size": args.image_size,
        "val_split": args.val_split,
        "compute_dtype": args.compute_dtype,
        "resident_data": bool(args.resident_data),
        "cache_images": bool(args.cache_images),
    }
    with guard:
        result = run_sweep(
            model_factory, loader_factory, n_trials=args.sweep_count,
            max_epochs=args.max_epochs, min_iter=args.early_stop_min_iter, eta=args.eta,
            method=args.method, seed=args.seed, output_dir=args.output_dir, logger=logger,
            space=space, max_parallel_trials=args.parallel_trials, wandb_mirror=wandb_mirror,
            resident=args.resident_data, augment_fn=augment_fn, halving=args.halving,
            early_stop_patience=args.early_stop_patience, prefetch=args.prefetch_factor,
            preempt_guard=guard, resume=args.resume is not None, fingerprint=fingerprint,
            mesh=mesh, device=device)
    if not is_host0:
        return
    if result.get("preempted"):
        # exit 0: a drained preemption is a clean stop, not a failure
        print(f"Sweep preempted: {len(result['trials'])} finished trial(s) journaled in "
              f"{args.output_dir}/sweep_journal.jsonl — continue with the same flags plus "
              f"--resume {args.output_dir}", flush=True)
        return
    best = result["best"]
    if best is None:
        print("Sweep completed. No trial reached a finite validation loss (all diverged); "
              "see sweep_results.json")
        return
    print(f"Sweep completed. Best trial: id={best['trial_id']} "
          f"batch_size={best['batch_size']} lr={best['lr']:.6g} "
          f"wd={best['wd']:.6g} val_loss={best['best_val_loss']:.4f}")


if __name__ == "__main__":
    main()
