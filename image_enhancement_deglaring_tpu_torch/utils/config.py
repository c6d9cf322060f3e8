"""Unified dataclass config for programmatic use.

Counterpart of ``image_enhancement_deglaring_tpu.utils.config``. The
reference scatters configuration over per-script argparse + .env +
wandb.config (reference: optimized_train.py:35-60, sweep.py:23-38,
evaluate.py:18-37). These dataclasses centralize every knob (with the
sweep-tuned lr/wd defaults of reference: optimized_train.py:42,52) for
library callers and tooling; :func:`from_args` turns any of them into a
CLI. The CLIs in ``cli/`` keep their own argparse surfaces so flag
names/defaults stay 1:1 with the reference scripts.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field


@dataclass
class DataConfig:
    data_dir: str = "SD1/train"
    image_size: int = 512
    val_split: float = 0.2
    cache_images: bool = False
    num_workers: int = 8  # host prefetch threads
    augment: str = "optimized"  # "optimized" | "heavy" | "none"


@dataclass
class TrainConfig:
    output_dir: str = "./models_out"
    batch_size: int = 32
    epochs: int = 50
    # Best sweep hyperparameters (reference: optimized_train.py:42,52)
    lr: float = 0.002362532125818593
    weight_decay: float = 6.753784966611083e-05
    clip_grad_norm: float = 1.0
    patience: int = 10
    save_every: int = 10
    seed: int = 42
    log_images_every: int = 5
    validation_metrics_every: int = 5
    # ReduceLROnPlateau equivalent (reference: optimized_train.py:449-451)
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    compute_dtype: str = "bfloat16"  # AMP analogue: bf16 compute, f32 params
    model: str = "basic"  # basic | enhanced | optimized
    use_wandb: bool = False
    wandb_project: str = "image-deglaring"
    data: DataConfig = field(default_factory=DataConfig)


@dataclass
class EvalConfig:
    data_dir: str = "SD1/val"
    model_path: str = "./best_model.ckpt"
    model: str = "lightweight"  # lightweight | optimized
    batch_size: int = 16
    image_size: int = 512
    seed: int = 42
    save_visualizations: bool = False
    visualizations_dir: str = "./eval_visualizations"
    max_vis_samples: int = 10
    compute_dtype: str = "float32"


@dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 4000
    model_path: str = "deploy/models/best_model.onnx"
    image_size: int = 512
    # micro-batching engine
    max_batch_size: int = 8
    batch_timeout_ms: float = 3.0
    compute_dtype: str = "bfloat16"
    # int8 weight quantization for serving ("" = off, "int8" = on)
    quantize: str = ""
    # tiled full-resolution mode ("resize" reproduces the reference API's
    # downsample-to-512 behavior; "tile" runs every 512^2 tile)
    mode: str = "resize"
    tile_overlap: int = 32


@dataclass
class SweepConfig:
    sweep_count: int = 20
    max_epochs: int = 50
    early_stop_patience: int = 10
    seed: int = 42
    # search space bounds (reference: sweep.py:54-88)
    batch_sizes: tuple = (4, 8, 16, 32)
    lr_min: float = 1e-4
    lr_max: float = 1e-2
    wd_min: float = 1e-6
    wd_max: float = 1e-3
    # Hyperband-style early termination: rungs at min_iter, min_iter*eta, ...
    # (successive halving keeps the top 1/eta at each rung)
    hyperband_min_iter: int = 10
    eta: int = 3
    # cap on trials trained simultaneously in one lock-step group
    # (0 = whole same-batch-size group at once)
    parallel_trials: int = 0


def add_dataclass_args(parser: argparse.ArgumentParser, cfg, prefix: str = "") -> None:
    """Register every dataclass field as a --flag (nested via dots)."""
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            add_dataclass_args(parser, val, prefix=f"{prefix}{f.name}.")
            continue
        name = f"--{prefix}{f.name}"
        dest = f"{prefix}{f.name}".replace(".", "_")
        if isinstance(val, bool):
            parser.add_argument(name, dest=dest,
                                type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=val)
        elif isinstance(val, tuple):
            parser.add_argument(name, dest=dest,
                                type=lambda s: tuple(int(x) for x in s.split(",")),
                                default=val)
        else:
            parser.add_argument(name, dest=dest, type=type(val), default=val)


def from_args(cfg_cls, argv=None, parser: argparse.ArgumentParser | None = None):
    """Build a config dataclass from CLI args (nested fields via dots)."""
    cfg = cfg_cls()
    parser = parser or argparse.ArgumentParser()
    add_dataclass_args(parser, cfg)
    # strict parse: a misspelled --flag must error, not silently fall back
    # to the dataclass default (which would quietly invalidate the run)
    ns = parser.parse_args(argv)

    def apply(obj, prefix=""):
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if dataclasses.is_dataclass(val):
                apply(val, prefix=f"{prefix}{f.name}.")
            else:
                arg_name = f"{prefix}{f.name}".replace(".", "_")
                if hasattr(ns, arg_name):
                    setattr(obj, f.name, getattr(ns, arg_name))
        return obj

    return apply(cfg)
