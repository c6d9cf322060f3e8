"""Experiment logging: a W&B-compatible API with an offline JSONL backend.

Counterpart of ``image_enhancement_deglaring_tpu.utils.explog``: the same
calls (``log``, ``log_images``, ``log_histograms``, ``save``,
``set_summary``, ``finish``) write newline-delimited JSON and PNGs under
``run_dir``; with ``use_wandb=True`` and an importable ``wandb`` package
they are mirrored to it. Images are written with the port's PNG codec.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any

import numpy as np

from ..data.png import write_png
from .pytree import flatten_tree


class ExperimentLogger:
    def __init__(self, run_dir: str, *, run_name: str | None = None,
                 config: dict | None = None, use_wandb: bool = False,
                 project: str | None = None, entity: str | None = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.run_name = run_name or f"run-{int(time.time())}"
        self._metrics_path = os.path.join(run_dir, "metrics.jsonl")
        self._summary: dict[str, Any] = {}
        self._step = 0
        self._save_warned: set[str] = set()

        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, entity=entity, name=self.run_name,
                           config=config or {})
            except Exception as e:  # the offline log goes on either way
                warnings.warn(f"wandb mirroring disabled ({type(e).__name__}: {e})",
                              RuntimeWarning, stacklevel=2)
                self._wandb = None

        if config is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(_jsonable(config), f, indent=2)

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        step = self._step if step is None else step
        self._step = step + 1
        rec = {"_step": step, "_time": time.time(), **_jsonable(metrics)}
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, tag: str, images: dict[str, np.ndarray],
                   step: int | None = None) -> None:
        """Save a dict of (H, W) float [0, 1] or uint8 images as PNGs."""
        step = self._step if step is None else step
        img_dir = os.path.join(self.run_dir, "images", f"step_{step:06d}")
        os.makedirs(img_dir, exist_ok=True)
        as_uint8 = {}
        for name, arr in images.items():
            a = np.asarray(arr)
            if a.dtype != np.uint8:
                a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
            if a.ndim == 3 and a.shape[-1] == 1:
                a = a[..., 0]
            as_uint8[name] = a
            write_png(os.path.join(img_dir, f"{tag}_{name}.png"), a)
        if self._wandb is not None:
            self._wandb.log({tag: [self._wandb.Image(a, caption=name)
                                   for name, a in as_uint8.items()]}, step=step)

    def log_histograms(self, tree: dict, step: int | None = None,
                       prefix: str = "grad") -> None:
        """Summary statistics per leaf of a nested dict of arrays, named
        ``prefix/a/b``: the offline analogue of wandb.watch."""
        step = self._step if step is None else step
        rec = {}
        wandb_rec = {}
        for name, leaf in flatten_tree(tree).items():
            arr = np.asarray(leaf)
            rec[f"{prefix}/{name}"] = _histogram_stats(arr)
            if self._wandb is not None:
                wandb_rec[f"{prefix}/{name}"] = self._wandb.Histogram(
                    np.asarray(arr, np.float64).ravel())
        if self._wandb is not None and wandb_rec:
            self._wandb.log(wandb_rec, step=step)
        self.log({f"_histograms_{prefix}": rec}, step=step)

    def save(self, path: str) -> None:
        """Record a training artifact in artifacts.jsonl and, with a live
        wandb run, upload a point-in-time copy of it."""
        rec = {"_time": time.time(), "path": os.path.abspath(path)}
        with open(os.path.join(self.run_dir, "artifacts.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            try:
                if os.path.isdir(path):
                    base = os.path.dirname(os.path.abspath(path))
                    for dirpath, _dirs, files in os.walk(path):
                        for fname in files:
                            self._wandb.save(os.path.join(dirpath, fname), base_path=base,
                                             policy="now")
                else:
                    self._wandb.save(path, policy="now")
            except Exception as e:  # best effort; warn once per exception type
                kind = type(e).__name__
                if kind not in self._save_warned:
                    self._save_warned.add(kind)
                    warnings.warn(f"wandb artifact mirroring failed ({kind}: {e}); "
                                  f"further {kind} failures this run will be silent",
                                  RuntimeWarning, stacklevel=2)

    def set_summary(self, **kwargs) -> None:
        self._summary.update(_jsonable(kwargs))
        with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
            json.dump(self._summary, f, indent=2)
        if self._wandb is not None:
            for k, v in kwargs.items():
                self._wandb.run.summary[k] = v

    @property
    def summary(self) -> dict:
        return dict(self._summary)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(obj):
    if isinstance(obj, (float, np.floating)) and not np.isfinite(obj):
        return None  # bare NaN/Infinity tokens are not JSON
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def _histogram_stats(arr: np.ndarray) -> dict:
    a = np.asarray(arr, np.float64).ravel()
    qs = np.percentile(a, [0, 5, 25, 50, 75, 95, 100])
    return {
        "count": int(a.size), "mean": float(a.mean()), "std": float(a.std()),
        "min": float(qs[0]), "p5": float(qs[1]), "p25": float(qs[2]),
        "median": float(qs[3]), "p75": float(qs[4]), "p95": float(qs[5]),
        "max": float(qs[6]),
    }
