"""Time one lock-step trial group's per-step epoch against its resident one.

    python -m image_enhancement_deglaring_tpu_torch.tools.sweep_resident_bench \\
        [--n 256] [--size 128] [--bs 16] [--k 8] [--epochs 3] \\
        [--dtype float32] [--device cuda]

Counterpart of ``scripts/bench_sweep_resident.py``, with its defaults: one
``VmappedTrialGroup`` of K trials at batch ``bs`` on the full
LightweightUNet over ``n`` seeded synthetic pairs (64 of them the
validation set), device augmentation on both sides, so the comparison
isolates the input path. The per-step epoch copies every batch from host
arrays through ``DevicePrefetcher``; the resident one caches the set on the
device once and gathers each batch there. One warm-up epoch each, then the
mean host time of ``epochs`` train + val epochs; every epoch ends in a
fetch of its losses, so the time covers the device's work. Prints one JSON
line; on a CUDA device it also holds the peak device memory of the two
runs. With ``--device cpu`` the times are the CPU's, for checking the
script only.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..models import LightweightUNet
from ..ops.augment_device import device_augment_batch
from ..parallel.sweep import Trial, VmappedTrialGroup
from ..train.loop import _host_memory_bytes
from ..train.resident import batch_val_cache, cache_on_device


class _Arrays:
    """A loader over fixed NHWC arrays, drop-last batches in order."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int):
        self.x, self.y, self.batch_size = x, y, batch_size
        self.num_samples = len(x)

    def __len__(self):
        return len(self.x) // self.batch_size

    def __iter__(self):
        for i in range(len(self)):
            s = slice(i * self.batch_size, (i + 1) * self.batch_size)
            yield self.x[s], self.y[s]


def run(n: int = 256, size: int = 128, bs: int = 16, k: int = 8, epochs: int = 3,
        dtype: str = "float32", device="cuda") -> dict:
    dev = resolve_device(device)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(0)
    y = rng.random((n, size, size, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.1, y.shape), 0, 1).astype(np.float32)
    loader, vloader = _Arrays(x, y, bs), _Arrays(x[:64], y[:64], bs)
    budget = None if dev.type == "cuda" else _host_memory_bytes()

    def group():
        model = LightweightUNet(dtype=dt, generator=torch.Generator().manual_seed(0))
        trials = [Trial(trial_id=i, batch_size=bs, lr=1e-3, wd=1e-5) for i in range(k)]
        return VmappedTrialGroup(model, trials, seed=0, augment_fn=device_augment_batch,
                                 device=dev)

    def timed(train, val) -> float:
        train(0)
        val()  # warm-up
        t0 = time.perf_counter()
        for e in range(epochs):
            train(e + 1)
            val()
        return (time.perf_counter() - t0) / epochs

    peak = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    g = group()
    stepwise_s = timed(lambda e: g.train_epoch(loader, e), lambda: g.val_epoch(vloader))
    if dev.type == "cuda":
        peak["stepwise"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del g
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    g = group()
    data = cache_on_device(loader, dtype=torch.bfloat16 if dt == torch.bfloat16 else None,
                           device=dev, device_bytes=budget)
    vdata = cache_on_device(vloader, device=dev, device_bytes=budget)
    vb = batch_val_cache(vdata, bs)
    resident_s = timed(lambda e: g.train_epoch_resident(data, e),
                       lambda: g.val_epoch_resident(vb, vdata.n))
    if dev.type == "cuda":
        peak["resident"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n": n, "size": size, "batch": bs, "trials": k, "steps_per_epoch": n // bs,
        "dtype": dtype, "epochs": epochs,
        "stepwise_epoch_s": stepwise_s, "resident_epoch_s": resident_s,
        "speedup": stepwise_s / resident_s,
        **({"peak_gib": peak} if peak else {}),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="per-step vs resident trial-group epochs")
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)
    print(json.dumps(run(n=a.n, size=a.size, bs=a.bs, k=a.k, epochs=a.epochs, dtype=a.dtype,
                         device=a.device)), flush=True)


if __name__ == "__main__":
    main()
