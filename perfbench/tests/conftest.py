"""Shared pieces of the benchmark's tests.

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; the decision is
made inside the fixture, never while a module is imported. Run them on
the card with ``python3 -m pytest perfbench/tests -m card``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS = os.path.join("deploy", "models", "best_model.onnx")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.cuda.get_device_name(0)


def _edit(path: str, **changes) -> None:
    with open(path) as f:
        d = json.load(f)
    d.update(changes)
    with open(path, "w") as f:
        json.dump(d, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's files at sizes a CPU test can hold: 64^2
    pages, small buckets and sets, EnhancedUNet at width 4, and limits of
    ``correct`` read from sound runs at these sizes."""
    root = str(tmp_path / "root")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.makedirs(os.path.join(root, os.path.dirname(WEIGHTS)))
    shutil.copy(os.path.join(ROOT, WEIGHTS), os.path.join(root, WEIGHTS))
    pb = os.path.join(root, "perfbench")
    _edit(f"{pb}/configs/lwunet_prod.json", image_size=64)
    _edit(f"{pb}/configs/enhanced_unet16.json", image_size=64, init_features=4)
    _edit(f"{pb}/traffic/serve_closed_b64.json", max_batch_size=8, outstanding=16, pages=16,
          sample=64, warm_s=0.3)
    _edit(f"{pb}/traffic/train_resident_b32.json", batch_size=4, pairs=32)
    serve = {"worst_image_mean_gap": {"max": 2.0}, "answered_share": {"min": 1.0}}
    train = {"loss_gap": {"max": 0.01}, "grad_norm_gap": {"max": 0.4},
             "change_norm_gap": {"max": 0.5}}
    for cell in os.listdir(f"{pb}/cells"):
        _edit(f"{pb}/cells/{cell}", limits=serve if ".serve" in cell else train)
    return root
