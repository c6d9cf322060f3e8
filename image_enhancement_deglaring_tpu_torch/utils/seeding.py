"""Reproducibility: one seed for python, numpy and torch."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42, *, verbose: bool = True) -> torch.Generator:
    """Seed python's, numpy's and torch's generators (the CPU one and every
    CUDA device's, ``torch.manual_seed``) and return a CPU
    ``torch.Generator`` seeded with ``seed``, to hand to what draws."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if verbose:
        print(f"All random seeds set to {seed} for reproducibility")
    return torch.Generator().manual_seed(seed)
