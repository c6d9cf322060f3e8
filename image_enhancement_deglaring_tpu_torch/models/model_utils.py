"""Parameter counting, size and magnitude pruning on parameter trees.

Counterpart of the first half of ``image_enhancement_deglaring_tpu.models.
model_utils``. A tree is a nested dict (the JAX package's layout, as
``modelio.export_jax_params`` gives it) whose leaves are numpy arrays or
torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def count_parameters(params) -> int:
    """Total number of parameters in a tree."""
    return sum(int(np.prod(tuple(x.shape))) for x in _leaves(params))


def get_model_size_mb(params) -> float:
    """Parameter bytes in MB (2**20 bytes)."""
    total = 0
    for x in _leaves(params):
        itemsize = x.element_size() if isinstance(x, torch.Tensor) else np.dtype(x.dtype).itemsize
        total += int(np.prod(tuple(x.shape))) * itemsize
    return total / (1024 * 1024)


def _prune_leaf(x, amount: float):
    t = torch.as_tensor(x)
    k = int(round(amount * t.numel()))
    if t.ndim < 2 or k <= 0:
        return x
    # exactly the k smallest magnitudes, ties broken by position (a
    # "<= threshold" test would zero every tie at the k-th magnitude)
    order = torch.argsort(t.abs().reshape(-1), stable=True)
    keep = torch.ones(t.numel(), dtype=torch.bool, device=t.device)
    keep[order[:k]] = False
    out = torch.where(keep.reshape(t.shape), t, torch.zeros_like(t))
    return out if isinstance(x, torch.Tensor) else out.numpy()


def prune_params(params, amount: float = 0.3):
    """L1-unstructured pruning per tensor: zero the ``amount`` fraction of
    lowest-magnitude entries of every rank >= 2 leaf (conv kernels); norm
    scales and biases stay. Returns a new tree with the leaves' types."""
    if isinstance(params, dict):
        return {k: prune_params(v, amount) for k, v in params.items()}
    return _prune_leaf(params, amount)
