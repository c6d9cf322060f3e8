"""Parameter counting, size, magnitude pruning and int8 quantization on
parameter trees.

Counterpart of ``image_enhancement_deglaring_tpu.models.model_utils``. A
tree is a nested dict (the JAX package's layout, as
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


def _quant_leaf(path: tuple, x, per_channel: bool):
    t = torch.as_tensor(x).detach()
    if t.ndim < 2:
        return t, torch.tensor(1.0, dtype=torch.float32, device=t.device)
    tf = t.float()
    if per_channel:
        # output-channel axis: the last for HWIO conv and (in, out) dense
        # kernels, but axis 1 for ConvTranspose weights in the torch
        # (Cin, Cout, kh, kw) layout. Those are exactly the rank-4 leaves
        # NAMED "weight" under upconv modules (UpConv2x); OptimizedUNet's
        # upconvN blocks hold ordinary HWIO kernels named "conv", which
        # keep the last axis (keying on the module name alone pooled their
        # output channels into kernel-width-indexed scales)
        ch_axis = (1 if "upconv" in "/".join(path) and t.ndim == 4 and path[-1] == "weight"
                   else t.ndim - 1)
        axes = tuple(a for a in range(t.ndim) if a != ch_axis)
        amax = tf.abs().amax(dim=axes, keepdim=True)
    else:
        amax = tf.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_params_int8(params, *, per_channel: bool = False):
    """Symmetric int8 quantization of the rank >= 2 leaves (kernels).

    ``per_channel=False``: one scale per tensor (the reference's fbgemm
    per-tensor static PTQ, reference: src/model.py:399-439);
    ``per_channel=True``: one scale per output channel (the last axis of
    HWIO kernels, axis 1 of up-conv weights), AQT-style. Scales are
    max(max|w|, 1e-12) / 127 in float32; w / scale is rounded half to even
    and clipped to +-127. Rank < 2 leaves stay as they are, scale 1.0.

    Returns (quantized tree, scales tree) of tensors on each leaf's device;
    :func:`dequantize_params_int8` inverts it."""
    def walk(tree, path):
        if isinstance(tree, dict):
            pairs = {k: walk(v, path + (str(k),)) for k, v in tree.items()}
            return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
        return _quant_leaf(path, tree, per_channel)

    return walk(params, ())


def dequantize_params_int8(qparams, scales, dtype: torch.dtype = torch.float32):
    """Inverse of :func:`quantize_params_int8`: an int8 leaf becomes
    (q * scale) in float32, cast to ``dtype``; another rank >= 2 leaf is
    cast to ``dtype``, and a rank < 2 leaf stays as it is."""
    if isinstance(qparams, dict):
        return {k: dequantize_params_int8(qparams[k], scales[k], dtype) for k in qparams}
    q = torch.as_tensor(qparams)
    if q.dtype == torch.int8:
        return (q.float() * scales).to(dtype)
    return q.to(dtype) if q.ndim >= 2 else q


def calibrate_act_scales(model, sample_batches, *, margin: float = 1.05):
    """Static-PTQ calibration for int8-activation serving (see ``ops.quant``).

    Runs ``model`` (a ``LightweightUNet``) under ``inference_mode`` over
    ``sample_batches`` (NHWC float arrays or tensors in [0, 1]) with
    ``act_scales="calib"``, takes the per-site, per-channel max|activation|
    over every batch and returns the scales tree that
    ``model(x, act_scales=...)`` consumes. ``margin`` leaves clip headroom
    above the calibration maximum."""
    from ..ops.quant import merge_act_stats, scales_from_act_stats

    device = next(model.parameters()).device
    stats = None
    with torch.inference_mode():
        for x in sample_batches:
            _, batch = model(torch.as_tensor(x).to(device), act_scales="calib")
            stats = merge_act_stats(stats, batch)
    if stats is None:
        raise ValueError("calibration needs at least one sample batch")
    return scales_from_act_stats(stats, margin=margin)
