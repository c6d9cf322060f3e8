"""int8 activation quantization for the serving forward.

PyTorch counterpart of ``image_enhancement_deglaring_tpu.ops.quant``, on
nested dicts of tensors (the JAX package's pytrees).

``fake_quant_act_int8`` stores an activation as int8 with per-channel
symmetric scales (AQT-style) and reads it back: round(x / s) clipped to
[-127, 127], then widened and multiplied by s. The JAX function pins the
int8 buffer with an ``optimization_barrier`` so that XLA cannot fuse
producer into consumer and keep the wide tensor; eager PyTorch needs no
counterpart, since each operation materializes its result: the int8
tensor exists by construction (and so do the float32 temporaries around
it, which is why the quantized forward is slower here, see PERF.md).

Scales are calibrated offline (max |x| per channel over sample images, the
static-PTQ recipe: ``models.model_utils.calibrate_act_scales``). GroupNorm
sits right before every quantization site, so activation ranges are steady
enough for static scales.
"""

from __future__ import annotations

import torch


def fake_quant_act_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-trip ``x`` through int8 with per-channel scales.

    Args:
        x: (..., C) activation in any floating dtype.
        scale: (C,) float32 per-channel scales (max|x| / 127 from
            calibration).

    Returns:
        The dequantized activation in ``x.dtype``: x / s rounded half to
        even and clipped to +-127 as int8, then (q * s) in float32, cast
        back. It divides by s, as the JAX function does, rather than
        multiplying by 1 / s.
    """
    s = torch.clamp_min(scale.to(device=x.device, dtype=torch.float32), 1e-12)
    q = torch.clamp(torch.round(x.float() / s), -127.0, 127.0).to(torch.int8)
    return (q.float() * s).to(x.dtype)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def scales_from_act_stats(stats, *, margin: float = 1.0):
    """Turn calibration statistics (per-site, per-channel max|x|, nested
    dicts of tensors, as ``LightweightUNet(..., act_scales="calib")``
    records them) into the scales tree ``act_scales=`` consumes:
    max(stat * margin, 1e-8) / 127 in float32. ``margin`` > 1 leaves clip
    headroom for inputs hotter than the calibration set."""
    def to_scale(leaf):
        m = torch.as_tensor(leaf, dtype=torch.float32)
        return torch.clamp_min(m * margin, 1e-8) / 127.0

    return _tree_map(to_scale, stats)


#: Quantization-site groups by feature-map area for LightweightUNet at
#: 512^2 input: the "hot" sites carry ~97% of the inter-block activation
#: bytes (the 512^2 / 256^2 / 128^2 levels); the rest add noise for
#: little traffic.
HOT_SITES_512 = (
    "enc1", "p1", "enc2", "p2", "enc3",          # encoder top 3 levels
    "u3", "dec3", "u2", "dec2", "u1", "dec1",    # decoder top 3 levels
)


def subset_act_scales(scales: dict, keep=HOT_SITES_512) -> dict:
    """Keep only the named top-level sites (missing sites run unquantized)."""
    keep = set(keep)
    return {k: v for k, v in scales.items() if k in keep}


def merge_act_stats(a, b):
    """Elementwise max of two act_stats / scales trees (multi-batch
    calibration); ``a`` may be None."""
    if a is None:
        return b
    return _tree_map(torch.maximum, a, b)
