"""LightweightUNet, as the reference repository's ``src/model.py`` writes it.

A 4-level U-Net over NCHW float32: each block is ``nn.Sequential(Conv2d
3x3 no bias, GroupNorm(8), SiLU, Conv2d 3x3 no bias, GroupNorm(8),
SiLU)``, so its parameters are ``<block>.0.weight``, ``<block>.1.weight``
and ``.bias``, ``<block>.3.weight``, ``<block>.4.weight`` and ``.bias``.
Encoders enc1..enc4 and a bottleneck at widths f, 2f .. 16f
(``features_start`` f = 8), AvgPool2d(2) between them;
ConvTranspose2d(k=2, s=2) ``upconv4..1`` up; each decoder block takes
``cat([up, skip], 1)``; a 1x1 ``output_conv`` with bias. The output is
not clipped. The names and layouts are those of the ``.onnx`` export.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Precision

ENCODERS = ("enc1", "enc2", "enc3", "enc4", "bottleneck")
DECODERS = ("dec4", "dec3", "dec2", "dec1")
GROUPS = 8


def _block(x, p: dict, name: str, q: Precision):
    for conv, gn in ((0, 1), (3, 4)):
        w = p[f"{name}.{conv}.weight"]
        x = q.result(F.conv2d(q.operand(x), q.operand(w), padding=1))
        x = F.group_norm(x, GROUPS, p[f"{name}.{gn}.weight"].reshape(-1),
                         p[f"{name}.{gn}.bias"].reshape(-1), eps=1e-5)
        x = F.silu(x)
    return x


def forward(p: dict, x: torch.Tensor, q: Precision = Precision("f32")) -> torch.Tensor:
    """(N, 1, H, W) in [0, 1] -> (N, 1, H, W), from the parameters ``p``
    (name -> float32 tensor on ``x``'s device)."""
    skips = []
    for name in ENCODERS:
        if skips:
            x = F.avg_pool2d(x, 2)
        x = _block(x, p, name, q)
        skips.append(x)
    x = skips.pop()
    for name in DECODERS:
        up = f"upconv{name[-1]}"
        x = q.result(F.conv_transpose2d(q.operand(x), q.operand(p[f"{up}.weight"]),
                                        p[f"{up}.bias"], stride=2))
        x = _block(torch.cat([x, skips.pop()], 1), p, name, q)
    return q.result(F.conv2d(q.operand(x), q.operand(p["output_conv.weight"]),
                             p["output_conv.bias"]))


def parameter_init(features: int = 8) -> dict[str, tuple]:
    """name -> (shape, init) for every parameter at ``features_start`` =
    ``features``; ``init`` as in ``enhanced_unet.parameter_init`` (torch's
    default conv and ConvTranspose init, GroupNorm's ones and zeros)."""
    f = [features * 2 ** i for i in range(5)]
    out: dict[str, tuple] = {}

    def block(name, cin, c):
        out[f"{name}.0.weight"] = ((c, cin, 3, 3), ("uniform", 9 * cin))
        out[f"{name}.3.weight"] = ((c, c, 3, 3), ("uniform", 9 * c))
        for gn in (1, 4):
            out[f"{name}.{gn}.weight"] = ((c,), ("ones",))
            out[f"{name}.{gn}.bias"] = ((c,), ("zeros",))

    cin = 1
    for name, c in zip(ENCODERS, f):
        block(name, cin, c)
        cin = c
    for name, c in zip(DECODERS, reversed(f[:4])):
        up = f"upconv{name[-1]}"
        out[f"{up}.weight"] = ((2 * c, c, 2, 2), ("uniform", 4 * c))
        out[f"{up}.bias"] = ((c,), ("uniform", 4 * c))
        block(name, 2 * c, c)
    out["output_conv.weight"] = ((1, f[0], 1, 1), ("uniform", f[0]))
    out["output_conv.bias"] = ((1,), ("uniform", f[0]))
    return out
