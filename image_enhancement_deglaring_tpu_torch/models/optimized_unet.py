"""OptimizedUNet: a 4-level U-Net with squeeze-excite gates on the skips
and a nearest-upsample decoder.

PyTorch counterpart of ``image_enhancement_deglaring_tpu.models.
optimized_unet``, with its parameter names and layouts (HWIO kernels, the
SE gates as 1x1 kernels). Blocks are [Conv3x3 -> GroupNorm -> SiLU] x 2
with 1 group at the stem, 8 in the bottleneck and 4 elsewhere; AvgPool 2x2
down; nearest-2x + Conv3x3 + GN(4) + SiLU up; a 1x1 output conv. NHWC in
and out, float32 parameters, ``dtype`` the compute dtype, float32 output.
No kernel runs here: the JAX model has no kernel knob either.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..ops.conv_blocks import (
    avg_pool_2x2,
    conv2d,
    group_norm,
    highest_precision,
    silu,
    stat_mean,
    upsample_nearest_2x,
)
from .unet import ConvBlock, _uniform


class ChannelAttention(nn.Module):
    """Squeeze-and-excitation gate: global mean (in float32), 1x1 conv to
    max(C // reduction, 8), SiLU, 1x1 conv back, sigmoid, times x."""

    def __init__(self, channels: int, reduction: int = 16, *, generator=None, device=None):
        super().__init__()
        reduced = max(channels // reduction, 8)
        self.fc1 = _uniform((1, 1, channels, reduced), channels, generator, device)
        self.fc2 = _uniform((1, 1, reduced, channels), reduced, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = stat_mean(x.float(), (1, 2)).to(x.dtype)
        gate = torch.sigmoid(conv2d(silu(conv2d(avg, self.fc1)), self.fc2))
        return x * gate


class UpBlockNearest(nn.Module):
    """Nearest-2x upsample, Conv3x3 (no bias), GroupNorm(4), SiLU."""

    def __init__(self, in_features: int, out_features: int, *, generator=None, device=None):
        super().__init__()
        self.conv = _uniform((3, 3, in_features, out_features), 9 * in_features, generator,
                             device)
        self.gn_scale = nn.Parameter(torch.ones(out_features, device=device))
        self.gn_bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(upsample_nearest_2x(x), self.conv, padding=1)
        return silu(group_norm(y, self.gn_scale, self.gn_bias, num_groups=4))


class OptimizedUNet(nn.Module):
    """OptimizedUNet (``init_features`` 16 is the published width)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, init_features: int = 16,
                 dtype: torch.dtype = torch.float32, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        f = init_features
        kw = dict(generator=generator, device=device)
        self.enc1 = ConvBlock(in_channels, f, 1, **kw)
        self.enc2 = ConvBlock(f, f * 2, 4, **kw)
        self.enc3 = ConvBlock(f * 2, f * 4, 4, **kw)
        self.enc4 = ConvBlock(f * 4, f * 8, 4, **kw)
        self.bottleneck = ConvBlock(f * 8, f * 16, 8, **kw)
        for level, width, below in ((4, f * 8, f * 16), (3, f * 4, f * 8), (2, f * 2, f * 4),
                                    (1, f, f * 2)):
            setattr(self, f"upconv{level}", UpBlockNearest(below, width, **kw))
            setattr(self, f"attention{level}", ChannelAttention(width, **kw))
            setattr(self, f"dec{level}", ConvBlock(2 * width, width, 4, **kw))
        self.output_weight = _uniform((1, 1, f, out_channels), f, generator, device)
        self.output_bias = _uniform((out_channels,), f, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        exact = self.dtype == torch.float32
        with highest_precision() if exact else contextlib.nullcontext():
            x = x.to(self.dtype)
            enc = [self.enc1(x)]
            for blk in (self.enc2, self.enc3, self.enc4):
                enc.append(blk(avg_pool_2x2(enc[-1])))
            d = self.bottleneck(avg_pool_2x2(enc[-1]))
            for level in (4, 3, 2, 1):
                up = getattr(self, f"upconv{level}")(d)
                gated = getattr(self, f"attention{level}")(enc[level - 1])
                d = getattr(self, f"dec{level}")(torch.cat([up, gated], dim=-1))
            out = conv2d(d, self.output_weight, self.output_bias)
        return out.float()
