"""LightweightUNet, the production ~486K-parameter de-glaring model.

PyTorch counterpart of ``image_enhancement_deglaring_tpu.models.unet``:
the same 4-level encoder/decoder U-Net ([Conv3x3 -> GroupNorm -> SiLU] x 2
blocks, AvgPool 2x2 down, ConvTranspose(k=2, s=2) up, concat-free decoder
blocks, 1x1 output conv), the same parameter names and layouts (HWIO conv
kernels, (Cin, Cout, 2, 2) up-conv weights), NHWC input and output.

Parameters live in float32; ``dtype`` is the compute dtype. The output is
cast to float32 and not clipped. ``pallas_gn`` and ``fused_blocks`` (the
JAX package's knob names) route GroupNorm+SiLU and Conv3x3+GN+SiLU through
the port's CUDA kernels, see ``ops.fused_kernels``.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv_blocks import (
    avg_pool_2x2,
    conv2d,
    conv_block,
    conv_block_dual,
    highest_precision,
    resolve_group_count,
    upsample2x_matmul,
)
from ..ops.fused_kernels import fused_conv3x3_gn_silu


def _uniform(shape, fan_in: int, generator, device) -> nn.Parameter:
    """torch's default conv init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    t = torch.rand(shape, generator=generator, device=device) * (2 * bound) - bound
    return nn.Parameter(t)


class ConvBlock(nn.Module):
    """[Conv3x3(no bias) -> GroupNorm -> SiLU] x 2.

    ``fused=True`` runs each conv+GN+SiLU as one ``fused_conv3x3_gn_silu``;
    else ``pallas_gn=True`` fuses each GN+SiLU pair."""

    def __init__(self, in_features: int, features: int, num_groups: int = 8, *,
                 fused: bool = False, pallas_gn: bool = False, generator=None,
                 device=None):
        super().__init__()
        f = features
        self.fused, self.pallas_gn = fused, pallas_gn
        self.groups = resolve_group_count(f, num_groups)
        self.conv1 = _uniform((3, 3, in_features, f), 9 * in_features, generator, device)
        self.gn1_scale = nn.Parameter(torch.ones(f, device=device))
        self.gn1_bias = nn.Parameter(torch.zeros(f, device=device))
        self.conv2 = _uniform((3, 3, f, f), 9 * f, generator, device)
        self.gn2_scale = nn.Parameter(torch.ones(f, device=device))
        self.gn2_bias = nn.Parameter(torch.zeros(f, device=device))

    def _params(self) -> dict:
        return {k: getattr(self, k) for k in
                ("conv1", "gn1_scale", "gn1_bias", "conv2", "gn2_scale", "gn2_bias")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        if self.fused:
            y = fused_conv3x3_gn_silu(x, self.conv1, self.gn1_scale, self.gn1_bias,
                                      num_groups=g)
            return fused_conv3x3_gn_silu(y, self.conv2, self.gn2_scale, self.gn2_bias,
                                         num_groups=g)
        return conv_block(x, self._params(), num_groups=g, pallas_gn=self.pallas_gn)


class DualConvBlock(ConvBlock):
    """Decoder ConvBlock fed by (upsampled, skip) pairs without a concat;
    parameters as ConvBlock over the concatenated input (conv1 (3,3,2f,f))."""

    def __init__(self, features: int, num_groups: int = 8, *, pallas_gn: bool = False,
                 generator=None, device=None):
        super().__init__(2 * features, features, num_groups, pallas_gn=pallas_gn,
                         generator=generator, device=device)

    def forward(self, x_up: torch.Tensor, x_skip: torch.Tensor) -> torch.Tensor:
        return conv_block_dual(x_up, x_skip, self._params(), num_groups=self.groups,
                               pallas_gn=self.pallas_gn)


class UpConv2x(nn.Module):
    """ConvTranspose2d(k=2, s=2) as a matmul + depth-to-space."""

    def __init__(self, in_features: int, out_features: int, *, generator=None,
                 device=None):
        super().__init__()
        fan_in = out_features * 4  # torch's ConvTranspose2d fan-in
        self.weight = _uniform((in_features, out_features, 2, 2), fan_in, generator, device)
        self.bias = _uniform((out_features,), fan_in, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_matmul(x, self.weight, self.bias)


class LightweightUNet(nn.Module):
    """Production de-glaring U-Net (486,409 parameters at the defaults).

    Input/output: NHWC float tensors, grayscale (C=1), values in [0, 1];
    the output is float32 and not clipped.

    ``fused_blocks``: False = composition everywhere, True = K3 at every
    encoder/bottleneck block, "auto" = only where features >= 64.
    ``pallas_gn``: fuse the other GroupNorm+SiLU pairs (K1/K2).
    ``remat``: recompute each block's activations in the backward pass
    (``torch.utils.checkpoint`` per block, as the JAX model wraps each
    block in ``nn.remat``) instead of storing them. ``act_scales`` belongs
    to a later part of the port and raises if set.
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 1, num_groups: int = 8,
                 features_start: int = 8, dtype: torch.dtype = torch.float32,
                 remat: bool = False, fused_blocks=False, pallas_gn: bool = False, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if fused_blocks not in (False, True, "auto"):
            raise ValueError(f"fused_blocks must be False, True or 'auto', got {fused_blocks!r}")
        self.dtype = dtype
        self.remat = remat
        self.fused_blocks, self.pallas_gn = fused_blocks, pallas_gn
        f0 = features_start
        f = [f0, f0 * 2, f0 * 4, f0 * 8, f0 * 16]
        kw = dict(generator=generator, device=device)

        def block(cin, feats):
            fused = feats >= 64 if fused_blocks == "auto" else bool(fused_blocks)
            return ConvBlock(cin, feats, num_groups, fused=fused, pallas_gn=pallas_gn, **kw)

        self.enc1 = block(in_channels, f[0])
        self.enc2 = block(f[0], f[1])
        self.enc3 = block(f[1], f[2])
        self.enc4 = block(f[2], f[3])
        self.bottleneck = block(f[3], f[4])
        self.upconv4 = UpConv2x(f[4], f[3], **kw)
        self.dec4 = DualConvBlock(f[3], num_groups, pallas_gn=pallas_gn, **kw)
        self.upconv3 = UpConv2x(f[3], f[2], **kw)
        self.dec3 = DualConvBlock(f[2], num_groups, pallas_gn=pallas_gn, **kw)
        self.upconv2 = UpConv2x(f[2], f[1], **kw)
        self.dec2 = DualConvBlock(f[1], num_groups, pallas_gn=pallas_gn, **kw)
        self.upconv1 = UpConv2x(f[1], f[0], **kw)
        self.dec1 = DualConvBlock(f[0], num_groups, pallas_gn=pallas_gn, **kw)
        self.output_conv_weight = _uniform((1, 1, f[0], out_channels), f[0], generator, device)
        self.output_conv_bias = _uniform((out_channels,), f[0], generator, device)

    def _block(self, block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, x: torch.Tensor, act_scales=None) -> torch.Tensor:
        if act_scales is not None:
            if self.remat:
                raise ValueError("remat=True cannot be combined with act_scales; rebuild "
                                 "the model with remat=False for calibration/int8 serving")
            raise NotImplementedError("int8 activation sites are not ported yet")
        run = self._block
        exact = self.dtype == torch.float32
        with highest_precision() if exact else contextlib.nullcontext():
            x = x.to(self.dtype)
            enc1 = run(self.enc1, x)
            enc2 = run(self.enc2, avg_pool_2x2(enc1))
            enc3 = run(self.enc3, avg_pool_2x2(enc2))
            enc4 = run(self.enc4, avg_pool_2x2(enc3))
            bottleneck = run(self.bottleneck, avg_pool_2x2(enc4))
            d4 = run(self.dec4, self.upconv4(bottleneck), enc4)
            d3 = run(self.dec3, self.upconv3(d4), enc3)
            d2 = run(self.dec2, self.upconv2(d3), enc2)
            d1 = run(self.dec1, self.upconv1(d2), enc1)
            out = conv2d(d1, self.output_conv_weight, self.output_conv_bias)
        return out.float()
