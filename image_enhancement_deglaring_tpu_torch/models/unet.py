"""LightweightUNet, the production ~486K-parameter de-glaring model.

PyTorch counterpart of ``image_enhancement_deglaring_tpu.models.unet``:
the same 4-level encoder/decoder U-Net ([Conv3x3 -> GroupNorm -> SiLU] x 2
blocks, AvgPool 2x2 down, ConvTranspose(k=2, s=2) up, concat-free decoder
blocks, 1x1 output conv), the same parameter names and layouts (HWIO conv
kernels, (Cin, Cout, 2, 2) up-conv weights), NHWC input and output.

Parameters live in float32; ``dtype`` is the compute dtype. The output is
cast to float32 and not clipped. ``kernels`` lets its GroupNorm+SiLU and
Conv3x3+GN+SiLU sites run the port's forward CUDA kernels, see
``ops.fused_kernels``.
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
from ..ops.quant import fake_quant_act_int8


def _uniform(shape, fan_in: int, generator, device) -> nn.Parameter:
    """torch's default conv init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    t = torch.rand(shape, generator=generator, device=device) * (2 * bound) - bound
    return nn.Parameter(t)


def _act_site(t: torch.Tensor, name: str, act_scales, stats):
    """One int8-activation quantization site (see ``ops.quant``).

    ``act_scales`` selects the mode: None = off (the exact forward);
    "calib" = record per-channel max|t| as ``stats[name]``; a dict = store
    ``t`` as int8 with ``act_scales[name]``'s scales (a site missing from
    the dict runs unquantized)."""
    if act_scales is None:
        return t
    if isinstance(act_scales, str):  # "calib"
        stats[name] = t.float().abs().amax(dim=(0, 1, 2))
        return t
    scale = act_scales.get(name)
    return t if scale is None else fake_quant_act_int8(t, scale)


def _act_hook(act_scales, stats):
    """``_act_site`` as a block's ``act_hook``, None when quantization is off."""
    if act_scales is None:
        return None
    return lambda t, name: _act_site(t, name, act_scales, stats)


def _sub_scales(act_scales, name: str):
    """A child block's entry of the scales dict (the None / "calib" modes
    pass through; a missing key runs the child unquantized)."""
    if act_scales is None or isinstance(act_scales, str):
        return act_scales
    return act_scales.get(name)


class ConvBlock(nn.Module):
    """[Conv3x3(no bias) -> GroupNorm -> SiLU] x 2 (``ops.conv_block``).

    ``kernels``: the model's flag, passed to its sites, which choose what
    runs (``ops.fused_kernels``). ``act_scales`` and ``stats``: the block's
    int8-activation sites "a1" and "a2", after each GN+SiLU
    (``_act_site``)."""

    def __init__(self, in_features: int, features: int, num_groups: int = 8, *,
                 kernels: bool = False, generator=None, device=None):
        super().__init__()
        f = features
        self.kernels = kernels
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

    def forward(self, x: torch.Tensor, act_scales=None, stats=None) -> torch.Tensor:
        return conv_block(x, self._params(), num_groups=self.groups, kernels=self.kernels,
                          act_hook=_act_hook(act_scales, stats))


class DualConvBlock(ConvBlock):
    """Decoder ConvBlock fed by (upsampled, skip) pairs without a concat;
    parameters as ConvBlock over the concatenated input (conv1 (3,3,2f,f))."""

    def __init__(self, features: int, num_groups: int = 8, *, kernels: bool = False,
                 generator=None, device=None):
        super().__init__(2 * features, features, num_groups, kernels=kernels,
                         generator=generator, device=device)

    def forward(self, x_up: torch.Tensor, x_skip: torch.Tensor, act_scales=None,
                stats=None) -> torch.Tensor:
        return conv_block_dual(x_up, x_skip, self._params(), num_groups=self.groups,
                               kernels=self.kernels, act_hook=_act_hook(act_scales, stats))


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

    ``kernels``: the serving configuration, the JAX model's ``pallas_gn=True,
    fused_blocks="auto"``: on the card a forward without autograd runs the
    forward-only K1-K3 where ``ops.fused_kernels``' sites place them. Off
    (the default, as ``cli.train`` builds it) the composition; either way a
    grad call trains each GroupNorm+SiLU through the training pair.
    ``remat``: recompute each block's activations in the backward pass
    (``torch.utils.checkpoint`` per block, as the JAX model wraps each
    block in ``nn.remat``) instead of storing them.

    ``forward(x, act_scales=...)``: int8 activations for serving (see
    ``ops.quant``) at 26 sites, the JAX model's: "a1"/"a2" inside each
    block, "p1".."p4" after the pools, "u4".."u1" after the up-convs.
    None = the exact forward; "calib" = also return per-site, per-channel
    max|x| as a nested dict, ``(out, act_stats)`` (flax's ``sow`` into
    ``act_stats``, with its keys); a scales dict
    (``ops.quant.scales_from_act_stats``) = round-trip every listed site
    through int8. ``remat`` cannot be combined with it.
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 1, num_groups: int = 8,
                 features_start: int = 8, dtype: torch.dtype = torch.float32,
                 remat: bool = False, kernels: bool = False, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_groups = num_groups
        self.remat = remat
        self.kernels = kernels
        f0 = features_start
        f = [f0, f0 * 2, f0 * 4, f0 * 8, f0 * 16]
        kw = dict(generator=generator, device=device)
        blk = dict(kernels=kernels, **kw)
        self.enc1 = ConvBlock(in_channels, f[0], num_groups, **blk)
        self.enc2 = ConvBlock(f[0], f[1], num_groups, **blk)
        self.enc3 = ConvBlock(f[1], f[2], num_groups, **blk)
        self.enc4 = ConvBlock(f[2], f[3], num_groups, **blk)
        self.bottleneck = ConvBlock(f[3], f[4], num_groups, **blk)
        self.upconv4 = UpConv2x(f[4], f[3], **kw)
        self.dec4 = DualConvBlock(f[3], num_groups, **blk)
        self.upconv3 = UpConv2x(f[3], f[2], **kw)
        self.dec3 = DualConvBlock(f[2], num_groups, **blk)
        self.upconv2 = UpConv2x(f[2], f[1], **kw)
        self.dec2 = DualConvBlock(f[1], num_groups, **blk)
        self.upconv1 = UpConv2x(f[1], f[0], **kw)
        self.dec1 = DualConvBlock(f[0], num_groups, **blk)
        self.output_conv_weight = _uniform((1, 1, f[0], out_channels), f[0], generator, device)
        self.output_conv_bias = _uniform((out_channels,), f[0], generator, device)

    def _block(self, block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, x: torch.Tensor, act_scales=None):
        if act_scales is not None and self.remat:
            raise ValueError("remat=True cannot be combined with act_scales; rebuild "
                             "the model with remat=False for calibration/int8 serving")
        stats = {} if isinstance(act_scales, str) else None

        def run(name: str, *args: torch.Tensor) -> torch.Tensor:
            block = getattr(self, name)
            if act_scales is None:
                return self._block(block, *args)
            return block(*args, act_scales=_sub_scales(act_scales, name),
                         stats=None if stats is None else stats.setdefault(name, {}))

        def aq(t: torch.Tensor, name: str) -> torch.Tensor:
            return _act_site(t, name, act_scales, stats)

        exact = self.dtype == torch.float32
        with highest_precision() if exact else contextlib.nullcontext():
            x = x.to(self.dtype)
            enc1 = run("enc1", x)
            enc2 = run("enc2", aq(avg_pool_2x2(enc1), "p1"))
            enc3 = run("enc3", aq(avg_pool_2x2(enc2), "p2"))
            enc4 = run("enc4", aq(avg_pool_2x2(enc3), "p3"))
            bottleneck = run("bottleneck", aq(avg_pool_2x2(enc4), "p4"))
            d4 = run("dec4", aq(self.upconv4(bottleneck), "u4"), enc4)
            d3 = run("dec3", aq(self.upconv3(d4), "u3"), enc3)
            d2 = run("dec2", aq(self.upconv2(d3), "u2"), enc2)
            d1 = run("dec1", aq(self.upconv1(d2), "u1"), enc1)
            out = conv2d(d1, self.output_conv_weight, self.output_conv_bias).float()
        return out if stats is None else (out, stats)
