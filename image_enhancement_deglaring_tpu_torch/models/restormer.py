"""Restormer: a 4-level encoder-decoder of transformer blocks with
channel ("transposed") attention (Zamir et al., "Restormer: Efficient
Transformer for High-Resolution Image Restoration", CVPR 2022; upstream
https://github.com/swz30/Restormer ``basicsr/models/archs/restormer_arch.py``).

The port's family follows upstream's equations and its state-dict names
(``encoder_level1.0.attn.qkv.weight``, ``...attn.temperature``,
``down1_2.body.0.weight``, ...), in the port's layouts: NHWC activations,
HWIO conv kernels (a depthwise kernel is (3, 3, 1, C)), the temperatures
(heads, 1, 1) as upstream has them. Parameters live in float32; ``dtype``
is the compute dtype (activations and the weights as used); the
LayerNorm statistics, the L2 norms and the softmax run in float32. The
output is float32 and not clipped: it is ``output(...) + input``, the
global residual.

Each block is ``x + MDTA(LN(x))`` then ``x + GDFN(LN(x))``
(``ops.fused_kernels.layer_norm_site``, ``transposed_attention``); the
BiasFree LayerNorm does not centre ``x``. On the card, outside a grad
call, each LayerNorm is one launch of the hand-written kernel K6; on the
CPU and in training, the float32 composition
``ops.conv_blocks.channel_layer_norm``. Down: a 3x3 conv to C/2 and
pixel-unshuffle; up: a 3x3 conv to 2C and pixel-shuffle; skips
concatenated, a 1x1 ``reduce_chan`` at levels 3 and 2 (none at level 1);
level 1's decoder and the refinement at 2 x dim. Sides must divide by 8.

While a ``torch.profiler`` session runs, each block records the spans
``restormer.mdta`` (LN, MDTA and the residual add; ``level``, ``heads``,
``channels``, ``images``) and ``restormer.gdfn`` (LN, GDFN and the add;
``level``, ``channels``, ``images``) through ``utils.profiling.span``;
with no session a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_blocks import (
    conv2d,
    highest_precision,
    pixel_shuffle,
    pixel_unshuffle,
    transposed_attention,
)
from ..ops.fused_kernels import layer_norm_site
from ..utils.profiling import span

#: upstream's gray denoising configuration
#: (Denoising/Options/GaussianGrayDenoising_Restormer.yml, ``network_g``)
GRAY_CONFIG = {"dim": 48, "num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4,
               "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
               "layernorm_type": "BiasFree", "in_channels": 1, "out_channels": 1}

SIDE_MULTIPLE = 8  # three pixel-unshuffles by 2


def _uniform(shape, fan_in: int, generator, device) -> nn.Parameter:
    """torch's default conv init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.rand(shape, generator=generator, device=device) * (2 * bound)
                        - bound)


class Conv(nn.Module):
    """A conv's ``weight`` (HWIO) and optional ``bias``, applied NHWC."""

    def __init__(self, cin: int, cout: int, k: int, *, groups: int = 1, bias: bool = False,
                 generator=None, device=None):
        super().__init__()
        fan_in = cin // groups * k * k
        self.padding, self.groups = k // 2, groups
        self.weight = _uniform((k, k, cin // groups, cout), fan_in, generator, device)
        if bias:
            self.bias = _uniform((cout,), fan_in, generator, device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, padding=self.padding, groups=self.groups)


class _LayerNormBody(nn.Module):
    def __init__(self, c: int, with_bias: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device)) if with_bias else None


class LayerNorm(nn.Module):
    """Upstream's ``LayerNorm(dim, LayerNorm_type)``: its parameters under
    ``body``; "BiasFree" has no bias and does not centre."""

    def __init__(self, c: int, layernorm_type: str, device=None):
        super().__init__()
        if layernorm_type not in ("BiasFree", "WithBias"):
            raise ValueError(f"layernorm_type {layernorm_type!r}: BiasFree or WithBias")
        self.body = _LayerNormBody(c, layernorm_type == "WithBias", device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_site(x, self.body.weight, self.body.bias)


class Attention(nn.Module):
    """MDTA: 1x1 ``qkv``, 3x3 depthwise ``qkv_dwconv``, the transposed
    attention per head, 1x1 ``project_out``."""

    def __init__(self, c: int, heads: int, bias: bool, generator=None, device=None):
        super().__init__()
        kw = dict(bias=bias, generator=generator, device=device)
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1, device=device))
        self.qkv = Conv(c, 3 * c, 1, **kw)
        self.qkv_dwconv = Conv(3 * c, 3 * c, 3, groups=3 * c, **kw)
        self.project_out = Conv(c, c, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv_dwconv(self.qkv(x))
        q, k, v = qkv.chunk(3, dim=-1)
        return self.project_out(transposed_attention(q, k, v, self.temperature, self.heads))


class FeedForward(nn.Module):
    """GDFN: 1x1 ``project_in`` to 2 x hidden, 3x3 depthwise ``dwconv``,
    ``gelu(x1) * x2`` (exact erf GELU), 1x1 ``project_out``."""

    def __init__(self, c: int, ffn_expansion_factor: float, bias: bool, generator=None,
                 device=None):
        super().__init__()
        kw = dict(bias=bias, generator=generator, device=device)
        hidden = int(c * ffn_expansion_factor)
        self.project_in = Conv(c, 2 * hidden, 1, **kw)
        self.dwconv = Conv(2 * hidden, 2 * hidden, 3, groups=2 * hidden, **kw)
        self.project_out = Conv(hidden, c, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=-1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, c: int, heads: int, level: int, cfg: dict, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.level, self.heads, self.channels = level, heads, c
        self.norm1 = LayerNorm(c, cfg["layernorm_type"], device)
        self.attn = Attention(c, heads, cfg["bias"], **kw)
        self.norm2 = LayerNorm(c, cfg["layernorm_type"], device)
        self.ffn = FeedForward(c, cfg["ffn_expansion_factor"], cfg["bias"], **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("restormer.mdta", level=self.level, heads=self.heads, channels=self.channels,
                  images=x.shape[0]):
            x = x + self.attn(self.norm1(x))
        with span("restormer.gdfn", level=self.level, channels=self.channels,
                  images=x.shape[0]):
            x = x + self.ffn(self.norm2(x))
        return x


class _Resample(nn.Module):
    """Upstream's ``Downsample`` / ``Upsample``: a 3x3 conv (no bias) as
    ``body.0``, then pixel-unshuffle / pixel-shuffle by 2."""

    def __init__(self, cin: int, cout: int, shuffle, generator=None, device=None):
        super().__init__()
        self.body = nn.ModuleList([Conv(cin, cout, 3, generator=generator, device=device)])
        self.shuffle = shuffle

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shuffle(self.body[0](x))


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, generator=None, device=None):
        super().__init__()
        self.proj = Conv(cin, dim, 3, generator=generator, device=device)


class Restormer(nn.Module):
    """Restormer (the defaults are upstream's gray denoising configuration,
    :data:`GRAY_CONFIG`: 26,109,076 parameters). NHWC (N, H, W,
    in_channels) in with H and W divisible by 8, float32 (N, H, W,
    out_channels) out."""

    #: the stages in upstream's order: (name, level, width multiple, heads index)
    STAGES = (("encoder_level1", 1, 1, 0), ("encoder_level2", 2, 2, 1),
              ("encoder_level3", 3, 4, 2), ("latent", 4, 8, 3),
              ("decoder_level3", 3, 4, 2), ("decoder_level2", 2, 2, 1),
              ("decoder_level1", 1, 2, 0), ("refinement", 1, 2, 0))

    def __init__(self, dim: int = 48, num_blocks=(4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads=(1, 2, 4, 8), ffn_expansion_factor: float = 2.66, bias: bool = False,
                 layernorm_type: str = "BiasFree", in_channels: int = 1, out_channels: int = 1,
                 dtype: torch.dtype = torch.float32, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.config = {"dim": dim, "num_blocks": list(num_blocks),
                       "num_refinement_blocks": num_refinement_blocks, "heads": list(heads),
                       "ffn_expansion_factor": ffn_expansion_factor, "bias": bias,
                       "layernorm_type": layernorm_type, "in_channels": in_channels,
                       "out_channels": out_channels}
        cfg, d = self.config, dim
        kw = dict(generator=generator, device=device)
        depth = list(num_blocks) + [num_blocks[2], num_blocks[1], num_blocks[0],
                                    num_refinement_blocks]

        def stage(i):
            name, level, mult, hi = self.STAGES[i]
            blocks = [TransformerBlock(d * mult, heads[hi], level, cfg, **kw)
                      for _ in range(depth[i])]
            setattr(self, name, nn.ModuleList(blocks))

        self.patch_embed = _PatchEmbed(in_channels, d, **kw)
        stage(0)
        self.down1_2 = _Resample(d, d // 2, pixel_unshuffle, **kw)
        stage(1)
        self.down2_3 = _Resample(2 * d, d, pixel_unshuffle, **kw)
        stage(2)
        self.down3_4 = _Resample(4 * d, 2 * d, pixel_unshuffle, **kw)
        stage(3)
        self.up4_3 = _Resample(8 * d, 16 * d, pixel_shuffle, **kw)
        self.reduce_chan_level3 = Conv(8 * d, 4 * d, 1, bias=bias, **kw)
        stage(4)
        self.up3_2 = _Resample(4 * d, 8 * d, pixel_shuffle, **kw)
        self.reduce_chan_level2 = Conv(4 * d, 2 * d, 1, bias=bias, **kw)
        stage(5)
        self.up2_1 = _Resample(2 * d, 4 * d, pixel_shuffle, **kw)
        stage(6)
        stage(7)
        self.output = Conv(2 * d, out_channels, 3, bias=bias, **kw)

    @staticmethod
    def _run(blocks: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        for block in blocks:
            x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        if h % SIDE_MULTIPLE or w % SIDE_MULTIPLE:
            raise ValueError(f"Restormer needs sides divisible by {SIDE_MULTIPLE}, got {h}x{w}")
        exact = self.dtype == torch.float32
        with highest_precision() if exact else contextlib.nullcontext():
            inp = x
            x = x.to(self.dtype)
            enc1 = self._run(self.encoder_level1, self.patch_embed.proj(x))
            enc2 = self._run(self.encoder_level2, self.down1_2(enc1))
            enc3 = self._run(self.encoder_level3, self.down2_3(enc2))
            d = self._run(self.latent, self.down3_4(enc3))
            d = self.reduce_chan_level3(torch.cat([self.up4_3(d), enc3], dim=-1))
            d = self._run(self.decoder_level3, d)
            d = self.reduce_chan_level2(torch.cat([self.up3_2(d), enc2], dim=-1))
            d = self._run(self.decoder_level2, d)
            d = self._run(self.decoder_level1, torch.cat([self.up2_1(d), enc1], dim=-1))
            d = self._run(self.refinement, d)
            return self.output(d).float() + inp.float()


def config_from_params(params: dict) -> dict:
    """The constructor's widths from a parameter tree in the port's layout
    (the JAX-style nested dict of ``export_jax_params``): block counts from
    the stages' indices, heads from the temperatures, the expansion factor
    from the feed-forward widths (the first of the hidden / channels ratios,
    rounded to 2, 3 or 4 digits, that gives every stage's width)."""
    def stage_len(name):
        return len(params[name])

    embed = params["patch_embed"]["proj"]["weight"]
    dim = int(embed.shape[-1])
    block0 = params["encoder_level1"]["0"]
    names = [s[0] for s in Restormer.STAGES]
    widths = [(dim * mult, int(params[name]["0"]["ffn"]["project_in"]["weight"].shape[-1]) // 2)
              for name, _lvl, mult, _h in Restormer.STAGES]
    candidates = [round(hid / c, digits) for c, hid in widths for digits in (2, 3, 4)]
    factor = next((f for f in candidates if all(int(c * f) == hid for c, hid in widths)), None)
    if factor is None:
        raise ValueError(f"no ffn_expansion_factor gives the hidden widths {widths}")
    return {"dim": dim, "num_blocks": [stage_len(n) for n in names[:4]],
            "num_refinement_blocks": stage_len("refinement"),
            "heads": [int(params[n]["0"]["attn"]["temperature"].shape[0]) for n in names[:4]],
            "ffn_expansion_factor": factor, "bias": "bias" in block0["attn"]["qkv"],
            "layernorm_type": "WithBias" if "bias" in block0["norm1"]["body"] else "BiasFree",
            "in_channels": int(embed.shape[2]),
            "out_channels": int(params["output"]["weight"].shape[-1])}
