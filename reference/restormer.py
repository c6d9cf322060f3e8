"""Restormer, as ``basicsr/models/archs/restormer_arch.py`` of
https://github.com/swz30/Restormer writes it (Zamir et al., CVPR 2022),
in plain float32 PyTorch over NCHW tensors.

Parameters are a dict of upstream's state-dict names and layouts
(``encoder_level1.0.attn.qkv.weight`` (3C, C, 1, 1), ``...attn.temperature``
(heads, 1, 1), ...), so a published ``.pth`` is read as it is. Each
transformer block is ``x + MDTA(LN(x))`` then ``x + GDFN(LN(x))``:

- LayerNorm over channels at each pixel, the variance taken about the mean
  (``unbiased=False``) with eps 1e-5; BiasFree divides ``x`` itself, not
  ``x - mean``, by the deviation and scales by ``weight``; WithBias
  centres, scales and adds ``bias``;
- MDTA: 1x1 ``qkv``, a 3x3 depthwise ``qkv_dwconv``, q and k split into
  heads of C/heads channels and L2-normalised over the pixels
  (``F.normalize``, eps 1e-12), ``softmax(q k^T * temperature)`` per head,
  ``attn @ v``, a 1x1 ``project_out``;
- GDFN: 1x1 ``project_in`` to 2 x hidden (hidden = int(C x
  ffn_expansion_factor)), a 3x3 depthwise ``dwconv``, ``gelu(x1) * x2``
  (exact erf GELU), a 1x1 ``project_out``;
- ``down*``: a 3x3 conv to C/2 (no bias), PixelUnshuffle(2); ``up*``: a
  3x3 conv to 2C (no bias), PixelShuffle(2); skips concatenated, a 1x1
  ``reduce_chan_level3`` / ``_level2`` after them, none at level 1;
- level 1's decoder and the refinement blocks at 2 x dim; a 3x3
  ``output`` conv and the global residual ``output(...) + input``.

The only departure from upstream is the form: functions over a dict
instead of modules (upstream's ``dual_pixel_task`` branch is left out; the
configurations here do not set it). Products and convolutions run with
TF32 off. ``q`` (optional) rounds the operands and results of every
convolution and product (an object with ``operand(t)`` and ``result(t)``;
none by default), so a caller can run the same code in a lower precision.

This file imports nothing but torch. ``reference/restormer.py`` and the
benchmark's ``perfbench/reference/restormer.py`` are the same file.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
L2_EPS = 1e-12


class _Exact:
    """Rounds nothing."""

    @staticmethod
    def operand(t):
        return t

    @staticmethod
    def result(t):
        return t


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convolutions and cuBLAS products inside."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def widths(cfg: dict) -> dict[str, tuple[int, int]]:
    """Each stage's (channels, heads): encoder levels 1-3, the latent,
    decoder levels 3-1 and the refinement."""
    d, h = cfg["dim"], cfg["heads"]
    return {"encoder_level1": (d, h[0]), "encoder_level2": (2 * d, h[1]),
            "encoder_level3": (4 * d, h[2]), "latent": (8 * d, h[3]),
            "decoder_level3": (4 * d, h[2]), "decoder_level2": (2 * d, h[1]),
            "decoder_level1": (2 * d, h[0]), "refinement": (2 * d, h[0])}


def depths(cfg: dict) -> dict[str, int]:
    """Each stage's number of transformer blocks."""
    n = cfg["num_blocks"]
    return {"encoder_level1": n[0], "encoder_level2": n[1], "encoder_level3": n[2],
            "latent": n[3], "decoder_level3": n[2], "decoder_level2": n[1],
            "decoder_level1": n[0], "refinement": cfg["num_refinement_blocks"]}


def hidden(c: int, cfg: dict) -> int:
    return int(c * cfg["ffn_expansion_factor"])


def _conv(x, p: dict, name: str, q, *, padding: int = 0, groups: int = 1):
    w = p[f"{name}.weight"]
    b = p.get(f"{name}.bias")
    return q.result(F.conv2d(q.operand(x), q.operand(w), b, padding=padding, groups=groups))


def layer_norm(x, p: dict, name: str, layernorm_type: str):
    """Upstream's ``LayerNorm`` over the channels of NCHW ``x``."""
    t = x.permute(0, 2, 3, 1)  # to_3d: b (h w) c
    sigma = t.var(-1, keepdim=True, unbiased=False)
    if layernorm_type == "BiasFree":
        t = t / torch.sqrt(sigma + LN_EPS) * p[f"{name}.body.weight"]
    else:
        mu = t.mean(-1, keepdim=True)
        t = (t - mu) / torch.sqrt(sigma + LN_EPS) * p[f"{name}.body.weight"] \
            + p[f"{name}.body.bias"]
    return t.permute(0, 3, 1, 2)


def attention(x, p: dict, name: str, heads: int, q):
    """MDTA."""
    b, c, h, w = x.shape
    qkv = _conv(_conv(x, p, f"{name}.qkv", q), p, f"{name}.qkv_dwconv", q, padding=1,
                groups=3 * c)
    qq, kk, vv = qkv.chunk(3, dim=1)
    qq, kk, vv = (t.reshape(b, heads, c // heads, h * w) for t in (qq, kk, vv))
    qq = F.normalize(qq, dim=-1, eps=L2_EPS)
    kk = F.normalize(kk, dim=-1, eps=L2_EPS)
    attn = q.result(q.operand(qq) @ q.operand(kk).transpose(-2, -1)) * p[f"{name}.temperature"]
    attn = attn.softmax(dim=-1)
    out = q.result(q.operand(attn) @ q.operand(vv)).reshape(b, c, h, w)
    return _conv(out, p, f"{name}.project_out", q)


def feed_forward(x, p: dict, name: str, q):
    """GDFN."""
    x = _conv(x, p, f"{name}.project_in", q)
    x1, x2 = _conv(x, p, f"{name}.dwconv", q, padding=1, groups=x.shape[1]).chunk(2, dim=1)
    return _conv(F.gelu(x1) * x2, p, f"{name}.project_out", q)


def transformer_block(x, p: dict, name: str, heads: int, layernorm_type: str, q):
    x = x + attention(layer_norm(x, p, f"{name}.norm1", layernorm_type), p, f"{name}.attn",
                      heads, q)
    return x + feed_forward(layer_norm(x, p, f"{name}.norm2", layernorm_type), p,
                            f"{name}.ffn", q)


def stage(x, p: dict, name: str, cfg: dict, q):
    heads = widths(cfg)[name][1]
    for i in range(depths(cfg)[name]):
        x = transformer_block(x, p, f"{name}.{i}", heads, cfg["layernorm_type"], q)
    return x


def forward(p: dict, x: torch.Tensor, cfg: dict, q=None) -> torch.Tensor:
    """(N, in_channels, H, W) -> (N, out_channels, H, W), H and W divisible
    by 8, from the parameters ``p`` (name -> float32 tensor on ``x``'s
    device)."""
    q = q or _Exact
    with no_tf32():
        enc1 = stage(_conv(x, p, "patch_embed.proj", q, padding=1), p, "encoder_level1", cfg, q)
        enc2 = stage(F.pixel_unshuffle(_conv(enc1, p, "down1_2.body.0", q, padding=1), 2), p,
                     "encoder_level2", cfg, q)
        enc3 = stage(F.pixel_unshuffle(_conv(enc2, p, "down2_3.body.0", q, padding=1), 2), p,
                     "encoder_level3", cfg, q)
        lat = stage(F.pixel_unshuffle(_conv(enc3, p, "down3_4.body.0", q, padding=1), 2), p,
                    "latent", cfg, q)
        d3 = torch.cat([F.pixel_shuffle(_conv(lat, p, "up4_3.body.0", q, padding=1), 2), enc3], 1)
        d3 = stage(_conv(d3, p, "reduce_chan_level3", q), p, "decoder_level3", cfg, q)
        d2 = torch.cat([F.pixel_shuffle(_conv(d3, p, "up3_2.body.0", q, padding=1), 2), enc2], 1)
        d2 = stage(_conv(d2, p, "reduce_chan_level2", q), p, "decoder_level2", cfg, q)
        d1 = torch.cat([F.pixel_shuffle(_conv(d2, p, "up2_1.body.0", q, padding=1), 2), enc1], 1)
        d1 = stage(stage(d1, p, "decoder_level1", cfg, q), p, "refinement", cfg, q)
        return _conv(d1, p, "output", q, padding=1) + x


def l1_loss_and_grads(p: dict, x: torch.Tensor, y: torch.Tensor, cfg: dict):
    """(mean |forward(p, x) - y|, {name: gradient}) in float32."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    with no_tf32():
        loss = (forward(leaves, x, cfg) - y).abs().mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def parameter_init(cfg: dict) -> dict[str, tuple]:
    """name -> (shape, init) for every parameter of ``cfg`` (``dim``,
    ``num_blocks``, ``num_refinement_blocks``, ``heads``,
    ``ffn_expansion_factor``, ``bias``, ``layernorm_type``, ``in_channels``,
    ``out_channels``), in upstream's order. ``init`` is torch's default:
    ("uniform", fan_in) for a conv's weight and bias (U(-1/sqrt(fan_in),
    1/sqrt(fan_in))), ("ones",) for a LayerNorm's weight and the
    temperatures, ("zeros",) for a LayerNorm's bias."""
    out: dict[str, tuple] = {}
    bias = cfg["bias"]

    def conv(name, cin, cout, k, *, groups=1, with_bias=bias):
        fan_in = cin // groups * k * k
        out[f"{name}.weight"] = ((cout, cin // groups, k, k), ("uniform", fan_in))
        if with_bias:
            out[f"{name}.bias"] = ((cout,), ("uniform", fan_in))

    def norm(name, c):
        out[f"{name}.body.weight"] = ((c,), ("ones",))
        if cfg["layernorm_type"] != "BiasFree":
            out[f"{name}.body.bias"] = ((c,), ("zeros",))

    def blocks(name):
        c, heads = widths(cfg)[name]
        hid = hidden(c, cfg)
        for i in range(depths(cfg)[name]):
            b = f"{name}.{i}"
            norm(f"{b}.norm1", c)
            out[f"{b}.attn.temperature"] = ((heads, 1, 1), ("ones",))
            conv(f"{b}.attn.qkv", c, 3 * c, 1)
            conv(f"{b}.attn.qkv_dwconv", 3 * c, 3 * c, 3, groups=3 * c)
            conv(f"{b}.attn.project_out", c, c, 1)
            norm(f"{b}.norm2", c)
            conv(f"{b}.ffn.project_in", c, 2 * hid, 1)
            conv(f"{b}.ffn.dwconv", 2 * hid, 2 * hid, 3, groups=2 * hid)
            conv(f"{b}.ffn.project_out", hid, c, 1)

    d = cfg["dim"]
    conv("patch_embed.proj", cfg["in_channels"], d, 3, with_bias=False)
    blocks("encoder_level1")
    conv("down1_2.body.0", d, d // 2, 3, with_bias=False)
    blocks("encoder_level2")
    conv("down2_3.body.0", 2 * d, d, 3, with_bias=False)
    blocks("encoder_level3")
    conv("down3_4.body.0", 4 * d, 2 * d, 3, with_bias=False)
    blocks("latent")
    conv("up4_3.body.0", 8 * d, 16 * d, 3, with_bias=False)
    conv("reduce_chan_level3", 8 * d, 4 * d, 1)
    blocks("decoder_level3")
    conv("up3_2.body.0", 4 * d, 8 * d, 3, with_bias=False)
    conv("reduce_chan_level2", 4 * d, 2 * d, 1)
    blocks("decoder_level2")
    conv("up2_1.body.0", 2 * d, 4 * d, 3, with_bias=False)
    blocks("decoder_level1")
    blocks("refinement")
    conv("output", 2 * d, cfg["out_channels"], 3)
    return out
