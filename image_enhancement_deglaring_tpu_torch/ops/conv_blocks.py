"""Convolution / normalization building blocks on NHWC tensors.

The PyTorch counterpart of ``image_enhancement_deglaring_tpu.ops.conv_blocks``
with the same layouts at every public function: NHWC activations, HWIO conv
kernels, the (Cin, Cout, 2, 2) ConvTranspose layout for the 2x up-conv.
Internally a 3x3 conv runs as ``F.conv2d`` on the channels-last view
``x.permute(0, 3, 1, 2)`` of the NHWC tensor; the 1x1 conv and the 2x2
up-conv are plain matrix products.

Normalization statistics accumulate in float32 whatever the input dtype.
Float32 compute must not drop to TF32 on the card: run it inside
:func:`highest_precision`, the counterpart of the JAX package's
``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

# The TF32 flags are process-wide, so overlapping highest_precision() blocks
# (an engine's collector thread and a caller of infer_batch, two float32
# engines, nested calls) share one "TF32 off" span: the first block to enter
# saves the flags, the last to exit restores them.
_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved: tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def highest_precision():
    """Turn TF32 off for cuDNN convs and cuBLAS matmuls inside the block.
    The flags stay off while any thread is inside such a block, and the
    settings from before the first block are restored when the last exits."""
    global _tf32_depth, _tf32_saved
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
                    _tf32_saved


def resolve_group_count(features: int, num_groups: int) -> int:
    """Largest divisor of ``features`` that is <= ``num_groups``."""
    g = min(num_groups, features)
    while g > 1 and features % g != 0:
        g -= 1
    return max(g, 1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU / swish: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """2-D convolution, NHWC activations x HWIO weights -> NHWC.

    Args:
        x: (N, H, W, Cin)
        w: (kh, kw, Cin / groups, Cout); a depthwise conv has groups = Cin
           and w (kh, kw, 1, Cout)
        b: optional (Cout,) bias
    """
    if groups == 1 and w.shape[0] == 1 and w.shape[1] == 1 and stride == 1 and padding == 0:
        y = torch.matmul(x, w[0, 0].to(x.dtype))  # 1x1 conv: channel matmul
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                     stride=stride, padding=padding, dilation=dilation, groups=groups)
        y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def stat_mean(t: torch.Tensor, dims) -> torch.Tensor:
    """The float32 mean of ``t`` over ``dims`` (kept), for normalization
    statistics. On the CPU it accumulates in float64: torch's CPU reduction
    over strided dims sums in sequence and loses ~5e-6 relative over a
    256^2 x 8 group (an H100 reading against float64; CUDA's tree stays
    within 1e-7), enough to move a normalized output by 3e-4."""
    if t.device.type == "cpu":
        return t.mean(dim=dims, keepdim=True, dtype=torch.float64).float()
    return t.mean(dim=dims, keepdim=True)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC: per (batch, group) across (H, W, channels in the
    group), float32 statistics (``stat_mean``), biased variance from the
    centred second moment. Output in the input dtype."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h, w, num_groups, c // num_groups)
    mean = stat_mean(xf, (1, 2, 4))
    var = stat_mean((xf - mean).square(), (1, 2, 4))
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _gn_silu_fn(num_groups: int, eps: float, kernels: bool):
    """A model's GroupNorm+SiLU site as one callable (y, scale, bias):
    ``fused_kernels.gn_silu_site``, which chooses what runs there."""
    # The blocks below look this name up at every call, so that one patch of
    # it wraps every GroupNorm+SiLU of a model: perfbench's traced training
    # run times them this way (norm_act_ms_per_step). fused_kernels builds
    # on this module's compositions, hence the import at call time.
    from .fused_kernels import gn_silu_site

    def gn_silu(y, s, b):
        return gn_silu_site(y, s, b, num_groups=num_groups, eps=eps, kernels=kernels)
    return gn_silu


def conv_block(x: torch.Tensor, params: dict, *, num_groups: int,
               eps: float = 1e-5, kernels: bool = False, act_hook=None) -> torch.Tensor:
    """[Conv3x3(no bias) -> GroupNorm -> SiLU] x 2.

    ``params`` keys: conv1/gn1_scale/gn1_bias/conv2/gn2_scale/gn2_bias.
    Each conv+GroupNorm+SiLU is a ``fused_kernels.conv_gn_silu_site``,
    which chooses its kernels from the model's ``kernels`` flag.
    ``act_hook(t, name)``, when given, is applied after each GN+SiLU at
    the int8-activation sites "a1" and "a2" (see ``ops.quant``)."""
    from .fused_kernels import conv_gn_silu_site

    gn_silu = _gn_silu_fn(num_groups, eps, kernels)
    y = x
    for i in (1, 2):
        y = conv_gn_silu_site(y, params[f"conv{i}"], params[f"gn{i}_scale"], params[f"gn{i}_bias"],
                              gn_silu, num_groups=num_groups, eps=eps, kernels=kernels)
        if act_hook is not None:
            y = act_hook(y, f"a{i}")
    return y


def conv_block_dual(x_up: torch.Tensor, x_skip: torch.Tensor, params: dict, *,
                    num_groups: int, eps: float = 1e-5,
                    kernels: bool = False, act_hook=None) -> torch.Tensor:
    """Decoder block: conv_block(concat([x_up, x_skip]), ...) without the
    concatenation. conv1's (3, 3, 2f, f) kernel splits along its input
    channels into the up-path and skip-path halves, in that order. Its
    convs are ``conv2d``s, each GroupNorm+SiLU a site of its own;
    ``kernels`` and ``act_hook`` as in :func:`conv_block`."""
    gn_silu = _gn_silu_fn(num_groups, eps, kernels)
    f = x_up.shape[-1]
    w1 = params["conv1"]
    y = conv2d(x_up, w1[:, :, :f, :], padding=1) + conv2d(x_skip, w1[:, :, f:, :], padding=1)
    y = gn_silu(y, params["gn1_scale"], params["gn1_bias"])
    if act_hook is not None:
        y = act_hook(y, "a1")
    y = conv2d(y, params["conv2"], padding=1)
    y = gn_silu(y, params["gn2_scale"], params["gn2_bias"])
    return y if act_hook is None else act_hook(y, "a2")


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on NHWC, summed in float32; an odd
    trailing row or column is dropped (VALID windows)."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    xf = x[:, : 2 * h2, : 2 * w2].float().reshape(n, h2, 2, w2, 2, c)
    return (xf.sum(dim=(2, 4)) * 0.25).to(x.dtype)


def upsample2x_matmul(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """ConvTranspose2d(kernel=2, stride=2) as one matmul + depth-to-space.

    out[n, 2i+di, 2j+dj, co] = sum_ci x[n, i, j, ci] * w[ci, co, di, dj].

    Args:
        x: (N, H, W, Cin)
        w: (Cin, Cout, 2, 2), the ConvTranspose2d weight layout
        b: optional (Cout,)
    """
    n, h, ww, cin = x.shape
    cout = w.shape[1]
    wmat = w.permute(0, 2, 3, 1).reshape(cin, 4 * cout).to(x.dtype)
    y = torch.matmul(x.reshape(-1, cin), wmat)
    y = y.reshape(n, h, ww, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(n, 2 * h, 2 * ww, cout)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=2, stride=2) on NHWC; an odd trailing row or column
    is dropped (VALID windows)."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, : 2 * h2, : 2 * w2].reshape(n, h2, 2, w2, 2, c).amax(dim=(2, 4))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample on NHWC."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """``nn.PixelUnshuffle(r)`` on NHWC: (N, H, W, C) -> (N, H/r, W/r, C r^2),
    output channel ``c r^2 + i r + j`` taken from pixel (r h + i, r w + j)."""
    n, h, w, c = x.shape
    y = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return y.reshape(n, h // r, w // r, c * r * r)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """``nn.PixelShuffle(r)`` on NHWC: (N, H, W, C r^2) -> (N, H r, W r, C),
    the inverse of :func:`pixel_unshuffle`."""
    n, h, w, c = x.shape
    co = c // (r * r)
    y = x.reshape(n, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, h * r, w * r, co)


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                       *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channels of each pixel of NHWC ``x``, float32
    statistics, the variance about the mean (biased). Without ``bias``
    (Restormer's BiasFree) ``x`` itself, NOT ``x - mean``, is divided by the
    deviation and scaled by ``weight``; with it, ``x`` is centred, scaled
    and shifted. Output in the input dtype."""
    xf = x.float()
    var = xf.var(-1, keepdim=True, unbiased=False)
    if bias is None:
        y = xf * torch.rsqrt(var + eps) * weight.float()
    else:
        y = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(var + eps) * weight.float() \
            + bias.float()
    return y.to(x.dtype)


def transposed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         temperature: torch.Tensor, heads: int, *,
                         eps: float = 1e-12) -> torch.Tensor:
    """Restormer's MDTA core on NHWC (N, H, W, C) q, k, v (views of one qkv
    tensor are fine): per head of C/heads channels, ``softmax(q^ k^T *
    temperature) @ v`` where q^ and k^ are q and k L2-normalised over the
    H W pixels (``F.normalize``'s eps); the channel-by-channel map's
    reduction runs over every pixel.

    The Gram ``q k^T`` is one product per head in the input dtype
    (float32 accumulation), read in place from the strided views; the
    norms (accumulated in float32), the division by them, the temperature
    and the softmax run in float32, which equals normalising first; the
    map goes back to the input dtype for ``attn @ v``. ``temperature`` is
    (heads, 1, 1)."""
    n, h, w, c = q.shape
    ch = c // heads
    q2, k2, v2 = (t.reshape(n, h * w, c) for t in (q, k, v))
    nq = torch.linalg.vector_norm(q2, dim=1, dtype=torch.float32).clamp_min(eps)
    nk = torch.linalg.vector_norm(k2, dim=1, dtype=torch.float32).clamp_min(eps)
    cols = [slice(i * ch, (i + 1) * ch) for i in range(heads)]
    gram = torch.stack([torch.bmm(q2[:, :, s].transpose(1, 2), k2[:, :, s]) for s in cols], 1)
    nq, nk = nq.reshape(n, heads, ch, 1), nk.reshape(n, heads, 1, ch)
    logits = gram.float() / (nq * nk) * temperature.float().reshape(1, heads, 1, 1)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    outs = [torch.bmm(v2[:, :, s], attn[:, i].transpose(1, 2)) for i, s in enumerate(cols)]
    out = outs[0] if heads == 1 else torch.cat(outs, dim=-1)
    return out.reshape(n, h, w, c)
