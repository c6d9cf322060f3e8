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
           stride: int = 1, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """2-D convolution, NHWC activations x HWIO weights -> NHWC.

    Args:
        x: (N, H, W, Cin)
        w: (kh, kw, Cin, Cout)
        b: optional (Cout,) bias
    """
    if w.shape[0] == 1 and w.shape[1] == 1 and stride == 1 and padding == 0:
        y = torch.matmul(x, w[0, 0].to(x.dtype))  # 1x1 conv: channel matmul
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                     stride=stride, padding=padding, dilation=dilation)
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


def _gn_silu_fn(num_groups: int, eps: float, pallas_gn: bool):
    """GroupNorm+SiLU as one callable (y, scale, bias). A grad-mode call on
    a device tensor runs the port's differentiable kernel pair
    (``fused_kernels.gn_silu_train``) whatever ``pallas_gn`` is, or the
    composition where the pair cannot (``fused_kernels.grad_route``);
    any other call goes through the fused kernel dispatcher when
    ``pallas_gn``, else the composition."""
    from . import fused_kernels as fk

    def gn_silu(y, s, b):
        route = fk.grad_route(y, s, b, num_groups)
        if route == "kernels":
            return fk.gn_silu_train(y, s, b, num_groups=num_groups, eps=eps)
        if pallas_gn and route is None:
            return fk.fused_group_norm_silu(y, s, b, num_groups=num_groups, eps=eps)
        return silu(group_norm(y, s, b, num_groups=num_groups, eps=eps))
    return gn_silu


def conv_block(x: torch.Tensor, params: dict, *, num_groups: int,
               eps: float = 1e-5, pallas_gn: bool = False, act_hook=None) -> torch.Tensor:
    """[Conv3x3(no bias) -> GroupNorm -> SiLU] x 2.

    ``params`` keys: conv1/gn1_scale/gn1_bias/conv2/gn2_scale/gn2_bias.
    ``pallas_gn`` routes each GroupNorm+SiLU through the port's fused
    kernel dispatcher (the knob keeps the JAX package's name).
    ``act_hook(t, name)``, when given, is applied after each GN+SiLU at
    the int8-activation sites "a1" and "a2" (see ``ops.quant``)."""
    gn_silu = _gn_silu_fn(num_groups, eps, pallas_gn)
    y = gn_silu(conv2d(x, params["conv1"], padding=1), params["gn1_scale"], params["gn1_bias"])
    if act_hook is not None:
        y = act_hook(y, "a1")
    y = conv2d(y, params["conv2"], padding=1)
    y = gn_silu(y, params["gn2_scale"], params["gn2_bias"])
    return y if act_hook is None else act_hook(y, "a2")


def conv_block_dual(x_up: torch.Tensor, x_skip: torch.Tensor, params: dict, *,
                    num_groups: int, eps: float = 1e-5,
                    pallas_gn: bool = False, act_hook=None) -> torch.Tensor:
    """Decoder block: conv_block(concat([x_up, x_skip]), ...) without the
    concatenation. conv1's (3, 3, 2f, f) kernel splits along its input
    channels into the up-path and skip-path halves, in that order.
    ``pallas_gn`` and ``act_hook`` as in :func:`conv_block`."""
    gn_silu = _gn_silu_fn(num_groups, eps, pallas_gn)
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
