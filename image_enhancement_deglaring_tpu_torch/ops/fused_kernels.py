"""Hand-written CUDA kernels of the port, their plain versions, dispatchers.

Counterpart of ``image_enhancement_deglaring_tpu.ops.pallas_kernels``:

========================  ===================================  ====================
wrapper                   TPU kernel it replaces               CUDA source
========================  ===================================  ====================
gn_silu_flat              _gn_silu_flat_kernel (K1)            csrc/gn_silu.cu
gn_silu_nhwc              _gn_silu_kernel (K2)                 csrc/gn_silu.cu
conv3x3_gn_silu           _conv_gn_silu_kernel (K3)            csrc/conv_gn_silu.cu
conv3x3_gn_silu_batched   _conv_gn_silu_batched_kernel (K4)    csrc/conv_gn_silu.cu
gn_silu_train_fwd         none (XLA's fusion of the training   csrc/gn_silu.cu
gn_silu_train_bwd         composition)                         csrc/gn_silu.cu
bn_sums, bn_apply         none (XLA's fusion of flax's         csrc/batch_norm.cu
bn_bwd_sums               BatchNorm and ReLU in training)      csrc/batch_norm.cu
bn_bwd_apply                                                   csrc/batch_norm.cu
channel_layer_norm        none (Restormer is port-only) (K6)   csrc/layer_norm.cu
========================  ===================================  ====================

(K5, the dec1 tail of ``pallas_dec1``, is in :mod:`.dec1`.)

Every wrapper takes and returns NHWC tensors. On a CPU tensor it computes
its plain PyTorch version (``gn_silu_plain``, ``conv3x3_gn_silu_plain``);
on a CUDA tensor it launches its kernel on the current stream or raises.
K1-K5 are forward-only, as the TPU kernels are (none has a backward): on
a CUDA tensor their wrappers raise under autograd, when grad mode is on
and an argument requires grad (``refuse_autograd``), rather than return a
result that carries no gradient. T1/T2, the GroupNorm+SiLU training pair
(a forward that saves its statistics, and a fused backward), train through
the autograd Function ``gn_silu_train``; T3/T4, EnhancedUNet's
training-mode BatchNorm with the ReLU or add+ReLU after it, through
``bn_act_train``: four launches (statistics, apply, backward sums,
backward apply), the sums summed over the ranks between them under a mesh.
K6, Restormer's channel LayerNorm, is forward-only too (its training keeps
the composition): one launch a call on a persistent grid the kernel sizes.
Each launch adds one to ``LAUNCHES[<wrapper name>]``. The GroupNorm
wrappers make one launch under the launch plan ``_gn_plan``, the BatchNorm
ones one each under ``_bn_plan``. In bfloat16
the conv wrappers run the tensor-core kernel under the launch plan
``_conv_plan`` (three launches); in float32 the CUDA-core one (five
launches).

The dispatchers ``fused_group_norm_silu`` and ``fused_conv3x3_gn_silu``
choose a kernel by the same shape rules as the JAX dispatchers; unless
forced, they take the composition on a CPU tensor, as the JAX ones take
XLA's off the TPU. The site functions ``gn_silu_site``,
``conv_gn_silu_site``, ``batch_norm_site`` and ``layer_norm_site`` alone
choose what runs at a model's normalization sites, from the call and the
model's ``kernels`` flag.
"""

from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from . import _build, conv_blocks
from .conv_blocks import conv2d, group_norm, highest_precision, silu

#: kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES = {"gn_silu_flat": 0, "gn_silu_nhwc": 0, "conv3x3_gn_silu": 0,
            "conv3x3_gn_silu_batched": 0, "gn_silu_train_fwd": 0, "gn_silu_train_bwd": 0,
            "bn_train_stats": 0, "bn_train_apply": 0, "bn_train_bwd_sums": 0,
            "bn_train_bwd_apply": 0, "channel_layer_norm": 0}
#: grad-mode GroupNorm+SiLU or training-mode BatchNorm calls on a device
#: tensor that took the composition instead of ``gn_silu_train`` or
#: ``bn_act_train``, by reason: inside a ``torch.func`` transform, or a
#: shape or dtype the kernels do not take
TRAIN_FALLBACKS = {"transform": 0, "shape": 0}
#: Restormer's LayerNorm calls on a device tensor outside a grad call that
#: took the composition instead of K6, by the same reasons
LAYER_NORM_FALLBACKS = {"transform": 0, "shape": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for table in (LAUNCHES, TRAIN_FALLBACKS, LAYER_NORM_FALLBACKS):
        for k in table:
            table[k] = 0


# ------------------------------------------------------------ plain versions


def gn_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                  num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm+SiLU as K1 and K2 compute it: float32 statistics with the
    single-pass variance E[x^2] - mean^2, then y = x*a + b with
    a = rstd*gamma, b = beta - mean*a, and y * sigmoid(y)."""
    n, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(n, h * w, num_groups, cg)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    ex2 = xf.square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(ex2 - mean * mean + eps)
    a = rstd * scale.float().reshape(1, 1, num_groups, cg)
    b = bias.float().reshape(1, 1, num_groups, cg) - mean * a
    y = xf * a + b
    return (y * torch.sigmoid(y)).reshape(x.shape).to(x.dtype)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The training pair's plain versions compute in float64 for a float64
    input (``gradcheck``), else in float32 as the kernels do."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def gn_silu_train_fwd_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                            num_groups: int, eps: float = 1e-5):
    """The training forward as its kernel computes it: K1's function with
    the variance as the centred second moment. Returns (out, stats), stats
    (N, G, 2) of (mean, rstd) in float32 (float64 for a float64 input)."""
    acc = _acc_dtype(x)
    n, h, w, c = x.shape
    cg = c // num_groups
    xf = x.to(acc).reshape(n, h * w, num_groups, cg)
    mean = xf.mean(dim=(1, 3), keepdim=True, dtype=torch.float64).to(acc)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True, dtype=torch.float64).to(acc)
    rstd = torch.rsqrt(var + eps)
    a = rstd * scale.to(acc).reshape(1, 1, num_groups, cg)
    b = bias.to(acc).reshape(1, 1, num_groups, cg) - mean * a
    z = xf * a + b
    out = (z * torch.sigmoid(z)).reshape(x.shape).to(x.dtype)
    return out, torch.stack([mean.reshape(n, num_groups), rstd.reshape(n, num_groups)], -1)


def gn_silu_train_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, stats: torch.Tensor, *, num_groups: int):
    """The training backward as its kernel computes it, from the saved
    input ``x`` and the forward's ``stats``: z = x*a + b again,
    dz = dy s (1 + z (1 - s)) with s = sigmoid(z), x^ = (x - mean) rstd,
    dbeta = sum dz, dgamma = sum dz x^, and per group
    dx = rstd (gamma dz - mean(gamma dz) - x^ mean(gamma dz x^)).
    Returns (dx in x's dtype, dgamma, dbeta in the parameters' dtypes)."""
    acc = _acc_dtype(x)
    n, h, w, c = x.shape
    cg = c // num_groups
    xf = x.to(acc).reshape(n, h * w, num_groups, cg)
    d = dy.to(acc).reshape(xf.shape)
    mean, rstd = (stats[..., k].to(acc).reshape(n, 1, num_groups, 1) for k in (0, 1))
    g = scale.to(acc).reshape(1, 1, num_groups, cg)
    z = xf * (rstd * g) + (bias.to(acc).reshape(g.shape) - mean * rstd * g)
    s = torch.sigmoid(z)
    dz = d * s * (1 + z * (1 - s))
    xh = (xf - mean) * rstd
    gdz = g * dz
    dx = rstd * (gdz - gdz.mean(dim=(1, 3), keepdim=True)
                 - xh * (gdz * xh).mean(dim=(1, 3), keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype), (dz * xh).sum(dim=(0, 1)).reshape(c).to(scale.dtype),
            dz.sum(dim=(0, 1)).reshape(c).to(bias.dtype))


_BN_ACTS = {None: 0, "relu": 1}  # and 2: "relu" with a residual added before it


def _bn_act_code(act, with_residual: bool) -> int:
    """The kernels' epilogue code: 0 none, 1 ReLU, 2 add the residual, then ReLU."""
    if act not in _BN_ACTS:
        raise ValueError(f"BatchNorm epilogue {act!r}: want None or 'relu'")
    if with_residual and act != "relu":
        raise ValueError("BatchNorm with a residual takes act='relu' (add, then ReLU)")
    return 2 if with_residual else _BN_ACTS[act]


def _bn_rows(x: torch.Tensor) -> tuple[int, int]:
    c = x.shape[-1]
    return x.numel() // c, c


def _bn_channel_stats(sums: torch.Tensor, count: int, eps: float, acc: torch.dtype):
    """(mean, var, rstd) per channel from B1's sums over ``count`` rows:
    mean and E[x^2] divided in float64 and rounded once, flax's biased
    variance max(E[x^2] - mean^2, 0), rstd = 1 / sqrt(var + eps)."""
    c = sums.shape[0] // 2
    mean = (sums[:c].double() / count).to(acc)
    var = torch.clamp((sums[c:].double() / count).to(acc) - mean * mean, min=0.0)
    return mean, var, 1.0 / torch.sqrt(var + eps)


def bn_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """B1 (``bn_train_stats``): per-channel (sum x, sum x^2) over every row
    of NHWC ``x``, (2C,) float32 (float64 for a float64 input)."""
    _, c = _bn_rows(x)
    xf = x.reshape(-1, c).double()
    return torch.cat([xf.sum(0), xf.square().sum(0)]).to(_acc_dtype(x))


def bn_apply_plain(x: torch.Tensor, sums: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, *, count: int, act=None, residual=None,
                   eps: float = 1e-5, momentum: float = 0.9, running=None):
    """B2 (``bn_train_apply``) from the sums over ``count`` rows: a =
    rstd * gamma, b = beta - mean * a, z = x * a + b, then ReLU or ReLU(z +
    residual); ``running`` (mean, var) buffers move to momentum * old +
    (1 - momentum) * batch. Returns (out in float32 (float64 for a float64
    input), stats (C, 2) of (mean, rstd))."""
    code = _bn_act_code(act, residual is not None)
    acc = _acc_dtype(x)
    _, c = _bn_rows(x)
    mean, var, rstd = _bn_channel_stats(sums, count, eps, acc)
    a = rstd * scale.to(acc)
    b = bias.to(acc) - mean * a
    z = x.to(acc).reshape(-1, c) * a + b
    if code == 2:
        z = z + residual.to(acc).reshape(-1, c)
    if code:
        z = torch.where(z > 0, z, 0.0)
    if running is not None:
        with torch.no_grad():
            for buf, batch in zip(running, (mean, var)):
                buf.copy_(momentum * buf + (1 - momentum) * batch.to(buf.dtype))
    return z.reshape(x.shape), torch.stack([mean, rstd], -1)


def _bn_dz(x2, dy2, scale, bias, stats, code: int, out, acc):
    """dz of the backward: dy where the forward's output is positive (ReLU:
    z recomputed from x and the saved statistics; add+ReLU: the saved
    output), dy itself with no epilogue; and x^ = (x - mean) * rstd."""
    mean, rstd = stats[:, 0].to(acc), stats[:, 1].to(acc)
    if code == 1:
        a = rstd * scale.to(acc)
        dy2 = torch.where(x2 * a + (bias.to(acc) - mean * a) > 0, dy2, 0.0)
    elif code == 2:
        dy2 = torch.where(out.reshape(dy2.shape) > 0, dy2, 0.0)
    return dy2, (x2 - mean) * rstd


def bn_bwd_sums_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, stats: torch.Tensor, *, act=None,
                      out=None) -> torch.Tensor:
    """B3 (``bn_train_bwd_sums``): per-channel (sum dz, sum dz x^) over
    these rows, (2C,); ``out`` is the forward's output where it added a
    residual."""
    acc = _acc_dtype(x)
    _, c = _bn_rows(x)
    dz, xh = _bn_dz(x.to(acc).reshape(-1, c), dy.to(acc).reshape(-1, c), scale, bias, stats,
                    _bn_act_code(act, out is not None), out, acc)
    return torch.cat([dz.sum(0, dtype=torch.float64),
                      (dz * xh).sum(0, dtype=torch.float64)]).to(acc)


def bn_bwd_apply_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, stats: torch.Tensor, sums: torch.Tensor, *,
                       count: int, act=None, out=None):
    """B4 (``bn_train_bwd_apply``) from B3's sums over ``count`` rows:
    dx = rstd gamma ((dz - S_dz / n) - x^ S_dzx / n) in x's dtype, and with
    a residual its gradient dz (else None)."""
    acc = _acc_dtype(x)
    _, c = _bn_rows(x)
    code = _bn_act_code(act, out is not None)
    dz, xh = _bn_dz(x.to(acc).reshape(-1, c), dy.to(acc).reshape(-1, c), scale, bias, stats,
                    code, out, acc)
    k = stats[:, 1].to(acc) * scale.to(acc)
    m1 = (sums[:c].double() / count).to(acc)
    m2 = (sums[c:].double() / count).to(acc)
    dx = (k * ((dz - m1) - xh * m2)).reshape(x.shape).to(x.dtype)
    return dx, (dz.reshape(x.shape) if code == 2 else None)


def _over_ranks(sums: torch.Tensor, rows: int, sums_hook):
    """The sums and their row count over every rank: ``sums_hook(sums)``
    gives (the sums over the ranks, the number of ranks)."""
    if sums_hook is None:
        return sums, rows
    total, ranks = sums_hook(sums)
    return total, rows * ranks


def _bn_fwd(sums_fn, apply_fn, x, scale, bias, act, residual, eps, momentum, running,
            sums_hook):
    total, count = _over_ranks(sums_fn(x), _bn_rows(x)[0], sums_hook)
    return apply_fn(x, total, scale, bias, count=count, act=act, residual=residual, eps=eps,
                    momentum=momentum, running=running)


def _bn_bwd(sums_fn, apply_fn, x, dy, scale, bias, stats, act, out, sums_hook):
    local = sums_fn(x, dy, scale, bias, stats, act=act, out=out)
    total, count = _over_ranks(local, _bn_rows(x)[0], sums_hook)
    dx, dres = apply_fn(x, dy, scale, bias, stats, total, count=count, act=act, out=out)
    c = x.shape[-1]
    return dx, dres, local[c:].to(scale.dtype), local[:c].to(bias.dtype)


def bn_act_train_fwd_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                           act=None, residual=None, eps: float = 1e-5, momentum: float = 0.9,
                           running=None, sums_hook=None):
    """The training forward as its kernels compute it: B1's sums, summed
    over the ranks by ``sums_hook`` (see ``bn_act_train``), then B2.
    Returns (out, stats)."""
    return _bn_fwd(bn_sums_plain, bn_apply_plain, x, scale, bias, act, residual, eps, momentum,
                   running, sums_hook)


def bn_act_train_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, stats: torch.Tensor, *, act=None, out=None,
                           sums_hook=None):
    """The training backward as its kernels compute it: B3's sums of these
    rows (dbeta, dgamma), summed over the ranks by ``sums_hook`` for B4.
    Returns (dx, the residual's gradient or None, dgamma, dbeta)."""
    return _bn_bwd(bn_bwd_sums_plain, bn_bwd_apply_plain, x, dy, scale, bias, stats, act, out,
                   sums_hook)


def channel_layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor | None = None, *,
                             eps: float = 1e-5) -> torch.Tensor:
    """K6 as its kernel computes it, per pixel over the C channels in
    float32: mean = sum x / C, var = sum (x - mean)^2 / C (about the mean),
    r = rsqrt(var + eps); without ``bias`` (BiasFree) (x * r) * w, x not
    centred, with it ((x - mean) * r) * w + b; one rounding to x's dtype."""
    c = x.shape[-1]
    xf = x.float()
    d = xf - xf.sum(-1, keepdim=True) / c
    r = torch.rsqrt((d * d).sum(-1, keepdim=True) / c + eps)
    y = xf * r * weight.float() if bias is None else d * r * weight.float() + bias.float()
    return y.to(x.dtype)


def conv3x3_gn_silu_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """Conv3x3+GN+SiLU as K3 computes it: the weights rounded to the input
    dtype (as the TPU kernel and the CUDA wrapper do), the conv on both
    widened to float32 (products and sums in float32, no TF32), two-pass
    GroupNorm, affine and SiLU in float32, one rounding to the input dtype."""
    with highest_precision():
        y = conv2d(x.float(), w.to(x.dtype).float(), padding=1)
    return silu(group_norm(y, scale, bias, num_groups=num_groups, eps=eps)).to(x.dtype)


# ------------------------------------------------------------------ wrappers


def _launch_layout(p: int, c: int) -> tuple[int, int, int]:
    """(threads per block, pixels per chunk, chunks per image) of the float32
    conv's GroupNorm passes: C * rows threads, 32 pixels per thread."""
    if c > 1024:
        raise ValueError(f"GroupNorm kernels take at most 1024 channels, got {c}")
    threads = c * max(1, 256 // c)
    chunk_pix = (threads // c) * 32
    return threads, chunk_pix, -(-p // chunk_pix)


def _check_activation(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty NHWC tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be NHWC-contiguous")


def _affine(name: str, x: torch.Tensor, t: torch.Tensor, c: int) -> torch.Tensor:
    if t.shape != (c,):
        raise ValueError(f"{name}: affine parameter of shape {tuple(t.shape)}, want ({c},)")
    return t.to(device=x.device, dtype=torch.float32).contiguous()


def _check_groups(name: str, c: int, num_groups: int) -> None:
    if num_groups < 1 or c % num_groups != 0:
        raise ValueError(f"{name}: {c} channels do not split into {num_groups} groups")


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream: the value of
    ``torch.cuda.current_stream(device).cuda_stream`` without building a
    Stream object, a host cost paid at every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def refuse_autograd(name: str, *tensors) -> None:
    """Raise RuntimeError when grad mode is on and any of ``tensors``
    requires grad: a kernel writes its result through a raw pointer, so
    the result would have no ``grad_fn`` and every weight before it would
    silently stop learning. Called by every launch before it launches."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only (no backward, as the TPU kernel has "
            f"none), but grad mode is on and an argument requires grad; call it under "
            f"torch.no_grad() or torch.inference_mode(); GroupNorm+SiLU trains through "
            f"gn_silu_train, BatchNorm+ReLU through bn_act_train, and a LightweightUNet "
            f"trains built with kernels=False")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def gn_silu_flat(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                 num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """K1: GroupNorm+SiLU over an NHWC tensor whose (H, W*C) rows the TPU
    kernel tiled (replaces ``_fused_gn_silu_flat``)."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, scale, bias, num_groups=num_groups, eps=eps)
    return _gn_silu_launch("gn_silu_flat", x, scale, bias, num_groups, eps)


def gn_silu_nhwc(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                 num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """K2: GroupNorm+SiLU over NHWC blocks, for shapes K1 does not take
    (replaces ``_fused_gn_silu_pallas``)."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, scale, bias, num_groups=num_groups, eps=eps)
    return _gn_silu_launch("gn_silu_nhwc", x, scale, bias, num_groups, eps)


# The bf16 conv kernel's geometry (csrc/conv_gn_silu.cu, namespace tc) and
# the H100's shared memory (CUDA's occupancy rules for sm_90).
_TILE = 8                   # output tile 8x8 pixels: the wgmma M of 64
_CO_TILE = 64               # output channels per item: the wgmma N
_MAX_KC = 8                 # 16-channel steps per weight window (128 inputs)
_MAX_BLOCKS_PER_SM = 4      # __launch_bounds__(128, 4): 128 registers a thread
_SM_SHARED = 233_472        # shared memory of one SM
_BLOCK_RESERVED = 1_024     # shared memory the runtime keeps per block
BLOCK_SHARED_MAX = 232_448  # dynamic shared memory one block may ask for


@dataclass(frozen=True)
class ConvPlan:
    """Launch plan of the bf16 conv kernel for one call.

    An item is one 8x8 output tile of one image for one 64-channel tile of
    the output. Block ``b`` of ``grid`` walks the items ``block_range(b)``
    in item order (``decode``): output-channel tile, then groups of
    ``images`` images, then tile, then the image within the group, so the
    K images of one tile come in a row. ``kc`` is the number of 16-channel
    steps per weight window and ``windows`` the windows that cover Cin (1
    up to 128 input channels: the weight slice stays resident)."""

    n: int
    images: int
    tiles: int
    co_tiles: int
    kc: int
    windows: int
    smem: int
    blocks_per_sm: int
    grid: int

    @property
    def items(self) -> int:
        return self.n * self.tiles * self.co_tiles

    def block_range(self, b: int) -> range:
        return range(b * self.items // self.grid, (b + 1) * self.items // self.grid)

    def decode(self, i):
        """(image, tile, output-channel tile) of item ``i`` (an int or an
        integer array), with the kernel's arithmetic."""
        per_ct, per_group = self.n * self.tiles, self.tiles * self.images
        r = i % per_ct
        r2 = r % per_group
        return (r // per_group) * self.images + r2 % self.images, r2 // self.images, i // per_ct


@functools.lru_cache(maxsize=256)
def _conv_plan(n: int, h: int, w: int, cin: int, cout: int, images: int,
               sms: int) -> ConvPlan:
    """The bf16 conv kernel's launch plan on a card with ``sms`` SMs: the
    dynamic shared memory (weight window, two halo buffers, epilogue
    scratch, staged output tile: ``tc::smem_bytes``), the blocks per SM it
    leaves, and the grid, ``min(items, sms * blocks per SM)`` whatever
    ``images`` is."""
    if images < 1 or n % images != 0:
        raise ValueError(f"batch {n} not divisible by images {images}")
    kc = 1
    while kc < _MAX_KC and 16 * kc < cin:
        kc *= 2
    smem = (9 * kc * _CO_TILE * 32 + 2 * (2 * kc * (_TILE + 2) ** 2 * 16) + 7 * _CO_TILE * 4
            + _TILE * _TILE * (2 * _CO_TILE + 16))
    blocks = min(_MAX_BLOCKS_PER_SM, _SM_SHARED // (smem + _BLOCK_RESERVED))
    tiles = -(-w // _TILE) * -(-h // _TILE)
    co_tiles = -(-cout // _CO_TILE)
    return ConvPlan(n=n, images=images, tiles=tiles, co_tiles=co_tiles,
                    kc=kc, windows=-(-cin // (16 * kc)), smem=smem, blocks_per_sm=blocks,
                    grid=min(n * tiles * co_tiles, sms * blocks))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The GroupNorm kernel's geometry (csrc/gn_silu.cu, namespace gnk).
_GN_THREADS = 512         # gnk::kThreadTarget: threads per block, rounded to the channel units
_GN_MAX_THREADS = 1_024   # gnk::kMaxThreads
_GN_MIN_CHUNK = 16_384    # bytes: an image below this is one chunk, with no handshake
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


@dataclass(frozen=True)
class GnPlan:
    """Launch plan of the GroupNorm+SiLU kernel (``csrc/gn_silu.cu``) for one call.

    Block ``b`` of ``grid`` owns chunk ``b % chunks`` (pixels
    ``chunk_range``) of image ``b // chunks + w * images`` in wave ``w``: a
    wave holds ``images`` whole images. A chunk keeps its first
    ``resident_pix`` pixels in shared memory and reads the rest, if any,
    twice: the route for a slab larger than one wave. ``vec`` is the
    channels a thread reads at a time, 16 bytes' worth, or 1 where the
    channels, the slab or the input's address do not allow 16-byte vectors.
    ``staged`` is the number of tensors a chunk holds in shared memory: 1
    (x: K1, K2 and the training forward) or 2 (x and dy: the backward)."""

    n: int
    pixels: int
    c: int
    elem: int
    vec: int
    threads: int
    chunk_pix: int
    chunks: int
    images: int
    resident_pix: int
    smem: int
    staged: int = 1

    @property
    def grid(self) -> int:
        return self.images * self.chunks

    @property
    def waves(self) -> int:
        return -(-self.n // self.images)

    def chunk_range(self, chunk: int) -> tuple[int, int]:
        p0 = chunk * self.chunk_pix
        return p0, min(self.pixels, p0 + self.chunk_pix)

    def work(self, block: int) -> list[tuple[int, int, int]]:
        """(image, first pixel, end pixel) of each wave of ``block``."""
        p0, p1 = self.chunk_range(block % self.chunks)
        return [(img, p0, p1) for img in range(block // self.chunks, self.n, self.images)]

    @property
    def reread_pix(self) -> int:
        """Pixels of the largest chunk read twice (0: every chunk resident)."""
        return max(0, self.chunk_pix - self.resident_pix)

    @property
    def bytes_read(self) -> int:
        """Bytes of the staged tensors the call reads from device memory:
        every pixel once, and what a chunk holds beyond its resident pixels
        once more."""
        again = sum(max(0, p1 - p0 - self.resident_pix)
                    for p0, p1 in map(self.chunk_range, range(self.chunks)))
        return self.staged * self.n * (self.pixels + again) * self.c * self.elem


@functools.lru_cache(maxsize=256)
def _gn_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype, sms: int,
             aligned: bool = True, staged: int = 1) -> GnPlan:
    """The GroupNorm kernels' launch plan on a card with ``sms`` SMs, at
    most one block per SM, for ``staged`` tensors of the shape in shared
    memory (``GnPlan``). Vectors of 16 bytes where C fills them with C /
    vec dividing 32, the slab is a multiple of 16 bytes and the input's
    address is 16-byte ``aligned``; threads and shared memory as
    ``gnk::block_threads`` and ``gnk::smem_bytes`` give them. Then the
    fewest waves whose images are resident whole, the batch spread evenly
    over them and each wave's chunks over the SMs, no chunk below
    ``_GN_MIN_CHUNK`` bytes unless it is the whole image; where one image
    does not fit all the SMs' shared memory, one image per wave on every SM,
    each chunk reading what its shared memory does not hold twice. Chunks
    start on 16-byte boundaries of the slab."""
    if not 1 <= c <= _GN_MAX_THREADS:
        raise ValueError(f"GroupNorm kernel takes 1 to {_GN_MAX_THREADS} channels, got {c}")
    elem = _ELEM_BYTES[dtype]
    p, pix_bytes = h * w, c * elem
    vec = 16 // elem
    if not (aligned and c % vec == 0 and 32 % (c // vec) == 0 and p * pix_bytes % 16 == 0):
        vec = 1
    unit = c // vec
    threads = unit * max(1, _GN_THREADS // unit)
    red_bytes = 8 * (c * (threads // 32) if vec > 1 else threads)
    align = 16 // math.gcd(16, pix_bytes)  # pixels from one 16-byte boundary to the next
    # pixels a block holds
    cap = (BLOCK_SHARED_MAX - red_bytes) // (staged * pix_bytes) // align * align
    need = -(-p // cap)  # chunks that hold one image
    if need > sms:
        images, chunks = 1, sms
    else:
        waves = -(-n // (sms // need))
        images = -(-n // waves)
        chunks = max(need, min(sms // images, -(-p * pix_bytes // _GN_MIN_CHUNK)))
    chunk_pix = -(-p // chunks)
    chunk_pix = -(-chunk_pix // align) * align
    resident = min(chunk_pix, cap)
    return GnPlan(n=n, pixels=p, c=c, elem=elem, vec=vec, threads=threads, chunk_pix=chunk_pix,
                  chunks=-(-p // chunk_pix), images=images, resident_pix=resident,
                  smem=staged * (-(-resident * pix_bytes // 16) * 16) + red_bytes, staged=staged)


#: (device index, stream) -> the GroupNorm kernel's workspace on that
#: stream and its number of counter slots
_GN_WORK: dict = {}
_GN_WORK_LOCK = threading.Lock()


def _gn_workspace(device: torch.device, stream: int, n: int,
                  part_floats: int) -> tuple[torch.Tensor, int]:
    """The GroupNorm kernel's float32 workspace on ``stream``: ``slots``
    (>= n) int32 arrival counters, which every launch leaves at 0, then
    room for ``part_floats`` chunk sums. Calls on one stream share it in
    stream order; a call on another stream gets its own. Allocated zeroed,
    on the stream, when a call needs more. Call with ``_GN_WORK_LOCK``
    held, and launch before releasing it."""
    work, slots = _GN_WORK.get((device.index, stream), (None, 0))
    if work is None or slots < n or work.numel() - slots < part_floats:
        part_floats = max(part_floats, 0 if work is None else work.numel() - slots)
        slots = max(slots, -(-n // 4) * 4)  # the sums start 16-byte aligned
        work = torch.zeros(slots + part_floats, dtype=torch.float32, device=device)
        _GN_WORK[(device.index, stream)] = (work, slots)
    return work, slots


def _gn_silu_launch(name: str, x, scale, bias, num_groups: int, eps: float,
                    save_stats: bool = False):
    """Launch gn_silu.cu's forward: K1, K2, or with ``save_stats`` the
    training forward, which returns (y, stats) instead of y."""
    refuse_autograd(name, x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, want cpu or cuda")
    _check_activation(name, x)
    n, h, w, c = x.shape
    _check_groups(name, c, num_groups)
    g, b = _affine(name, x, scale, c), _affine(name, x, bias, c)
    plan = _gn_plan(n, h, w, c, x.dtype, _sm_count(x.device), x.data_ptr() % 16 == 0)
    y = torch.empty_like(x)
    stats = (torch.empty((n, num_groups, 2), dtype=torch.float32, device=x.device)
             if save_stats else None)
    fn = getattr(_build.load("gn_silu"), name)
    stream = _stream(x.device)
    with _GN_WORK_LOCK, torch.cuda.device(x.device):
        work, slots = _gn_workspace(x.device, stream, n, n * plan.chunks * c * 2)
        head = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr())
        if save_stats:
            head += (stats.data_ptr(),)
        err = fn(*head, work.data_ptr(), work.data_ptr() + 4 * slots, n, h * w, c, num_groups,
                 plan.vec, plan.threads, plan.chunk_pix, plan.chunks, plan.images,
                 plan.resident_pix, plan.smem, eps, _DTYPE_CODE[x.dtype], stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return (y, stats) if save_stats else y


def gn_silu_train_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                      num_groups: int, eps: float = 1e-5):
    """The training forward: K1's function, its variance the centred
    second moment, and (N, G, 2) float32 (mean, rstd) for the backward.
    Returns (out, stats). Takes every NHWC shape whose C splits into the
    groups, up to ``_GN_MAX_THREADS`` channels."""
    if x.device.type == "cpu":
        return gn_silu_train_fwd_plain(x, scale, bias, num_groups=num_groups, eps=eps)
    return _gn_silu_launch("gn_silu_train_fwd", x, scale, bias, num_groups, eps, True)


def gn_silu_train_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, stats: torch.Tensor, *, num_groups: int):
    """The training backward from the forward's input ``x`` and ``stats``:
    one pass over x and dy staged in shared memory (dx, and per-chunk sums
    of dz and dz x^), then a second launch that folds the sums into dgamma
    and dbeta. Returns (dx, dgamma, dbeta), the last two in the
    parameters' dtypes."""
    if x.device.type == "cpu":
        return gn_silu_train_bwd_plain(x, dy, scale, bias, stats, num_groups=num_groups)
    name = "gn_silu_train_bwd"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, want cpu or cuda")
    _check_activation(name, x)
    n, h, w, c = x.shape
    _check_groups(name, c, num_groups)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if stats.shape != (n, num_groups, 2) or stats.dtype != torch.float32:
        raise ValueError(f"{name}: stats {tuple(stats.shape)} {stats.dtype}, want "
                         f"({n}, {num_groups}, 2) float32")
    dy, stats = dy.contiguous(), stats.contiguous()
    g, b = _affine(name, x, scale, c), _affine(name, x, bias, c)
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    aligned = (x.data_ptr() | dy.data_ptr() | dx.data_ptr()) % 16 == 0
    plan = _gn_plan(n, h, w, c, x.dtype, _sm_count(x.device), aligned, staged=2)
    fn = _build.load("gn_silu").gn_silu_train_bwd
    stream = _stream(x.device)
    with _GN_WORK_LOCK, torch.cuda.device(x.device):
        work, slots = _gn_workspace(x.device, stream, n, n * plan.chunks * c * 2)
        err = fn(x.data_ptr(), dy.data_ptr(), g.data_ptr(), b.data_ptr(), stats.data_ptr(),
                 dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), work.data_ptr(),
                 work.data_ptr() + 4 * slots, n, h * w, c, num_groups, plan.vec, plan.threads,
                 plan.chunk_pix, plan.chunks, plan.images, plan.resident_pix, plan.smem,
                 _DTYPE_CODE[x.dtype], stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return dx, dgamma.to(scale.dtype), dbeta.to(bias.dtype)


class _GnSiluTrain(torch.autograd.Function):
    """GroupNorm+SiLU whose backward is the training pair's: saves the
    input, the affine parameters and the forward's (mean, rstd)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        y, stats = gn_silu_train_fwd(x, scale, bias, num_groups=num_groups, eps=eps)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, stats = ctx.saved_tensors
        dx, dgamma, dbeta = gn_silu_train_bwd(x, dy, scale, bias, stats,
                                              num_groups=ctx.num_groups)
        return dx, dgamma, dbeta, None, None


def gn_silu_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                  num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Differentiable GroupNorm+SiLU over NHWC through the training pair
    (on a CPU tensor, their plain versions). Not under ``torch.func``
    transforms: the Function has no vmap rule."""
    return _GnSiluTrain.apply(x.contiguous(), scale, bias, num_groups, eps)


# The BatchNorm kernels' geometry (csrc/batch_norm.cu, namespace bnk).
_BN_THREADS = 1_024       # bnk::kThreadTarget: threads per block, rounded to the channel period
_BN_MAX_C = 1_024         # channels whose element-wise period fits a block
_BN_FOLD_FLOATS = 65_536  # partials the last block of a sums pass folds, at most


@dataclass(frozen=True)
class BnPlan:
    """Launch plan of the BatchNorm kernels (``csrc/batch_norm.cu``) for a
    (rows, C) slab.

    Every launch walks the slab as ``vectors`` vectors of ``vec`` elements
    (4, or 1 where the slab or a pointer does not allow 16-byte float32 /
    8-byte bf16 accesses), grid-stride in steps of ``threads`` vectors: block
    ``b`` of a grid of ``g`` takes steps b, b + g, ... Thread t of a block
    holds vector t of each step, whose lane j is channel (t vec + j) % C,
    since ``threads`` is a multiple of the ``period``. The apply passes run
    ``grid`` blocks, the sums passes ``sums_grid`` (their partials, 2C
    floats a block, stay within ``_BN_FOLD_FLOATS`` for one block to fold)."""

    rows: int
    c: int
    vec: int
    threads: int
    grid: int
    sums_grid: int

    @property
    def period(self) -> int:
        return self.c // math.gcd(self.c, self.vec)

    @property
    def vectors(self) -> int:
        return self.rows * self.c // self.vec

    @property
    def steps(self) -> int:
        return -(-self.vectors // self.threads)


@functools.lru_cache(maxsize=256)
def _bn_plan(rows: int, c: int, sms: int, aligned: bool = True) -> BnPlan:
    """The BatchNorm kernels' launch plan on a card with ``sms`` SMs (one
    block of up to ``_BN_THREADS`` threads per SM): vectors of 4 elements
    where the pointers are ``aligned`` and the slab holds whole vectors,
    threads ``bnk::block_threads``, the apply grid the steps up to one
    block per SM, the sums grid that or fewer so the partials stay within
    ``_BN_FOLD_FLOATS``. Adapts to (rows, C) only."""
    if not 1 <= c <= _BN_MAX_C:
        raise ValueError(f"BatchNorm kernels take 1 to {_BN_MAX_C} channels, got {c}")
    if rows < 1:
        raise ValueError(f"BatchNorm kernels take at least one row, got {rows}")
    vec = 4 if aligned and rows * c % 4 == 0 else 1
    period = c // math.gcd(c, vec)
    threads = period * max(1, _BN_THREADS // period)
    grid = min(-(-(rows * c // vec) // threads), sms)
    return BnPlan(rows=rows, c=c, vec=vec, threads=threads, grid=grid,
                  sums_grid=min(grid, max(1, _BN_FOLD_FLOATS // (2 * c))))


def _bn_check(name: str, x: torch.Tensor, *same) -> tuple[int, int]:
    """(rows, C) of NHWC ``x`` on a CUDA device; each of ``same`` (or
    None) float32, contiguous, of x's shape."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, want cpu or cuda")
    _check_activation(name, x)
    for t in same:
        if t is not None and (t.shape != x.shape or t.dtype != torch.float32
                              or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: a tensor of {tuple(t.shape)} {t.dtype} where x's "
                             f"shape {tuple(x.shape)} in float32, contiguous, is wanted")
    rows, c = _bn_rows(x)
    if c > _BN_MAX_C:
        raise ValueError(f"{name}: BatchNorm kernels take 1 to {_BN_MAX_C} channels, got {c}")
    return rows, c


def _bn_channels(name: str, x: torch.Tensor, t: torch.Tensor, width: int) -> torch.Tensor:
    if t.shape != (width,) or t.dtype != torch.float32 or t.device != x.device:
        raise ValueError(f"{name}: a ({width},) float32 tensor on {x.device} is wanted, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def _bn_launch_plan(x: torch.Tensor, *others) -> BnPlan:
    """The plan for ``x`` and the float32 tensors ``others`` walked beside it."""
    aligned = x.data_ptr() % (4 * x.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for t in others if t is not None)
    rows, c = _bn_rows(x)
    return _bn_plan(rows, c, _sm_count(x.device), aligned)


def _ptr(t):
    return None if t is None else t.data_ptr()


def bn_sums(x: torch.Tensor) -> torch.Tensor:
    """B1: per-channel (sum x, sum x^2) of NHWC ``x`` (float32 or bf16),
    (2C,) float32, the same bits every call."""
    if x.device.type == "cpu":
        return bn_sums_plain(x)
    name = "bn_train_stats"
    refuse_autograd(name, x)
    rows, c = _bn_check(name, x)
    plan = _bn_launch_plan(x)
    sums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    stream = _stream(x.device)
    with _GN_WORK_LOCK, torch.cuda.device(x.device):
        work, slots = _gn_workspace(x.device, stream, 1, plan.sums_grid * 2 * c)
        err = _build.load("batch_norm").bn_train_stats(
            x.data_ptr(), sums.data_ptr(), work.data_ptr(), work.data_ptr() + 4 * slots, rows, c,
            plan.vec, plan.threads, plan.sums_grid, _DTYPE_CODE[x.dtype], stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return sums


def bn_apply(x: torch.Tensor, sums: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
             count: int, act=None, residual=None, eps: float = 1e-5, momentum: float = 0.9,
             running=None):
    """B2: ``bn_apply_plain``'s function from B1's ``sums`` over ``count``
    rows (every rank's). Returns (out float32, stats (C, 2))."""
    if x.device.type == "cpu":
        return bn_apply_plain(x, sums, scale, bias, count=count, act=act, residual=residual,
                              eps=eps, momentum=momentum, running=running)
    name = "bn_train_apply"
    code = _bn_act_code(act, residual is not None)
    refuse_autograd(name, x, scale, bias, residual)
    rows, c = _bn_check(name, x, residual)
    g, b = _affine(name, x, scale, c), _affine(name, x, bias, c)
    sums = _bn_channels(name, x, sums, 2 * c)
    rm, rv = (None, None) if running is None else running
    if running is not None and any(_bn_channels(name, x, t, c) is not t for t in running):
        raise ValueError(f"{name}: running statistics must be contiguous")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    stats = torch.empty((c, 2), dtype=torch.float32, device=x.device)
    plan = _bn_launch_plan(x, residual, y)
    with torch.cuda.device(x.device):
        err = _build.load("batch_norm").bn_train_apply(
            x.data_ptr(), sums.data_ptr(), g.data_ptr(), b.data_ptr(), _ptr(residual),
            y.data_ptr(), stats.data_ptr(), _ptr(rm), _ptr(rv), rows, c, plan.vec, plan.threads,
            plan.grid, float(count), eps, momentum, 1 - momentum, code, _DTYPE_CODE[x.dtype],
            _stream(x.device))
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return y, stats


def bn_bwd_sums(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                stats: torch.Tensor, *, act=None, out=None) -> torch.Tensor:
    """B3: per-channel (sum dz, sum dz x^) of these rows, (2C,) float32, the
    same bits every call; ``out`` is B2's output where it added a residual."""
    if x.device.type == "cpu":
        return bn_bwd_sums_plain(x, dy, scale, bias, stats, act=act, out=out)
    name = "bn_train_bwd_sums"
    code = _bn_act_code(act, out is not None)
    rows, c = _bn_check(name, x, dy, out)
    g, b = _affine(name, x, scale, c), _affine(name, x, bias, c)
    stats = _bn_channels(name, x, stats.reshape(-1), 2 * c)
    plan = _bn_launch_plan(x, dy, out)
    sums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    stream = _stream(x.device)
    with _GN_WORK_LOCK, torch.cuda.device(x.device):
        work, slots = _gn_workspace(x.device, stream, 1, plan.sums_grid * 2 * c)
        err = _build.load("batch_norm").bn_train_bwd_sums(
            x.data_ptr(), dy.data_ptr(), _ptr(out), stats.data_ptr(), g.data_ptr(), b.data_ptr(),
            sums.data_ptr(), work.data_ptr(), work.data_ptr() + 4 * slots, rows, c, plan.vec,
            plan.threads, plan.sums_grid, code, _DTYPE_CODE[x.dtype], stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return sums


def bn_bwd_apply(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 stats: torch.Tensor, sums: torch.Tensor, *, count: int, act=None, out=None):
    """B4: ``bn_bwd_apply_plain``'s function from B3's ``sums`` over
    ``count`` rows (every rank's). Returns (dx in x's dtype, the residual's
    gradient in float32 or None)."""
    if x.device.type == "cpu":
        return bn_bwd_apply_plain(x, dy, scale, bias, stats, sums, count=count, act=act,
                                  out=out)
    name = "bn_train_bwd_apply"
    code = _bn_act_code(act, out is not None)
    rows, c = _bn_check(name, x, dy, out)
    g, b = _affine(name, x, scale, c), _affine(name, x, bias, c)
    stats = _bn_channels(name, x, stats.reshape(-1), 2 * c)
    sums = _bn_channels(name, x, sums, 2 * c)
    dx = torch.empty_like(x)
    dres = torch.empty_like(dy) if code == 2 else None
    plan = _bn_launch_plan(x, dy, out, dres)
    with torch.cuda.device(x.device):
        err = _build.load("batch_norm").bn_train_bwd_apply(
            x.data_ptr(), dy.data_ptr(), _ptr(out), stats.data_ptr(), g.data_ptr(), b.data_ptr(),
            sums.data_ptr(), dx.data_ptr(), _ptr(dres), rows, c, plan.vec, plan.threads,
            plan.grid, float(count), code, _DTYPE_CODE[x.dtype], _stream(x.device))
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return dx, dres


def bn_act_train_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, act=None,
                     residual=None, eps: float = 1e-5, momentum: float = 0.9, running=None,
                     sums_hook=None):
    """The training forward: B1, ``sums_hook``, B2 (on a CPU tensor their
    plain versions). Returns (out float32, stats (C, 2) of (mean, rstd))."""
    return _bn_fwd(bn_sums, bn_apply, x, scale, bias, act, residual, eps, momentum, running,
                   sums_hook)


def bn_act_train_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, stats: torch.Tensor, *, act=None, out=None,
                     sums_hook=None):
    """The training backward: B3, ``sums_hook``, B4 (on a CPU tensor their
    plain versions). Returns (dx, the residual's gradient or None, dgamma,
    dbeta), dgamma and dbeta of this rank's rows."""
    return _bn_bwd(bn_bwd_sums, bn_bwd_apply, x, dy, scale, bias, stats, act, out, sums_hook)


class _BnActTrain(torch.autograd.Function):
    """BatchNorm (+ ReLU, or + residual + ReLU) whose backward is the
    training pair's: saves the input, the affine parameters, the forward's
    (mean, rstd) and, where it added a residual, its output."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, act, eps, momentum, running, sums_hook):
        out, stats = bn_act_train_fwd(x, scale, bias, act=act, residual=residual, eps=eps,
                                      momentum=momentum, running=running, sums_hook=sums_hook)
        ctx.save_for_backward(x, scale, bias, stats, out if residual is not None else None)
        ctx.act, ctx.sums_hook = act, sums_hook
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, stats, out = ctx.saved_tensors
        dy = dy.to(_acc_dtype(x)).contiguous()
        dx, dres, dgamma, dbeta = bn_act_train_bwd(x, dy, scale, bias, stats, act=ctx.act,
                                                   out=out, sums_hook=ctx.sums_hook)
        return dx, dgamma, dbeta, dres, None, None, None, None, None


def bn_act_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, act=None,
                 residual=None, eps: float = 1e-5, momentum: float = 0.9, running=None,
                 sums_hook=None) -> torch.Tensor:
    """Differentiable training-mode BatchNorm over the channels of NHWC
    ``x`` (flax's: batch statistics, biased variance) followed by ``act``
    (None or "relu"; with ``residual``, ReLU(BatchNorm(x) + residual)),
    through the training pair (on a CPU tensor, their plain versions).
    Output float32. ``running``, a (mean, var) pair of buffers, moves to
    momentum * old + (1 - momentum) * batch. ``sums_hook(sums)``, where
    given, returns (the per-channel sums over every rank, the number of
    ranks): the forward's statistics and the backward's sums are then the
    global batch's (``models.enhanced_unet.synced_batch_stats``). Not under
    ``torch.func`` transforms: the Function has no vmap rule."""
    if residual is not None:
        residual = residual.to(_acc_dtype(x)).contiguous()
    return _BnActTrain.apply(x.contiguous(), scale, bias, residual, act, eps, momentum, running,
                             sums_hook)


_LN_MAX_C = 1_024  # lnk::kMaxC; and C a multiple of 8 (16-byte vectors in bf16)


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                       *, eps: float = 1e-5) -> torch.Tensor:
    """K6: LayerNorm over the channels of each pixel of NHWC ``x`` (float32
    or bf16, C a multiple of 8 up to 1024, 16-byte aligned), float32
    statistics, BiasFree without ``bias``: one launch of
    ``csrc/layer_norm.cu``, one read of x and one write. On a CPU tensor,
    the plain version ``channel_layer_norm_plain``."""
    if x.device.type == "cpu":
        return channel_layer_norm_plain(x, weight, bias, eps=eps)
    name = "channel_layer_norm"
    refuse_autograd(name, x, weight, bias)
    _check_activation(name, x)
    c = x.shape[-1]
    if c % 8 or c > _LN_MAX_C:
        raise ValueError(f"{name}: {c} channels; the kernel takes multiples of 8 up to "
                         f"{_LN_MAX_C}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be 16-byte aligned")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, want cpu or cuda")
    w = _affine(name, x, weight, c)
    b = None if bias is None else _affine(name, x, bias, c)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.load("layer_norm").channel_layer_norm(
            x.data_ptr(), w.data_ptr(), _ptr(b), y.data_ptr(), x.numel() // c, c, eps,
            _sm_count(x.device), _DTYPE_CODE[x.dtype], _stream(x.device))
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return y


def _conv_launch(name: str, x, w, scale, bias, num_groups: int, eps: float, images: int):
    """Launch conv_gn_silu.cu for K3 (``images`` 1) or K4: in bf16 the
    tensor-core kernel under ``_conv_plan``, in float32 the CUDA-core one
    with ``images`` images per conv block."""
    refuse_autograd(name, x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, want cpu or cuda")
    _check_activation(name, x)
    n, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not (3, 3, {cin}, Cout)")
    cout = w.shape[3]
    _check_groups(name, cout, num_groups)
    wk = w.to(device=x.device, dtype=x.dtype).contiguous()
    g, b = _affine(name, x, scale, cout), _affine(name, x, bias, cout)
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv_gn_silu")
    stream = _stream(x.device)
    if x.dtype == torch.bfloat16:
        plan = _conv_plan(n, h, wd, cin, cout, images, _sm_count(x.device))
        n_part = n * plan.tiles * cout * 2
        scratch = torch.empty((n_part + n * num_groups * 2,), dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            err = lib.conv3x3_gn_silu_bf16(
                x.data_ptr(), wk.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), scratch.data_ptr() + 4 * n_part, n, h, wd, cin, cout,
                num_groups, plan.kc, images, plan.grid, plan.smem, eps, stream)
    else:
        threads, chunk_pix, chunks = _launch_layout(h * wd, cout)
        tiles = -(-h // 8) * -(-wd // 8)  # the conv's 8x8 output tiles
        yscr = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
        part = torch.empty((n * max(tiles, chunks) * cout * 2,), dtype=torch.float32,
                           device=x.device)
        stats = torch.empty((n, num_groups, 2), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            err = lib.conv3x3_gn_silu_f32(
                x.data_ptr(), wk.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                yscr.data_ptr(), part.data_ptr(), stats.data_ptr(), n, h, wd, cin, cout,
                num_groups, chunk_pix, chunks, threads, images, eps, stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return out


def conv3x3_gn_silu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, num_groups: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """K3: Conv3x3(same, no bias) -> GroupNorm -> SiLU (replaces
    ``_fused_conv_gn_silu_pallas``). x: (N, H, W, Cin), w: (3, 3, Cin, Cout)
    HWIO -> (N, H, W, Cout) in x's dtype."""
    if x.device.type == "cpu":
        return conv3x3_gn_silu_plain(x, w, scale, bias, num_groups=num_groups, eps=eps)
    return _conv_launch("conv3x3_gn_silu", x, w, scale, bias, num_groups, eps, 1)


def conv3x3_gn_silu_batched(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, *, num_groups: int, images: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """K4: K3's function with ``images`` images per step (replaces
    ``_fused_conv_gn_silu_batched``). In bf16 the images only order each
    block's walk (the K images of one tile in a row, see ``ConvPlan``); in
    float32 one conv block owns its output tile across them. The output
    equals K3's bit for bit. Raises ValueError unless ``images`` divides
    the batch."""
    n = x.shape[0]
    if images < 1 or n % images != 0:
        raise ValueError(f"conv3x3_gn_silu_batched: batch {n} not divisible by "
                         f"images {images}")
    if x.device.type == "cpu":
        return conv3x3_gn_silu_plain(x, w, scale, bias, num_groups=num_groups, eps=eps)
    return _conv_launch("conv3x3_gn_silu_batched", x, w, scale, bias, num_groups, eps,
                        images)


# --------------------------------------------------------------- dispatchers


def _routes_to_kernels(x: torch.Tensor) -> bool:
    """Whether ``use_kernel=None`` may pick a kernel for ``x``: on a device
    tensor, as the JAX dispatchers do on the TPU; not on a CPU tensor, as
    theirs do not off the TPU."""
    return x.device.type != "cpu"


def _grad_call(x: torch.Tensor, *tensors) -> bool:
    """A grad-mode call on a device tensor that autograd must see: inside a
    ``torch.func`` transform (whose batched tensors show no requires_grad)
    or with one of ``tensors`` requiring grad."""
    return torch.is_grad_enabled() and _routes_to_kernels(x) and (
        torch._C._functorch.peek_interpreter_stack() is not None
        or any(t is not None and t.requires_grad for t in tensors))


def _kernel_takes(x: torch.Tensor, takes, fallbacks: dict) -> bool:
    """Whether a kernel takes a call on ``x``: not inside a ``torch.func``
    transform (the kernels have no vmap rule) nor for a shape or dtype it
    does not take (``takes(C)``), each counted in ``fallbacks``."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        fallbacks["transform"] += 1
        return False
    if x.dim() != 4 or x.numel() == 0 or x.dtype not in _DTYPE_CODE or not takes(x.shape[-1]):
        fallbacks["shape"] += 1
        return False
    return True


def _conv_kernel_takes(x: torch.Tensor, cout: int, num_groups: int) -> bool:
    """Where K3 runs unless forced (the JAX dispatcher's rule); in
    LightweightUNet the encoder and bottleneck blocks of 64 channels and
    more, as the decoder's dual blocks have no conv site."""
    return _routes_to_kernels(x) and cout % num_groups == 0 and cout >= 64


def _flat_eligible(x: torch.Tensor, num_groups: int) -> bool:
    n, h, w, c = x.shape
    return c % num_groups == 0 and (w * c) % 128 == 0 and h >= 8


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          *, num_groups: int, eps: float = 1e-5,
                          use_kernel: bool | None = None) -> torch.Tensor:
    """GroupNorm followed by SiLU through a fused kernel.

    On a CUDA tensor, ``use_kernel=None`` or True picks K1 when the
    (H, W*C) rows are 128-lane aligned and H >= 8, else K2 when C >= 64,
    else (None only) the composition ``silu(group_norm(...))``; a forced
    True with no eligible kernel raises. ``use_kernel=False`` is the
    composition. On a CPU tensor ``None`` is the composition, as the JAX
    dispatcher's ``None`` is XLA's off the TPU, and a forced True is the
    picked kernel's plain version (JAX runs the kernel in interpret mode
    there). The shape rules are the JAX dispatcher's."""
    if use_kernel is None and not _routes_to_kernels(x):
        use_kernel = False
    if use_kernel is None or use_kernel:
        c = x.shape[-1]
        if _flat_eligible(x, num_groups):
            return gn_silu_flat(x.contiguous(), scale, bias, num_groups=num_groups, eps=eps)
        if c % num_groups == 0 and c >= 64:
            return gn_silu_nhwc(x.contiguous(), scale, bias, num_groups=num_groups, eps=eps)
        if use_kernel:
            raise ValueError(f"no fused GN+SiLU kernel for shape {tuple(x.shape)}, "
                             f"groups={num_groups}")
    return silu(group_norm(x, scale, bias, num_groups=num_groups, eps=eps))


def fused_conv3x3_gn_silu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int, eps: float = 1e-5,
                          use_kernel: bool | None = None,
                          images_per_step: int | None = None) -> torch.Tensor:
    """Conv3x3(same, no bias) -> GroupNorm -> SiLU through K3 or K4.

    ``use_kernel=None`` picks a kernel on a CUDA tensor for ``cout %
    num_groups == 0 and cout >= 64`` and the composition elsewhere, and on
    a CPU tensor the composition, as the JAX dispatcher's ``None`` takes
    XLA off the TPU; a forced True on a CPU tensor is the kernel's plain
    version. The JAX dispatcher also required the per-image slab to fit a
    6 MB on-chip budget of the TPU; that rule has no meaning on the H100
    and is dropped. With a kernel, ``images_per_step=K > 1`` routes to K4
    (K images per conv block; the batch must divide by K, else ValueError)
    and None or <= 1 to K3."""
    cout = w.shape[-1]
    if use_kernel is None:
        use_kernel = _conv_kernel_takes(x, cout, num_groups)
    if not use_kernel:
        y = conv2d(x, w, padding=1)
        return silu(group_norm(y, scale, bias, num_groups=num_groups, eps=eps))
    if cout % num_groups != 0:
        # a forced call must not compute ragged pseudo-group statistics
        raise ValueError(f"fused conv+GN+SiLU needs cout % num_groups == 0 "
                         f"(got cout={cout}, num_groups={num_groups})")
    if images_per_step is not None and images_per_step > 1:
        if x.shape[0] % images_per_step != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by images_per_step "
                             f"{images_per_step}")
        return conv3x3_gn_silu_batched(x.contiguous(), w, scale, bias, num_groups=num_groups,
                                       images=images_per_step, eps=eps)
    return conv3x3_gn_silu(x.contiguous(), w, scale, bias, num_groups=num_groups, eps=eps)


# ------------------------------------------- sites: one norm-and-activation


def gn_silu_site(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                 num_groups: int, eps: float = 1e-5, kernels: bool = False) -> torch.Tensor:
    """One GroupNorm+SiLU of a model. A grad call (``_grad_call``) runs the
    training pair where it takes it, else the composition; any other call
    the dispatcher ``fused_group_norm_silu`` with ``kernels``, else the
    composition."""
    if _grad_call(x, x, scale, bias):
        if _kernel_takes(x, lambda c: c % num_groups == 0 and c <= _GN_MAX_THREADS,
                         TRAIN_FALLBACKS):
            return gn_silu_train(x, scale, bias, num_groups=num_groups, eps=eps)
    elif kernels:
        return fused_group_norm_silu(x, scale, bias, num_groups=num_groups, eps=eps)
    return silu(group_norm(x, scale, bias, num_groups=num_groups, eps=eps))


def conv_gn_silu_site(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, gn_silu, *, num_groups: int, eps: float = 1e-5,
                      kernels: bool = False) -> torch.Tensor:
    """One Conv3x3(same, no bias)+GroupNorm+SiLU of an encoder block: K3
    with ``kernels`` where ``_conv_kernel_takes`` (it raises under a grad
    call), else ``conv2d`` and the block's GroupNorm+SiLU site ``gn_silu``."""
    if kernels and _conv_kernel_takes(x, w.shape[-1], num_groups):
        return conv3x3_gn_silu(x.contiguous(), w, scale, bias, num_groups=num_groups, eps=eps)
    return gn_silu(conv2d(x, w, padding=1), scale, bias)


def batch_norm_site(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, composition, *,
                    train: bool, act=None, residual: torch.Tensor | None = None,
                    eps: float = 1e-5, momentum: float = 0.9, running=None,
                    sums_hook=None) -> torch.Tensor:
    """One BatchNorm of EnhancedUNet and its epilogue: a training-mode grad
    call runs the training pair ``bn_act_train`` where it takes it; every
    other call ``composition()``, the model's float32 composition."""
    if train and _grad_call(x, x, scale, bias, residual) and _kernel_takes(
            x, lambda c: c <= _BN_MAX_C and (residual is None or residual.shape == x.shape),
            TRAIN_FALLBACKS):
        return bn_act_train(x, scale, bias, act=act, residual=residual, eps=eps,
                            momentum=momentum, running=running, sums_hook=sums_hook)
    return composition()


def layer_norm_site(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                    *, eps: float = 1e-5) -> torch.Tensor:
    """One channel LayerNorm of Restormer (BiasFree without ``bias``): K6
    for a call on a device tensor that is no grad call, where it takes the
    shape, dtype and alignment (else counted in ``LAYER_NORM_FALLBACKS``);
    every other call, the CPU's and training's among them (K6 has no
    backward), the float32 composition ``conv_blocks.channel_layer_norm``."""
    if _routes_to_kernels(x) and not _grad_call(x, x, weight, bias):
        xc = x.contiguous()
        if _kernel_takes(xc, lambda c: c % 8 == 0 and c <= _LN_MAX_C and xc.data_ptr() % 16 == 0,
                         LAYER_NORM_FALLBACKS):
            return channel_layer_norm(xc, weight, bias, eps=eps)
    return conv_blocks.channel_layer_norm(x, weight, bias, eps=eps)
