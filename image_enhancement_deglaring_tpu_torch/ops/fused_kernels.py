"""Hand-written CUDA kernels of the port, their plain versions, dispatchers.

Counterpart of ``image_enhancement_deglaring_tpu.ops.pallas_kernels``:

========================  ===================================  ====================
wrapper                   TPU kernel it replaces               CUDA source
========================  ===================================  ====================
gn_silu_flat              _gn_silu_flat_kernel (K1)            csrc/gn_silu.cu
gn_silu_nhwc              _gn_silu_kernel (K2)                 csrc/gn_silu.cu
conv3x3_gn_silu           _conv_gn_silu_kernel (K3)            csrc/conv_gn_silu.cu
conv3x3_gn_silu_batched   _conv_gn_silu_batched_kernel (K4)    csrc/conv_gn_silu.cu
========================  ===================================  ====================

(K5, the dec1 tail of ``pallas_dec1``, is in :mod:`.dec1`.)

Every wrapper takes and returns NHWC tensors. On a CPU tensor it computes
its plain PyTorch version (``gn_silu_plain``, ``conv3x3_gn_silu_plain``);
on a CUDA tensor it launches its kernel on the current stream or raises.
Each launch adds one to ``LAUNCHES[<wrapper name>]``.

The dispatchers ``fused_group_norm_silu`` and ``fused_conv3x3_gn_silu``
choose a kernel by the same shape rules as the JAX dispatchers.
"""

from __future__ import annotations

import torch

from . import _build
from .conv_blocks import conv2d, group_norm, highest_precision, silu

#: kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES = {"gn_silu_flat": 0, "gn_silu_nhwc": 0, "conv3x3_gn_silu": 0,
            "conv3x3_gn_silu_batched": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    """(threads per block, pixels per chunk, chunks per image) of the
    statistics and apply passes: C * rows threads, 32 pixels per thread."""
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


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _gn_silu_launch(name: str, x, scale, bias, num_groups: int, eps: float):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, want cpu or cuda")
    _check_activation(name, x)
    n, h, w, c = x.shape
    _check_groups(name, c, num_groups)
    g, b = _affine(name, x, scale, c), _affine(name, x, bias, c)
    threads, chunk_pix, chunks = _launch_layout(h * w, c)
    y = torch.empty_like(x)
    part = torch.empty((n, chunks, c, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((n, num_groups, 2), dtype=torch.float32, device=x.device)
    fn = getattr(_build.load("gn_silu"), name)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                 part.data_ptr(), stats.data_ptr(), n, h * w, c, num_groups,
                 chunk_pix, chunks, threads, eps, _DTYPE_CODE[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(name, err)
    LAUNCHES[name] += 1
    return y


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


def _conv_launch(name: str, x, w, scale, bias, num_groups: int, eps: float,
                 images: int | None):
    """Launch the C entry ``name`` of conv_gn_silu.cu: K3's, or K4's with
    ``images`` images per conv block."""
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
    threads, chunk_pix, chunks = _launch_layout(h * wd, cout)
    tiles = -(-h // 8) * -(-wd // 8)  # the conv's 8x8 output tiles
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    yscr = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    part = torch.empty((n * max(tiles, chunks) * cout * 2,), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((n, num_groups, 2), dtype=torch.float32, device=x.device)
    fn = getattr(_build.load("conv_gn_silu"), name)
    per_block = () if images is None else (images,)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wk.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                 yscr.data_ptr(), part.data_ptr(), stats.data_ptr(),
                 n, h, wd, cin, cout, num_groups, chunk_pix, chunks, threads, *per_block,
                 eps, _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
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
    return _conv_launch("conv3x3_gn_silu", x, w, scale, bias, num_groups, eps, None)


def conv3x3_gn_silu_batched(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, *, num_groups: int, images: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """K4: K3's function with one conv block owning its output tile across
    ``images`` images, which stages each weight chunk once for all of them
    (replaces ``_fused_conv_gn_silu_batched``). The output equals K3's bit
    for bit. Raises ValueError unless ``images`` divides the batch."""
    n = x.shape[0]
    if images < 1 or n % images != 0:
        raise ValueError(f"conv3x3_gn_silu_batched: batch {n} not divisible by "
                         f"images {images}")
    if x.device.type == "cpu":
        return conv3x3_gn_silu_plain(x, w, scale, bias, num_groups=num_groups, eps=eps)
    return _conv_launch("conv3x3_gn_silu_batched", x, w, scale, bias, num_groups, eps,
                        images)


# --------------------------------------------------------------- dispatchers


def _flat_eligible(x: torch.Tensor, num_groups: int) -> bool:
    n, h, w, c = x.shape
    return c % num_groups == 0 and (w * c) % 128 == 0 and h >= 8


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          *, num_groups: int, eps: float = 1e-5,
                          use_kernel: bool | None = None) -> torch.Tensor:
    """GroupNorm followed by SiLU through a fused kernel.

    ``use_kernel=None`` or True picks K1 when the (H, W*C) rows are
    128-lane aligned and H >= 8, else K2 when C >= 64, else (None only)
    the composition ``silu(group_norm(...))``; a forced True with no
    eligible kernel raises. ``use_kernel=False`` is the composition. The
    rules are the JAX dispatcher's, kept so both packages route a shape the
    same way."""
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

    ``use_kernel=None`` picks a kernel for ``cout % num_groups == 0 and
    cout >= 64`` and the composition elsewhere. The JAX dispatcher also
    required the per-image slab to fit a 6 MB on-chip budget of the TPU;
    that rule has no meaning on the H100 and is dropped. With a kernel,
    ``images_per_step=K > 1`` routes to K4 (K images per conv block; the
    batch must divide by K, else ValueError) and None or <= 1 to K3."""
    cout = w.shape[-1]
    if use_kernel is None:
        use_kernel = cout % num_groups == 0 and cout >= 64
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
