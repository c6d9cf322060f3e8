"""The dec1 decoder tail and the 1x1 output conv as one CUDA kernel (K5).

Counterpart of ``image_enhancement_deglaring_tpu.ops.pallas_dec1``::

    h1  = conv3x3(x_up, Wa) + conv3x3(x_skip, Wb)
    a1  = silu(group_norm(h1))          C == num_groups: per-channel statistics
    h2  = conv3x3(a1, W2)
    a2  = silu(group_norm(h2))
    out = conv1x1(a2, Wout) + bout      (B, H, W) float32

- ``fused_dec1_output``: K5, ``csrc/dec1_output.cu`` (replaces the JAX
  ``fused_dec1_output`` and its ``_dec1_out_kernel``);
- ``dec1_output_plain``: K5's arithmetic in PyTorch, its plain version
  (``dec1_stages_plain`` also returns its h1, h2 and GroupNorm affines);
- ``dec1_output_composition``: the model's own ops (``dec1_output_xla``);
- ``dec1_output_args``: K5's weights from a ``LightweightUNet``.

The TPU kernel takes channels-first inputs; the port takes the model's
NHWC layout, so a caller pays no transpose. K5 rounds where the TPU
kernel does, which is not where the composition does (see
:func:`dec1_output_plain`), so K5 is held against ``dec1_output_plain``
and compared with the composition only at a tolerance.
"""

from __future__ import annotations

import contextlib

import torch

from . import _build
from .conv_blocks import conv2d, group_norm, highest_precision, silu
from .fused_kernels import refuse_autograd

#: K5 launches since the last reset_launch_counts()
LAUNCHES = {"dec1_output": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CHANNELS = 8  # the production dec1 width, the one csrc/dec1_output.cu takes
_STRIP = 32           # output columns per block of the kernel's conv passes


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def effective_tile_h(h: int, tile_h: int) -> int:
    """The row-tile height the kernel runs: ``tile_h``, or the whole image
    when ``h % tile_h != 0`` or when ``tile_h`` is neither a multiple of 8
    nor ``h`` (the JAX kernel's fallback rule)."""
    if tile_h < 1:
        raise ValueError(f"tile_h must be >= 1, got {tile_h}")
    if h % tile_h != 0 or (tile_h % 8 != 0 and tile_h != h):
        return h
    return tile_h


def _check(x_up: torch.Tensor, x_skip: torch.Tensor, num_groups: int) -> None:
    if x_up.dim() != 4 or x_skip.shape != x_up.shape:
        raise ValueError(f"fused_dec1_output: x_up {tuple(x_up.shape)} and x_skip "
                         f"{tuple(x_skip.shape)} must be one NHWC shape")
    c = x_up.shape[-1]
    if c != num_groups:
        # the kernel's statistics are per channel; grouped ones would be a
        # different function
        raise ValueError(f"fused_dec1_output assumes per-channel GN: C={c} must equal "
                         f"num_groups={num_groups} (use dec1_output_composition otherwise)")


def dec1_stages_plain(x_up, x_skip, wa, wb, w2, g1_scale, g1_bias, g2_scale, g2_bias,
                      w_out, b_out, *, num_groups: int = 8, eps: float = 1e-5) -> dict:
    """K5's function in PyTorch, rounding where the TPU kernel rounds: the
    conv weights in the input dtype; the convs on f32-widened operands with
    f32 sums (no TF32); GroupNorm statistics from the unrounded f32 conv
    sums with the single-pass variance E[x^2] - mean^2; the affine applied
    to h1 and h2 stored in the input dtype; a1 rounded to the input dtype;
    a2, the 1x1 conv and the bias in f32. NHWC in. Returns the conv sums
    ``h1`` and ``h2`` (float32, before they are stored in the input dtype),
    each GroupNorm's affine ``coef1``, ``coef2`` as ``(a, b)``, each (B, C)
    float32 with silu(h.to(dtype) * a + b), and ``out``, (B, H, W) float32."""
    _check(x_up, x_skip, num_groups)
    dt = x_up.dtype
    denom = float(x_up.shape[1] * x_up.shape[2])

    def conv(x, w):
        return conv2d(x.float(), w.to(dt).float(), padding=1)

    def affine(h, scale, bias):
        mean = h.sum(dim=(1, 2)) / denom
        var = h.square().sum(dim=(1, 2)) / denom - mean * mean
        a = torch.rsqrt(var + eps) * scale.float()
        return a, bias.float() - mean * a

    def silu_affine(h, coef):
        y = h.float() * coef[0][:, None, None, :] + coef[1][:, None, None, :]
        return y * torch.sigmoid(y)

    with highest_precision():
        h1 = conv(x_up, wa) + conv(x_skip, wb)
        coef1 = affine(h1, g1_scale, g1_bias)
        h2 = conv(silu_affine(h1.to(dt), coef1).to(dt), w2)
        coef2 = affine(h2, g2_scale, g2_bias)
        a2 = silu_affine(h2.to(dt), coef2)
        out = torch.matmul(a2, w_out.reshape(-1).float()) + b_out.float().reshape(())
    return {"h1": h1, "h2": h2, "coef1": coef1, "coef2": coef2, "out": out}


def dec1_output_plain(*args, **kwargs) -> torch.Tensor:
    """K5's plain version: the ``out`` of :func:`dec1_stages_plain`, which
    takes the same arguments."""
    return dec1_stages_plain(*args, **kwargs)["out"]


def dec1_output_composition(x_up, x_skip, wa, wb, w2, g1_scale, g1_bias, g2_scale,
                            g2_bias, w_out, b_out, *, num_groups: int = 8,
                            eps: float = 1e-5) -> torch.Tensor:
    """The same slice through the model's own ops (counterpart of
    ``dec1_output_xla``): NHWC in, (B, H, W, 1) float32 out."""
    exact = x_up.dtype == torch.float32
    with highest_precision() if exact else contextlib.nullcontext():
        h1 = conv2d(x_up, wa, padding=1) + conv2d(x_skip, wb, padding=1)
        a1 = silu(group_norm(h1, g1_scale, g1_bias, num_groups=num_groups, eps=eps))
        h2 = conv2d(a1, w2, padding=1)
        a2 = silu(group_norm(h2, g2_scale, g2_bias, num_groups=num_groups, eps=eps))
        return conv2d(a2, w_out, b_out).float()


def fused_dec1_output(x_up, x_skip, wa, wb, w2, g1_scale, g1_bias, g2_scale, g2_bias,
                      w_out, b_out, *, num_groups: int = 8, eps: float = 1e-5,
                      tile_h: int = 64) -> torch.Tensor:
    """K5: the dec1 tail + 1x1 output conv (replaces ``fused_dec1_output``).

    x_up, x_skip: (B, H, W, C) NHWC, C == num_groups; wa, wb, w2:
    (3, 3, C, C) HWIO (wa/wb the up/skip halves of dec1's conv1); g*:
    (C,); w_out: (1, 1, C, 1); b_out: (1,). Returns (B, H, W) float32.
    ``tile_h`` is the kernel's row-tile height, with the JAX fallback rule
    (:func:`effective_tile_h`). On a CPU tensor this is
    :func:`dec1_output_plain`; on a CUDA tensor it launches K5 or raises,
    also under autograd (K5 is forward-only, see ``refuse_autograd``)."""
    _check(x_up, x_skip, num_groups)
    args = (x_up, x_skip, wa, wb, w2, g1_scale, g1_bias, g2_scale, g2_bias, w_out, b_out)
    if x_up.device.type == "cpu":
        return dec1_output_plain(*args, num_groups=num_groups, eps=eps)
    return _launch(*args, eps=eps, tile_h=tile_h)[0]


def _launch(x_up, x_skip, wa, wb, w2, g1_scale, g1_bias, g2_scale, g2_bias, w_out, b_out,
            *, eps: float, tile_h: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors: returns ``out`` and the kernel's stored h1 and h2."""
    name = "fused_dec1_output"
    refuse_autograd(name, x_up, x_skip, wa, wb, w2, g1_scale, g1_bias, g2_scale, g2_bias,
                    w_out, b_out)
    if x_up.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x_up.device}, want cpu or cuda")
    if x_skip.device != x_up.device or x_skip.dtype != x_up.dtype:
        raise ValueError(f"{name}: x_up and x_skip must share device and dtype")
    if x_up.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x_up.dtype} not supported (float32, bfloat16)")
    b, h, w, c = x_up.shape
    if c != _KERNEL_CHANNELS:
        raise ValueError(f"{name}: the CUDA kernel takes C = {_KERNEL_CHANNELS}, got {c}")
    if b * h * w == 0:
        raise ValueError(f"{name}: empty input {tuple(x_up.shape)}")
    xu, xs = x_up.contiguous(), x_skip.contiguous()
    if xu.data_ptr() % 16 or xs.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    th = effective_tile_h(h, tile_h)
    dev, dt = x_up.device, x_up.dtype
    for wt, nm in ((wa, "wa"), (wb, "wb"), (w2, "w2")):
        if tuple(wt.shape) != (3, 3, c, c):
            raise ValueError(f"{name}: {nm} {tuple(wt.shape)} is not (3, 3, {c}, {c})")
    vecs = (g1_scale, g1_bias, g2_scale, g2_bias, w_out, b_out)
    sizes = [t.numel() for t in vecs]
    if sizes != [c] * 5 + [1]:
        raise ValueError(f"{name}: GN parameters, w_out and b_out have {sizes} "
                         f"elements, want {[c] * 5 + [1]}")
    # float32 and contiguous, as the model holds them: then no copy and no
    # launch besides the kernel's own three (the bf16 kernel rounds the conv
    # weights itself)
    prm = [t.detach().to(device=dev, dtype=torch.float32).contiguous()
           for t in (wa, wb, w2, *vecs)]
    h1, h2 = torch.empty_like(xu), torch.empty_like(xu)
    nblk = (h // th) * -(-w // _STRIP)
    part = torch.empty((2 * b * nblk * 2 * c,), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    fn = _build.load("dec1_output").dec1_output
    with torch.cuda.device(dev):
        err = fn(xu.data_ptr(), xs.data_ptr(), *(t.data_ptr() for t in prm), h1.data_ptr(),
                 h2.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, w, th, eps,
                 _DTYPE_CODE[dt], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES["dec1_output"] += 1
    return out, h1, h2


def dec1_output_args(model) -> dict:
    """K5's weights from a LightweightUNet: dec1's conv1 (3, 3, 16, 8) split
    along its input channels into the up-path and skip-path halves (as
    ``conv_block_dual`` splits it), its conv2 and GroupNorm parameters, and
    the output conv; plus ``num_groups``. Use as
    ``fused_dec1_output(x_up, x_skip, **dec1_output_args(model))``."""
    blk = model.dec1
    f = blk.conv2.shape[-1]
    return {
        "wa": blk.conv1[:, :, :f].detach().contiguous(),
        "wb": blk.conv1[:, :, f:].detach().contiguous(),
        "w2": blk.conv2.detach(),
        "g1_scale": blk.gn1_scale.detach(), "g1_bias": blk.gn1_bias.detach(),
        "g2_scale": blk.gn2_scale.detach(), "g2_bias": blk.gn2_bias.detach(),
        "w_out": model.output_conv_weight.detach(),
        "b_out": model.output_conv_bias.detach(),
        "num_groups": blk.groups,
    }
