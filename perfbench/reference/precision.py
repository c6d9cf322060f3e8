"""Where the reference rounds: the inputs, weights and outputs of its
convolutions and matrix products.

``f32`` rounds nothing, and :func:`exact` turns TF32 off around it.
``bf16`` rounds operands and results to bfloat16, as a bf16 layer with
float32 accumulation does. ``fp8`` rounds operands to float8 e4m3 with
one scale per tensor (its largest magnitude mapped to 448, as fp8
inference stores tensors) and results to bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
    # rounding passes the gradient straight through
    return t + (q * scale - t).detach()


def _straight(fn):
    def rounded(t: torch.Tensor) -> torch.Tensor:
        return t + (fn(t) - t).detach()
    return rounded


class Precision:
    """``operand(t)`` and ``result(t)`` for one precision name."""

    def __init__(self, name: str):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name
        ident = lambda t: t  # noqa: E731
        self.operand = {"f32": ident, "bf16": _straight(_bf16), "fp8": _fp8}[name]
        self.result = ident if name == "f32" else _straight(_bf16)


@contextlib.contextmanager
def exact():
    """TF32 off for cuDNN convolutions and cuBLAS products inside."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
