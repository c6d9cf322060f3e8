"""EnhancedUNet: how the benchmark builds it in the port, its plain
reference, and the work its forward does, counted from the architecture.
The family launches none of the port's hand-written kernels.
"""

from __future__ import annotations

import contextlib

import torch

from ..reference import enhanced_unet as ref
from ..reference import seeded_params

STATEFUL = True  # BatchNorm statistics and dropout: the step draws from its generator


def flops_per_image(cfg: dict) -> int:
    """Multiply-adds x 2 of one forward at ``image_size``: the 3x3 and
    dilated convs, the 1x1 convs (shortcuts, attention gates, output) and
    the 2x2 up-convs. Pools, BatchNorm and activations are not counted."""
    f, s = cfg["init_features"], cfg["image_size"]
    widths = [f * 2 ** i for i in range(5)]

    def residual(side, cin, c):
        n = 2 * side * side * 9 * (cin * c + c * c)
        return n + (2 * side * side * cin * c if cin != c else 0)

    total, cin = 0, cfg["in_channels"]
    for level, c in enumerate(widths):
        total += residual(s >> level, cin, c)
        cin = c
    side = s >> 5
    total += 2 * side * side * 9 * (16 * f * 32 * f + 32 * f * 32 * f)
    below = 32 * f
    for level in (4, 3, 2, 1, 0):
        c, side = widths[level], s >> level
        total += 2 * (side // 2) ** 2 * below * 4 * c  # up-conv
        total += 2 * side * side * (2 * c * (c // 2) + (c // 2))  # attention gate
        total += residual(side, 2 * c, c)
        below = c
    return total + 2 * s * s * f * cfg["out_channels"]


def kernel_sites(cfg: dict, batch: int) -> dict[str, list[tuple[int, int]]]:
    return {}


def reference_forward(cfg: dict, precision):
    """The reference in ``precision``, taking its input in the compute
    dtype as the model does (its input and first convs; the rest in
    float32, which ``precision`` may round)."""
    dtype = getattr(torch, cfg["compute_dtype"])
    return lambda p, x, generator=None: ref.forward(p, x, precision, generator=generator,
                                                    input_dtype=dtype)


def seed_params(cfg: dict, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    return seeded_params(ref.parameter_init(cfg["init_features"]), gen, device)


def port_names(cfg: dict) -> dict[str, str]:
    """reference name -> the port's parameter name (the same names)."""
    return {k: k for k in ref.parameter_init(cfg["init_features"])}


def to_port_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A reference tensor in the port's layout: convs HWIO, the rest as is."""
    if t.dim() == 4 and not name.startswith("upconv"):
        return t.permute(2, 3, 1, 0)
    return t


def training_model(cfg: dict, device):
    """The model as ``cli.train --model enhanced`` builds it."""
    from image_enhancement_deglaring_tpu_torch.models import EnhancedUNet

    return EnhancedUNet(init_features=cfg["init_features"], dropout_rate=cfg["dropout_rate"],
                        dtype=getattr(torch, cfg["compute_dtype"]), device=device)


@contextlib.contextmanager
def annotate_norm_act(model, record):
    """Each BatchNorm of the model inside ``record(name)`` (a profiler
    range), for the traced run; its ReLUs are found by their aten ops."""
    patched = []
    for m in model.modules():
        if type(m).__name__ == "BatchNorm":
            def forward(*a, _orig=m.forward, **k):
                with record("perfbench.norm_act"):
                    return _orig(*a, **k)
            m.forward = forward
            patched.append(m)
    try:
        yield
    finally:
        for m in patched:
            del m.forward
