"""Restormer: how the benchmark builds it in the port, its plain reference,
and the work its forward does, counted from the architecture. The family
launches none of the port's hand-written kernels: its convolutions,
products and elementwise work run on cuDNN, cuBLAS and ATen.

Its weights are drawn on the device from ``cfg["weights_seed"]``, which
the driver (``drivers/serve_seeded.py``) sets from ``--seed``: torch's
default init, except the ``output`` conv's. Each of its 3x3 kernels is
centred over its nine taps, so that the body
(output minus input) has no offset: at the default init its mean ran from
-0.4 to +0.9 with the seed, and a positive one clipped most of a bright
page at 255, where the uint8 comparison sees nothing. The kernels are
then scaled by ``init_output_gain`` so that the body varies enough on the
pages for the comparison to see the attention.
"""

from __future__ import annotations

import torch

from ..reference import restormer as ref
from ..reference import seeded_params

STATEFUL = False


#: each stage's level: its side is the image's over 2^(level - 1)
LEVELS = {"encoder_level1": 1, "encoder_level2": 2, "encoder_level3": 3, "latent": 4,
          "decoder_level3": 3, "decoder_level2": 2, "decoder_level1": 1, "refinement": 1}


def flops_per_image(cfg: dict) -> int:
    """Multiply-adds x 2 of one forward at ``image_size``: every conv (the
    1x1 and 3x3 ones, the depthwise 3x3 at one input channel a filter, the
    resampling convs, the embedding and the output conv) and the two
    attention products per head (q k^T and attn v, each HW x C x C/heads).
    LayerNorm, the norms, softmax, GELU and the shuffles are not counted."""
    s, d = cfg["image_size"], cfg["dim"]
    total = 0
    for name, (c, heads) in ref.widths(cfg).items():
        hw = (s >> (LEVELS[name] - 1)) ** 2
        hid = ref.hidden(c, cfg)
        block = (c * 3 * c + 3 * c * 9            # qkv, its depthwise conv
                 + 2 * c * (c // heads)            # q k^T and attn v
                 + c * c                           # project_out
                 + c * 2 * hid + 2 * hid * 9       # project_in, its depthwise conv
                 + hid * c)                        # project_out
        total += 2 * hw * block * ref.depths(cfg)[name]
    total += 2 * s * s * cfg["in_channels"] * d * 9                     # patch_embed
    for level, c in ((1, d), (2, 2 * d), (3, 4 * d)):                   # down: c -> c / 2
        total += 2 * (s >> (level - 1)) ** 2 * c * (c // 2) * 9
    for level, c in ((4, 8 * d), (3, 4 * d), (2, 2 * d)):               # up: c -> 2c
        total += 2 * (s >> (level - 1)) ** 2 * c * 2 * c * 9
    total += 2 * (s // 4) ** 2 * 8 * d * 4 * d + 2 * (s // 2) ** 2 * 4 * d * 2 * d  # reduce_chan
    return total + 2 * s * s * 2 * d * cfg["out_channels"] * 9          # output conv


def blocks_per_forward(cfg: dict) -> dict[tuple[int, int], int]:
    """Transformer blocks of one forward by the (level, channels) their
    spans carry."""
    out: dict[tuple[int, int], int] = {}
    for name, (c, _heads) in ref.widths(cfg).items():
        key = (LEVELS[name], c)
        out[key] = out.get(key, 0) + ref.depths(cfg)[name]
    return out


def kernel_sites(cfg: dict, batch: int) -> dict[str, list[tuple[int, int]]]:
    return {}


def reference_forward(cfg: dict, precision):
    """The reference in ``precision``: NCHW float32 in, NCHW out."""
    return lambda p, x, generator=None: ref.forward(p, x, cfg, precision)


def seed_params(cfg: dict, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """float32 weights in the reference's names and layouts: torch's
    default init; the output conv's kernels centred over their taps, then
    times ``init_output_gain``."""
    p = seeded_params(ref.parameter_init(cfg), gen, device)
    w = p["output.weight"]
    p["output.weight"] = (w - w.mean(dim=(2, 3), keepdim=True)) * cfg["init_output_gain"]
    return p


def onnx_params(cfg: dict, root: str, device) -> dict[str, torch.Tensor]:
    """The configuration's weights for this run: drawn on ``device`` from
    ``cfg["weights_seed"]`` (the same on every call)."""
    if "weights_seed" not in cfg:
        raise SystemExit("perfbench: restormer's weights are drawn from --seed; run the cell "
                         "through a driver that sets cfg['weights_seed'] (drivers/serve_seeded)")
    gen = torch.Generator(device=device).manual_seed(cfg["weights_seed"])
    return seed_params(cfg, gen, device)


def port_names(cfg: dict) -> dict[str, str]:
    """reference name -> the port's parameter name (upstream's, in both)."""
    return {k: k for k in ref.parameter_init(cfg)}


def to_port_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A reference tensor in the port's layout: convs HWIO, the rest as is."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def _widths(cfg: dict) -> dict:
    keys = ("dim", "num_blocks", "num_refinement_blocks", "heads", "ffn_expansion_factor",
            "bias", "layernorm_type", "in_channels", "out_channels")
    return {k: cfg[k] for k in keys}


def training_model(cfg: dict, device):
    """The model as ``cli.train --model restormer`` builds it."""
    from image_enhancement_deglaring_tpu_torch.models import Restormer

    return Restormer(**_widths(cfg), dtype=getattr(torch, cfg["compute_dtype"]), device=device)


def serving_model(cfg: dict, root: str, device):
    """The model as ``load_model_for_eval`` builds it (the configured
    compute dtype, eval mode), carrying this run's seeded weights."""
    model = training_model(cfg, device)
    mine = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in onnx_params(cfg, root, device).items():
            mine[port_names(cfg)[k]].copy_(to_port_layout(k, v))
    return model.eval()
