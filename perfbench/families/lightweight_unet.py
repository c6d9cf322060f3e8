"""LightweightUNet: how the benchmark builds it in the port, its plain
reference, and the work its forward does, counted from the architecture.
"""

from __future__ import annotations

import contextlib
import hashlib
import os

import torch

from ..inputs.onnx_weights import read_initializers
from ..reference import lightweight_unet as ref
from ..reference import seeded_params

STATEFUL = False

BF16_BYTES = 2


def widths(cfg: dict) -> list[int]:
    return [cfg["features_start"] * 2 ** i for i in range(5)]


def _conv3x3(h: int, w: int, cin: int, cout: int) -> int:
    return 2 * h * w * 9 * cin * cout


def flops_per_image(cfg: dict) -> int:
    """Multiply-adds x 2 of one forward at ``image_size``: every 3x3 conv,
    the 2x2 up-convs and the 1x1 output conv (pools and GroupNorm+SiLU
    are not counted)."""
    f, s = widths(cfg), cfg["image_size"]
    total, cin = 0, cfg["in_channels"]
    for level, c in enumerate(f):
        side = s >> level
        total += _conv3x3(side, side, cin, c) + _conv3x3(side, side, c, c)
        cin = c
    for level in (3, 2, 1, 0):
        c, side = f[level], s >> level
        total += 2 * (side // 2) ** 2 * (2 * c) * (4 * c)  # up-conv from the level below
        total += _conv3x3(side, side, 2 * c, c) + _conv3x3(side, side, c, c)
    return total + 2 * s * s * f[0] * cfg["out_channels"]


def _fused(cfg: dict, c: int) -> bool:
    mode = cfg["fused_blocks"]
    return c >= 64 if mode == "auto" else bool(mode)


def kernel_sites(cfg: dict, batch: int) -> dict[str, list[tuple[int, int]]]:
    """(bytes, operations) of each launch site of the port's fused kernels
    in one bf16 forward of ``batch`` images, by kernel: ``gn_silu`` (K1:
    the activation read once and written once, the scale and bias) and
    ``conv_gn_silu`` (K3: input, weights and output once each, the scale
    and bias; 2 H W 9 Cin Cout operations per image)."""
    f, s = widths(cfg), cfg["image_size"]
    sites: dict[str, list[tuple[int, int]]] = {"gn_silu": [], "conv_gn_silu": []}
    blocks = [(s >> lvl, cin, c) for lvl, (cin, c) in enumerate(zip([1] + f[:4], f))]
    blocks += [(s >> lvl, 2 * f[lvl], f[lvl]) for lvl in (3, 2, 1, 0)]
    for i, (side, cin, c) in enumerate(blocks):
        pix = batch * side * side
        fused = i < 5 and _fused(cfg, c)  # only encoder and bottleneck blocks fuse
        for conv_in in (cin, c):
            if fused:
                nbytes = (pix * (conv_in + c) + 9 * conv_in * c) * BF16_BYTES + 2 * c * 4
                sites["conv_gn_silu"].append((nbytes, _conv3x3(side, side, conv_in, c) * batch))
            elif cfg["pallas_gn"]:
                sites["gn_silu"].append((2 * pix * c * BF16_BYTES + 2 * c * 4, 0))
    return sites


def reference_forward(cfg: dict, precision):
    return lambda p, x, generator=None: ref.forward(p, x, precision)


def weights_path(cfg: dict, root: str) -> str:
    """The configuration's weights file, which has to be the one whose
    sha256 the configuration pins: other weights are another yardstick."""
    path = os.path.join(root, cfg["weights"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != cfg["weights_sha256"]:
        raise SystemExit(f"perfbench: {cfg['weights']} has sha256 {digest}, "
                         f"the configuration pins {cfg['weights_sha256']}")
    return path


def onnx_params(cfg: dict, root: str, device) -> dict[str, torch.Tensor]:
    """The weights file's initializers the reference reads, as float32
    tensors on ``device``."""
    arrays = read_initializers(weights_path(cfg, root))
    init = ref.parameter_init(cfg["features_start"])
    return {k: torch.from_numpy(arrays[k]).float().reshape(shape).to(device)
            for k, (shape, _) in init.items()}


def seed_params(cfg: dict, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    return seeded_params(ref.parameter_init(cfg["features_start"]), gen, device)


def _port_name(name: str) -> str:
    """The port's parameter for one reference parameter."""
    if name.startswith("output_conv."):
        return name.replace(".", "_")
    if name.startswith("upconv"):
        return name
    blk, idx, kind = name.split(".")
    return f"{blk}." + {"0": "conv1", "3": "conv2"}.get(
        idx, f"gn{1 if idx == '1' else 2}_{'scale' if kind == 'weight' else 'bias'}")


def port_names(cfg: dict) -> dict[str, str]:
    """reference name -> the port's parameter name."""
    return {k: _port_name(k) for k in ref.parameter_init(cfg["features_start"])}


def to_port_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A reference tensor in the port's layout: convs HWIO, the rest as is."""
    if t.dim() == 4 and not name.startswith("upconv"):
        return t.permute(2, 3, 1, 0)
    return t


def serving_model(cfg: dict, root: str, device):
    """The model as ``cli.serve`` builds it (``load_model_for_eval``: bf16,
    the fused kernels on) from the configuration's weights file."""
    from image_enhancement_deglaring_tpu_torch.eval.harness import load_model_for_eval

    model, _ = load_model_for_eval(weights_path(cfg, root),
                                   model_arch="lightweight",
                                   compute_dtype=getattr(torch, cfg["compute_dtype"]),
                                   device=device)
    return model


def training_model(cfg: dict, device):
    """The model as ``cli.train`` builds it: the composition (the kernels are
    forward-only), in the configured compute dtype."""
    from image_enhancement_deglaring_tpu_torch.models import LightweightUNet

    return LightweightUNet(features_start=cfg["features_start"], num_groups=cfg["num_groups"],
                           dtype=getattr(torch, cfg["compute_dtype"]), device=device)


@contextlib.contextmanager
def annotate_norm_act(model, record):
    """Each GroupNorm+SiLU of the composition inside ``record(name)`` (a
    profiler range), for the traced run."""
    from image_enhancement_deglaring_tpu_torch.ops import conv_blocks

    orig = conv_blocks._gn_silu_fn

    def annotated(*a, **k):
        fn = orig(*a, **k)

        def gn_silu(*args):
            with record("perfbench.norm_act"):
                return fn(*args)
        return gn_silu

    conv_blocks._gn_silu_fn = annotated
    try:
        yield
    finally:
        conv_blocks._gn_silu_fn = orig
