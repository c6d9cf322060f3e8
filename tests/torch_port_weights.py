"""Seeded weights of the port's model families under the reference's
names, for the port's tests and ``chip_smoke.py`` (torch and numpy, never
JAX).

- ``seeded_tree`` draws a family's parameter tree (and EnhancedUNet's
  ``batch_stats``) from a seeded numpy generator.
- ``state_dict_from_params`` writes such a tree as a state dict under the
  reference's names and layouts: the inverse of the port's
  ``*_params_from_state_dict`` importers.
- ``save_pth`` saves a state dict as the reference's ``.pth``: raw, or
  wrapped as its training checkpoints wrap it.
"""

import numpy as np
import torch

from image_enhancement_deglaring_tpu_torch.modelio import (
    export_jax_batch_stats,
    export_jax_params,
)
from image_enhancement_deglaring_tpu_torch.models import (
    EnhancedUNet,
    LightweightUNet,
    OptimizedUNet,
)

_BLOCKS = ["enc1", "enc2", "enc3", "enc4", "bottleneck", "dec4", "dec3", "dec2", "dec1"]
_UPCONVS = ["upconv4", "upconv3", "upconv2", "upconv1"]


def family_model(arch: str, width: int, **kw):
    """The port's model of a family at a width (its ``features_start`` or
    ``init_features``)."""
    if arch == "lightweight":
        return LightweightUNet(features_start=width, **kw)
    return {"optimized": OptimizedUNet, "enhanced": EnhancedUNet}[arch](init_features=width, **kw)


def seeded_tree(arch: str, seed: int, width: int):
    """(params, batch_stats or None) in the shapes of the family's tree,
    drawn from a seeded numpy generator (an init's flat output would hide a
    swap): kernels N(0, 1 / fan-in), vectors N(0, 0.1) (normalization
    scales about 1), running variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    model = family_model(arch, width, generator=torch.Generator().manual_seed(seed))

    def draw(tree, path=""):
        if isinstance(tree, dict):
            return {k: draw(v, f"{path}/{k}") for k, v in tree.items()}
        shape = np.asarray(tree).shape
        if path.endswith("/var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        base = 1.0 if path.endswith("scale") else 0.0
        sigma = 1 / np.sqrt(np.prod(shape[:-1])) if len(shape) > 1 else 0.1
        return (base + rng.normal(0, sigma, shape)).astype(np.float32)

    stats = draw(export_jax_batch_stats(model)) if arch == "enhanced" else None
    return draw(export_jax_params(model)), stats


def _hwio_to_conv(w) -> np.ndarray:
    """HWIO -> torch Conv2d (O, I, kh, kw)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


def state_dict_from_params(arch: str, params: dict,
                           batch_stats: dict | None = None) -> dict[str, np.ndarray]:
    """The inverse of the ``*_params_from_state_dict`` importers: a
    parameter tree (and EnhancedUNet's ``batch_stats``) as a state dict
    under the reference's names and layouts, float32 numpy. ``torch.save``
    of it (as tensors) is a ``.pth`` the importers read back exactly."""
    sd: dict[str, np.ndarray] = {}
    f32 = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))  # noqa: E731
    if arch in ("lightweight", "optimized"):
        for blk in _BLOCKS:
            p = params[blk]
            sd[f"{blk}.0.weight"] = _hwio_to_conv(p["conv1"])
            sd[f"{blk}.1.weight"], sd[f"{blk}.1.bias"] = f32(p["gn1_scale"]), f32(p["gn1_bias"])
            sd[f"{blk}.3.weight"] = _hwio_to_conv(p["conv2"])
            sd[f"{blk}.4.weight"], sd[f"{blk}.4.bias"] = f32(p["gn2_scale"]), f32(p["gn2_bias"])
    if arch == "lightweight":
        for up in _UPCONVS:
            sd[f"{up}.weight"], sd[f"{up}.bias"] = f32(params[up]["weight"]), f32(params[up]["bias"])
        sd["output_conv.weight"] = _hwio_to_conv(params["output_conv_weight"])
        sd["output_conv.bias"] = f32(params["output_conv_bias"])
    elif arch == "optimized":
        for up in _UPCONVS:
            sd[f"{up}.1.weight"] = _hwio_to_conv(params[up]["conv"])
            sd[f"{up}.2.weight"] = f32(params[up]["gn_scale"])
            sd[f"{up}.2.bias"] = f32(params[up]["gn_bias"])
        for att in ("attention4", "attention3", "attention2", "attention1"):
            sd[f"{att}.fc.0.weight"] = f32(np.asarray(params[att]["fc1"])[0, 0].T)
            sd[f"{att}.fc.2.weight"] = f32(np.asarray(params[att]["fc2"])[0, 0].T)
        sd["output.weight"] = _hwio_to_conv(params["output_weight"])
        sd["output.bias"] = f32(params["output_bias"])
    elif arch == "enhanced":
        if batch_stats is None:
            raise ValueError("an EnhancedUNet state dict needs its batch_stats")

        def bn(prefix, p, st):
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = f32(p["scale"]), f32(p["bias"])
            sd[f"{prefix}.running_mean"] = f32(st["mean"])
            sd[f"{prefix}.running_var"] = f32(st["var"])

        for blk in ("enc1", "enc2", "enc3", "enc4", "enc5", "dec5", "dec4", "dec3", "dec2",
                    "dec1"):
            p, st = params[blk], batch_stats[blk]
            sd[f"{blk}.conv_block.0.weight"] = _hwio_to_conv(p["conv1"])
            sd[f"{blk}.conv_block.4.weight"] = _hwio_to_conv(p["conv2"])
            bn(f"{blk}.conv_block.1", p["bn1"], st["bn1"])
            bn(f"{blk}.conv_block.5", p["bn2"], st["bn2"])
            if "shortcut_conv" in p:
                sd[f"{blk}.shortcut.0.weight"] = _hwio_to_conv(p["shortcut_conv"])
                bn(f"{blk}.shortcut.1", p["shortcut_bn"], st["shortcut_bn"])
        sd["bottleneck.0.weight"] = _hwio_to_conv(params["bottleneck_conv1"])
        sd["bottleneck.4.weight"] = _hwio_to_conv(params["bottleneck_conv2"])
        bn("bottleneck.1", params["bottleneck_bn1"], batch_stats["bottleneck_bn1"])
        bn("bottleneck.5", params["bottleneck_bn2"], batch_stats["bottleneck_bn2"])
        for att in ("attention5", "attention4", "attention3", "attention2", "attention1"):
            p, st = params[att], batch_stats[att]
            for mod, key in (("W_g", "w_g"), ("W_x", "w_x"), ("psi", "psi")):
                sd[f"{att}.{mod}.0.weight"] = _hwio_to_conv(p[key])
                sd[f"{att}.{mod}.0.bias"] = f32(p[f"{key}_bias"])
            bn(f"{att}.W_g.1", p["bn_g"], st["bn_g"])
            bn(f"{att}.W_x.1", p["bn_x"], st["bn_x"])
            bn(f"{att}.psi.1", p["bn_psi"], st["bn_psi"])
        for up in ("upconv5",) + tuple(_UPCONVS):
            sd[f"{up}.weight"], sd[f"{up}.bias"] = f32(params[up]["weight"]), f32(params[up]["bias"])
        sd["output.0.weight"] = _hwio_to_conv(params["output_weight"])
        sd["output.0.bias"] = f32(params["output_bias"])
    else:
        raise ValueError(f"unknown model family {arch!r}")
    return sd


def save_pth(path, sd: dict, wrap: str = "raw") -> str:
    """``torch.save`` of a state dict of arrays: raw, or inside a training
    checkpoint ({"model_state_dict": ..., "epoch": ...}) or {"state_dict":
    ...}."""
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    obj = {"raw": tensors, "model_state_dict": {"model_state_dict": tensors, "epoch": 3,
                                                "loss": 0.1, "optimizer_state_dict": {}},
           "state_dict": {"state_dict": tensors}}[wrap]
    torch.save(obj, str(path))
    return str(path)
