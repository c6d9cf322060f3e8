"""Weights for the port's LightweightUNet.

- ``lightweight_unet_params_from_onnx`` reads the reference ``.onnx`` into
  the JAX package's parameter tree ({"enc1": {"conv1": HWIO, ...}, ...},
  float32 numpy arrays); a copy of the JAX package's importer, numpy only.
- ``load_jax_params`` / ``export_jax_params`` move that tree into and out
  of the port's module state. The port's parameter ``enc1.conv1`` is the
  tree's ``["enc1"]["conv1"]`` in the same layout, so one set of weights
  gives both packages the same model.
- ``load_lightweight_unet`` builds the model from an ``.onnx`` file.

The ONNX export keeps torch parameter names for conv weights and lowers
GroupNorm to InstanceNormalization followed by Mul(scale)/Add(bias) with
anonymous ``onnx::Mul_N`` initializers, recovered from the node names.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .._device import resolve_device
from ..models.unet import LightweightUNet
from .onnx_reader import load_onnx

_BLOCKS = ["enc1", "enc2", "enc3", "enc4", "bottleneck", "dec4", "dec3", "dec2", "dec1"]
_UPCONVS = ["upconv4", "upconv3", "upconv2", "upconv1"]


def _conv_to_hwio(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (O, I, kh, kw) -> HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)).astype(np.float32))


class _TrackedDict(dict):
    """State-dict wrapper that records which keys an importer consumed."""

    def __init__(self, sd):
        super().__init__(sd)
        self.used: set[str] = set()

    def __getitem__(self, key):
        self.used.add(key)
        return super().__getitem__(key)


def _require_all_consumed(sd: _TrackedDict) -> None:
    extra = sorted(k for k in sd if k not in sd.used
                   and not k.endswith("num_batches_tracked"))
    if extra:
        shown = ", ".join(extra[:8]) + ("..." if len(extra) > 8 else "")
        raise ValueError(f"checkpoint keys not consumed by the importer ({len(extra)}): {shown}")


def lightweight_unet_params_from_state_dict(sd: dict[str, np.ndarray]) -> dict:
    """Torch state dict (LightweightUNet names) -> the parameter tree."""
    sd = _TrackedDict(sd)
    params: dict = {}
    for blk in _BLOCKS:
        params[blk] = {
            "conv1": _conv_to_hwio(sd[f"{blk}.0.weight"]),
            "gn1_scale": sd[f"{blk}.1.weight"].astype(np.float32).reshape(-1),
            "gn1_bias": sd[f"{blk}.1.bias"].astype(np.float32).reshape(-1),
            "conv2": _conv_to_hwio(sd[f"{blk}.3.weight"]),
            "gn2_scale": sd[f"{blk}.4.weight"].astype(np.float32).reshape(-1),
            "gn2_bias": sd[f"{blk}.4.bias"].astype(np.float32).reshape(-1),
        }
    for up in _UPCONVS:
        params[up] = {"weight": sd[f"{up}.weight"].astype(np.float32),
                      "bias": sd[f"{up}.bias"].astype(np.float32)}
    params["output_conv_weight"] = _conv_to_hwio(sd["output_conv.weight"])
    params["output_conv_bias"] = sd["output_conv.bias"].astype(np.float32)
    _require_all_consumed(sd)
    return params


def lightweight_unet_params_from_onnx(path: str) -> dict:
    """Parse a LightweightUNet .onnx (e.g. deploy/models/best_model.onnx)
    into the parameter tree."""
    g = load_onnx(path)
    sd: dict[str, np.ndarray] = {}
    for name, arr in g.initializers.items():
        # torch parameter names carry a module dot; anonymous GN initializers
        # are recovered from the Mul/Add nodes below
        if not name.startswith("onnx::") and "." in name:
            sd[name] = np.asarray(arr, dtype=np.float32)
    pat = re.compile(r"^/[^/]+/([a-z_0-9]+)\.(\d)/(Mul|Add)_output")
    for node in g.nodes:
        if node.op_type not in ("Mul", "Add") or not node.outputs:
            continue
        m = pat.match(node.outputs[0])
        if not m:
            continue
        init_name = next((i for i in node.inputs if i in g.initializers), None)
        if init_name is None:
            continue
        blk, idx, kind = m.group(1), m.group(2), m.group(3)
        arr = np.asarray(g.initializers[init_name], dtype=np.float32).reshape(-1)
        sd[f"{blk}.{idx}.{'weight' if kind == 'Mul' else 'bias'}"] = arr
    return lightweight_unet_params_from_state_dict(sd)


def _tree_get(tree: dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def load_jax_params(model: torch.nn.Module, params_np: dict) -> None:
    """Copy the JAX package's parameter tree into ``model`` in place.

    Every parameter ``a.b`` of the model takes ``params_np["a"]["b"]``; the
    arrays must be float32 of the parameter's shape, and the tree must hold
    no leaf the model lacks."""
    names = {name for name, _ in model.named_parameters()}
    leaves = set()

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, key + ".")
            else:
                leaves.add(key)

    walk(params_np, "")
    if leaves != names:
        raise ValueError(f"parameter tree does not match the model: missing "
                         f"{sorted(names - leaves)[:8]}, unexpected {sorted(leaves - names)[:8]}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = np.asarray(_tree_get(params_np, name))
            if arr.dtype != np.float32:
                raise ValueError(f"{name}: dtype {arr.dtype}, want float32")
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, want {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def export_jax_params(model: torch.nn.Module) -> dict:
    """The model's parameters as the JAX package's tree of float32 arrays."""
    tree: dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().to("cpu", torch.float32).numpy().copy()
    return tree


def load_lightweight_unet(path: str, *, dtype: torch.dtype = torch.bfloat16,
                          device="cuda", pallas_gn: bool = False,
                          fused_blocks=False) -> LightweightUNet:
    """LightweightUNet from an ``.onnx`` file, its width taken from the
    artifact's ``enc1.conv1`` kernel, in eval mode on ``device``."""
    if not str(path).lower().endswith(".onnx"):
        raise ValueError(f"expected an .onnx file, got {path!r}")
    dev = resolve_device(device)
    params = lightweight_unet_params_from_onnx(path)
    width = int(params["enc1"]["conv1"].shape[-1])
    model = LightweightUNet(features_start=width, dtype=dtype, pallas_gn=pallas_gn,
                            fused_blocks=fused_blocks,
                            generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params)
    return model.to(dev).eval()
