"""Weights for the port's models.

- ``lightweight_unet_params_from_onnx`` reads the reference ``.onnx`` into
  the JAX package's parameter tree ({"enc1": {"conv1": HWIO, ...}, ...},
  float32 numpy arrays); a copy of the JAX package's importer, numpy only.
  ``optimized_unet_params_from_*`` and ``enhanced_unet_params_from_*`` do
  the same for the other families from a torch state dict of numpy arrays
  or an ``.onnx`` of the JAX package's writer; EnhancedUNet's come with
  its BatchNorm running statistics (the JAX ``batch_stats`` tree).
- ``load_jax_params`` / ``export_jax_params`` / ``export_jax_batch_stats``
  move those trees into and out of the port's module state. The port's
  parameter ``enc1.conv1`` is the tree's ``["enc1"]["conv1"]`` in the same
  layout, and the buffer ``enc1.bn1.mean`` is ``batch_stats["enc1"]["bn1"]
  ["mean"]``, so one set of weights gives both packages the same model.
- ``load_jax_opt_state`` / ``export_jax_opt_state`` move the JAX trainer's
  optimizer state (optax ``inject_hyperparams(chain(clip_by_global_norm,
  adamw))``) into and out of a torch AdamW, so a run continues across the
  packages, under the leaf mapping written out below.
- ``load_lightweight_unet`` builds the model from an ``.onnx`` file.
- ``detect_model_arch`` finds an artifact's model family.

The ONNX export keeps torch parameter names for conv weights and lowers
GroupNorm to InstanceNormalization followed by Mul(scale)/Add(bias) with
anonymous ``onnx::Mul_N`` initializers, recovered from the node names.
"""

from __future__ import annotations

import json
import os
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


def _gn_block_from_sd(sd, blk: str) -> dict:
    """A [Conv -> GN -> SiLU] x 2 Sequential (Conv 0, GN 1, Conv 3, GN 4)."""
    return {
        "conv1": _conv_to_hwio(sd[f"{blk}.0.weight"]),
        "gn1_scale": sd[f"{blk}.1.weight"].astype(np.float32).reshape(-1),
        "gn1_bias": sd[f"{blk}.1.bias"].astype(np.float32).reshape(-1),
        "conv2": _conv_to_hwio(sd[f"{blk}.3.weight"]),
        "gn2_scale": sd[f"{blk}.4.weight"].astype(np.float32).reshape(-1),
        "gn2_bias": sd[f"{blk}.4.bias"].astype(np.float32).reshape(-1),
    }


def lightweight_unet_params_from_state_dict(sd: dict[str, np.ndarray]) -> dict:
    """Torch state dict (LightweightUNet names) -> the parameter tree."""
    sd = _TrackedDict(sd)
    params: dict = {blk: _gn_block_from_sd(sd, blk) for blk in _BLOCKS}
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


def optimized_unet_params_from_state_dict(sd: dict[str, np.ndarray]) -> dict:
    """Torch state dict (OptimizedUNet names) -> the parameter tree.

    Blocks index Conv 0 / GN 1 / Conv 3 / GN 4; the up blocks Upsample 0 /
    Conv 1 / GN 2; the SE gates hold Linear ``fc.0`` / ``fc.2`` (out, in),
    which become 1x1 kernels (1, 1, in, out); the output conv has a bias."""
    sd = _TrackedDict(sd)
    params: dict = {blk: _gn_block_from_sd(sd, blk) for blk in _BLOCKS}
    for up in _UPCONVS:
        params[up] = {
            "conv": _conv_to_hwio(sd[f"{up}.1.weight"]),
            "gn_scale": sd[f"{up}.2.weight"].astype(np.float32).reshape(-1),
            "gn_bias": sd[f"{up}.2.bias"].astype(np.float32).reshape(-1),
        }
    for att in ("attention4", "attention3", "attention2", "attention1"):
        params[att] = {
            name: np.ascontiguousarray(sd[f"{att}.fc.{i}.weight"].astype(np.float32).T)[None, None]
            for name, i in (("fc1", 0), ("fc2", 2))
        }
    params["output_weight"] = _conv_to_hwio(sd["output.weight"])
    params["output_bias"] = sd["output.bias"].astype(np.float32)
    _require_all_consumed(sd)
    return params


def enhanced_unet_params_from_state_dict(sd: dict[str, np.ndarray]) -> tuple[dict, dict]:
    """Torch state dict (EnhancedUNet names) -> (params, batch_stats).

    A residual block's ``conv_block`` indexes Conv 0 / BN 1 / ReLU 2 /
    Dropout 3 / Conv 4 / BN 5, its optional ``shortcut`` Conv 0 / BN 1; the
    bottleneck Sequential the same as a block; an attention gate holds
    ``W_g`` / ``W_x`` / ``psi`` Conv+BN pairs; the output Sequential is
    Conv 0 + Sigmoid."""
    sd = _TrackedDict(sd)
    params: dict = {}
    stats: dict = {}

    def bn(prefix: str):
        return ({"scale": sd[f"{prefix}.weight"].astype(np.float32),
                 "bias": sd[f"{prefix}.bias"].astype(np.float32)},
                {"mean": sd[f"{prefix}.running_mean"].astype(np.float32),
                 "var": sd[f"{prefix}.running_var"].astype(np.float32)})

    for blk in ("enc1", "enc2", "enc3", "enc4", "enc5", "dec5", "dec4", "dec3", "dec2", "dec1"):
        p = {"conv1": _conv_to_hwio(sd[f"{blk}.conv_block.0.weight"]),
             "conv2": _conv_to_hwio(sd[f"{blk}.conv_block.4.weight"])}
        s: dict = {}
        p["bn1"], s["bn1"] = bn(f"{blk}.conv_block.1")
        p["bn2"], s["bn2"] = bn(f"{blk}.conv_block.5")
        if f"{blk}.shortcut.0.weight" in sd:
            p["shortcut_conv"] = _conv_to_hwio(sd[f"{blk}.shortcut.0.weight"])
            p["shortcut_bn"], s["shortcut_bn"] = bn(f"{blk}.shortcut.1")
        params[blk], stats[blk] = p, s
    params["bottleneck_conv1"] = _conv_to_hwio(sd["bottleneck.0.weight"])
    params["bottleneck_conv2"] = _conv_to_hwio(sd["bottleneck.4.weight"])
    params["bottleneck_bn1"], stats["bottleneck_bn1"] = bn("bottleneck.1")
    params["bottleneck_bn2"], stats["bottleneck_bn2"] = bn("bottleneck.5")
    for att in ("attention5", "attention4", "attention3", "attention2", "attention1"):
        p = {"w_g": _conv_to_hwio(sd[f"{att}.W_g.0.weight"]),
             "w_g_bias": sd[f"{att}.W_g.0.bias"].astype(np.float32),
             "w_x": _conv_to_hwio(sd[f"{att}.W_x.0.weight"]),
             "w_x_bias": sd[f"{att}.W_x.0.bias"].astype(np.float32),
             "psi": _conv_to_hwio(sd[f"{att}.psi.0.weight"]),
             "psi_bias": sd[f"{att}.psi.0.bias"].astype(np.float32)}
        s = {}
        p["bn_g"], s["bn_g"] = bn(f"{att}.W_g.1")
        p["bn_x"], s["bn_x"] = bn(f"{att}.W_x.1")
        p["bn_psi"], s["bn_psi"] = bn(f"{att}.psi.1")
        params[att], stats[att] = p, s
    for up in ("upconv5",) + tuple(_UPCONVS):
        params[up] = {"weight": sd[f"{up}.weight"].astype(np.float32),
                      "bias": sd[f"{up}.bias"].astype(np.float32)}
    params["output_weight"] = _conv_to_hwio(sd["output.0.weight"])
    params["output_bias"] = sd["output.0.bias"].astype(np.float32)
    _require_all_consumed(sd)
    return params, stats


def _named_initializers(path: str) -> dict[str, np.ndarray]:
    """An .onnx file's initializers that carry torch parameter names (a
    module dot); generated graph constants have none."""
    return {name: np.asarray(arr, dtype=np.float32)
            for name, arr in load_onnx(path).initializers.items() if "." in name}


def optimized_unet_params_from_onnx(path: str) -> dict:
    """An OptimizedUNet .onnx of the JAX package's writer -> the parameter
    tree. Its SE gate weights are 1x1 conv kernels (O, I, 1, 1) and go back
    to the state dict's Linear (O, I) layout first."""
    sd = _named_initializers(path)
    for name, arr in sd.items():
        if ".fc." in name and arr.ndim == 4:
            sd[name] = arr.reshape(arr.shape[0], arr.shape[1])
    return optimized_unet_params_from_state_dict(sd)


def enhanced_unet_params_from_onnx(path: str) -> tuple[dict, dict]:
    """An EnhancedUNet .onnx of the JAX package's writer -> (params,
    batch_stats); its initializers carry the state dict's names."""
    return enhanced_unet_params_from_state_dict(_named_initializers(path))


def _tree_get(tree: dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def _tree_leaf_names(tree: dict, prefix: str = "") -> set[str]:
    names = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            names |= _tree_leaf_names(v, f"{prefix}{k}.")
        else:
            names.add(f"{prefix}{k}")
    return names


def _copy_tree_into(tensors: dict, tree: dict, what: str) -> None:
    """Copy ``tree``'s float32 leaves into the same-named ``tensors``."""
    leaves = _tree_leaf_names(tree)
    if leaves != set(tensors):
        raise ValueError(f"{what} tree does not match the model: missing "
                         f"{sorted(set(tensors) - leaves)[:8]}, unexpected "
                         f"{sorted(leaves - set(tensors))[:8]}")
    with torch.no_grad():
        for name, t in tensors.items():
            arr = np.asarray(_tree_get(tree, name))
            if arr.dtype != np.float32:
                raise ValueError(f"{name}: dtype {arr.dtype}, want float32")
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {arr.shape}, want {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def load_jax_params(model: torch.nn.Module, params_np: dict,
                    batch_stats: dict | None = None) -> None:
    """Copy the JAX package's parameter tree into ``model`` in place.

    Every parameter ``a.b`` of the model takes ``params_np["a"]["b"]``; the
    arrays must be float32 of the parameter's shape, and the tree must hold
    no leaf the model lacks. ``batch_stats`` (EnhancedUNet's BatchNorm
    running statistics) fills the model's buffers the same way; without it
    the buffers stay as they are. A ``{"params": ..., "batch_stats": ...}``
    bundle (what ``load_model_for_eval`` returns for EnhancedUNet) is taken
    apart into the two."""
    if batch_stats is None and set(params_np) == {"params", "batch_stats"}:
        params_np, batch_stats = params_np["params"], params_np["batch_stats"]
    _copy_tree_into(dict(model.named_parameters()), params_np, "parameter")
    if batch_stats is not None:
        _copy_tree_into(dict(model.named_buffers()), batch_stats, "batch_stats")


def _export_tree(named) -> dict:
    tree: dict = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return tree


def export_jax_params(model: torch.nn.Module) -> dict:
    """The model's parameters as the JAX package's tree of float32 arrays."""
    return _export_tree(model.named_parameters())


def export_jax_batch_stats(model: torch.nn.Module) -> dict:
    """The model's BatchNorm running statistics as the JAX ``batch_stats``
    tree of float32 arrays; ``{}`` for a model without them."""
    return _export_tree(model.named_buffers())


# The optimizer-state leaf mapping, optax's leaf name (path segments joined
# with "/") -> the torch AdamW state it becomes, for the JAX trainer's
# ``inject_hyperparams(chain(clip_by_global_norm, adamw))``:
#   count                       the number of updates (int32)
#   hyperparams/learning_rate   param_groups[*]["lr"] (float32)
#   {adam}/count                state[p]["step"] of every parameter (int32)
#   {adam}/mu/{param}           state[p]["exp_avg"]
#   {adam}/nu/{param}           state[p]["exp_avg_sq"]
# {adam} is inner_state/1/0 with the clip in the chain and inner_state/0/0
# without it (make_optimizer(clip_grad_norm=0) leaves the clip out);
# {param} is the parameter's name in the JAX tree ("enc1/conv1" for the
# port's enc1.conv1).


def arch_from_param_keys(keys) -> str:
    """Model family from a parameter tree's top-level names: EnhancedUNet
    alone has a 5th level and BatchNorm bottleneck modules, OptimizedUNet
    alone SE gates, LightweightUNet neither."""
    keys = set(keys)
    if keys & {"attention5", "enc5", "bottleneck_bn1"}:
        return "enhanced"
    if "attention4" in keys:
        return "optimized"
    return "lightweight"


def detect_model_arch(path: str) -> str:
    """Model family of a checkpoint, as the JAX package's
    ``detect_model_arch`` finds it:
    - .onnx: op census (the port's reader): BatchNormalization appears only
      in EnhancedUNet, Resize/GlobalAveragePool only in OptimizedUNet;
    - .npz: flat ``a/b/c`` key census (``arch_from_param_keys``);
    - a directory: the port's checkpoint, its ``train_meta.json``
      ``model_arch``, else its parameters' module names.
    A ``.pth`` state dict raises until the port reads torch state dicts of
    the JAX package's layouts (ROADMAP.md Queue 1 item 12)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"model artifact not found: {path}")
    lower = path.lower()
    if lower.endswith(".onnx"):
        ops = {n.op_type for n in load_onnx(path).nodes}
        if "BatchNormalization" in ops:
            return "enhanced"
        if "Resize" in ops or "GlobalAveragePool" in ops:
            return "optimized"
        return "lightweight"
    if lower.endswith((".pth", ".pt")):
        raise NotImplementedError(
            ".pth/.pt state dicts are not ported yet (ROADMAP.md Queue 1 item 12)")
    if lower.endswith(".npz"):
        with np.load(path) as flat:
            tops = set()
            for key in flat.files:
                parts = key.split("/")
                # extractions of stateful models nest under params/batch_stats
                tops.add(parts[1] if parts[0] in ("params", "batch_stats")
                         and len(parts) > 1 else parts[0])
            return arch_from_param_keys(tops)
    if os.path.isdir(path):
        meta_path = os.path.join(path, "train_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                arch = json.load(f).get("model_arch")
            if arch:
                return arch
        from ..train.checkpoint import restore_params

        return arch_from_param_keys(restore_params(path).keys())
    raise ValueError(
        f"cannot autodetect a model family from {path!r} — expected .onnx, "
        ".pth/.pt, .npz, or a checkpoint directory")


def _named_leaves(tree, prefix: str = "") -> dict:
    """Leaves of a nested state (dicts, lists, tuples, NamedTuples such as
    optax's own states, or a flat dict already "/"-named) by their
    "/"-joined path; a NamedTuple's segments are its field names."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_named_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _adam_prefix(flat: dict) -> str:
    prefixes = {k.rsplit("/mu/", 1)[0] for k in flat if "/mu/" in k}
    if len(prefixes) != 1:
        raise ValueError(f"not the optimizer state of inject_hyperparams(chain(clip, adamw)): "
                         f"adam moments under {sorted(prefixes) or 'no prefix'}")
    return prefixes.pop()


def load_jax_opt_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                       opt_state_np) -> None:
    """Set ``optimizer`` (a torch AdamW over ``model``'s parameters) to the
    JAX trainer's optimizer state, in place: per parameter ``step``,
    ``exp_avg`` and ``exp_avg_sq`` from optax's ``count``, ``mu`` and
    ``nu`` (the mapping above), and every group's ``lr`` from the injected
    ``learning_rate``. ``opt_state_np`` is the optax state with numpy (or
    jax) leaves, its orbax dict form, or the flat dict that
    :func:`export_jax_opt_state` returns."""
    flat = _named_leaves(opt_state_np)
    adam = _adam_prefix(flat)
    names = {name.replace(".", "/") for name, _ in model.named_parameters()}
    for moment in ("mu", "nu"):
        have = {k[len(f"{adam}/{moment}/"):] for k in flat if k.startswith(f"{adam}/{moment}/")}
        if have != names:
            raise ValueError(f"optimizer state {moment} does not match the model: missing "
                             f"{sorted(names - have)[:8]}, unexpected {sorted(have - names)[:8]}")
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    step = float(np.asarray(flat[f"{adam}/count"]))
    for name, p in model.named_parameters():
        if id(p) not in owned:
            raise ValueError(f"{name} is not a parameter of the optimizer")
        key = name.replace(".", "/")
        moments = {}
        for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            arr = np.array(flat[f"{adam}/{moment}/{key}"], np.float32)  # a copy: the state owns it
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{moment}/{key}: shape {arr.shape}, want {tuple(p.shape)}")
            moments[slot] = torch.from_numpy(arr).to(p.device)
        optimizer.state[p] = {"step": torch.tensor(step, dtype=torch.float32), **moments}
    lr = float(np.asarray(flat["hyperparams/learning_rate"]))
    for group in optimizer.param_groups:
        group["lr"] = lr


def export_jax_opt_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module, *,
                         clip: bool = True) -> dict:
    """The optimizer's state as optax's flat leaves, under the names of the
    mapping above (``clip`` says whether the JAX chain holds the clip). A
    parameter the optimizer has not stepped yet has zero moments."""
    adam = "inner_state/1/0" if clip else "inner_state/0/0"
    out: dict = {}
    steps = set()
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        steps.add(int(round(float(st["step"]))) if "step" in st else 0)
        key = name.replace(".", "/")
        for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            t = st.get(slot)
            out[f"{adam}/{moment}/{key}"] = (
                np.zeros(tuple(p.shape), np.float32) if t is None
                else t.detach().to("cpu", torch.float32).numpy().copy())
    if len(steps) != 1:
        raise ValueError(f"parameters stepped unequally often: {sorted(steps)}")
    count = np.asarray(steps.pop(), np.int32)
    out["count"] = count
    out[f"{adam}/count"] = count.copy()
    out["hyperparams/learning_rate"] = np.asarray(optimizer.param_groups[0]["lr"], np.float32)
    return out


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
