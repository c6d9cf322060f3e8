"""Model loading for evaluation and serving.

Counterpart of ``image_enhancement_deglaring_tpu.eval.harness``'s
``load_model_for_eval`` and ``_infer_width``. The harness itself
(``evaluate``, ``write_results_file``) is ROADMAP.md Queue 1 item 6.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..modelio.params_import import (
    detect_model_arch,
    lightweight_unet_params_from_onnx,
    load_jax_params,
)
from ..models.unet import LightweightUNet
from ..utils.pytree import load_npz_tree


def load_model_for_eval(model_path: str, *, model_arch: str = "auto",
                        compute_dtype: torch.dtype = torch.float32, device="cuda"):
    """(model, params) from an ``.onnx`` file, a flat ``a/b/c`` ``.npz`` or
    the port's checkpoint directory: a LightweightUNet in eval mode on
    ``device``, its width taken from the artifact, and the JAX package's
    parameter tree (float32 numpy) it was loaded from.

    The model is the H100 serving configuration: ``pallas_gn=True,
    fused_blocks="auto"`` (K1 at the GroupNorm sites, K3 at the blocks of
    64 channels and more). On a CPU tensor the dispatchers take the
    composition, so on the CPU the model computes what the JAX model does
    with both knobs off. ``model_arch="auto"`` finds the family in the
    artifact (``detect_model_arch``); OptimizedUNet and EnhancedUNet raise
    until the port has them (ROADMAP.md Queue 1 item 9), ``.pth`` files
    until it reads torch state dicts (item 12). ``device`` defaults to
    CUDA and raises without a card unless "cpu" is passed."""
    dev = resolve_device(device)
    lower = model_path.lower()
    if model_arch == "auto":
        model_arch = detect_model_arch(model_path)
    if model_arch != "lightweight":
        raise NotImplementedError(
            f"model family {model_arch!r} is not ported yet (ROADMAP.md Queue 1 item 9)")
    if lower.endswith(".onnx"):
        params = lightweight_unet_params_from_onnx(model_path)
    elif lower.endswith(".npz"):
        params = load_npz_tree(model_path)
        # extractions of stateful models nest the collections; stateless
        # families may still arrive wrapped the same way
        if set(params.keys()) <= {"params", "batch_stats"}:
            params = params["params"]
    elif lower.endswith((".pth", ".pt")):
        raise NotImplementedError(
            ".pth/.pt state dicts are not ported yet (ROADMAP.md Queue 1 item 12)")
    else:  # the port's checkpoint directory
        from ..train.checkpoint import restore_params

        params = restore_params(model_path)
    # module widths come from the ARTIFACT, not hard-coded defaults:
    # narrow exports (features_start=4) would otherwise fail to load
    model = LightweightUNet(features_start=_infer_width(params), dtype=compute_dtype,
                            pallas_gn=True, fused_blocks="auto",
                            generator=torch.Generator().manual_seed(0))
    load_jax_params(model, params)
    return model.to(dev).eval(), params


def _infer_width(params) -> int:
    """First-block output width of an imported param tree (enc1/conv1 is
    (3, 3, in, width) for every family). Fails loudly on a tree without
    that block."""
    try:
        return int(np.asarray(params["enc1"]["conv1"]).shape[-1])
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(
            "cannot infer the model width: the params tree has no "
            "enc1/conv1 kernel (every supported family carries one). "
            "Is this a {params, batch_stats} bundle or a non-model "
            f"artifact? ({type(e).__name__}: {e})") from e
