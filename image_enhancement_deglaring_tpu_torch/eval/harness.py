"""Evaluation harness: L1 / PSNR / SSIM over a validation set, on the
device; model loading for evaluation and serving.

Counterpart of ``image_enhancement_deglaring_tpu.eval.harness``, with the
reference's evaluation semantics exactly (reference: evaluate.py:207-324):

- L1 on the raw model output (NOT clipped), in float32   (evaluate.py:251)
- PSNR/SSIM on the clipped output, per image             (evaluate.py:259-272)
- avg L1  = sum of per-batch means / num_batches         (evaluate.py:309)
- avg PSNR/SSIM = sum over images / num_samples          (evaluate.py:310-311)

Eager PyTorch needs no static batch shape, so a ragged final batch runs at
its own size; each batch's scalars stay on the device until one stacked
fetch at the end.

Over several ranks (``mesh=``) every rank reads the same global batches,
pads each to a multiple of the ranks, runs its rows and masks the padded
ones; the per-batch L1 and per-image PSNR/SSIM sums are added over the
ranks once at the end, so the result equals one process's. One process is
the same loop over one rank, which pads nothing.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import resolve_device
from ..modelio.params_import import (
    detect_model_arch,
    enhanced_unet_params_from_onnx,
    enhanced_unet_params_from_state_dict,
    lightweight_unet_params_from_onnx,
    lightweight_unet_params_from_state_dict,
    load_jax_params,
    load_torch_state_dict,
    optimized_unet_params_from_onnx,
    optimized_unet_params_from_state_dict,
    restormer_params_from_state_dict,
)
from ..models import EnhancedUNet, LightweightUNet, OptimizedUNet, Restormer
from ..models.restormer import config_from_params as restormer_config
from ..ops.image import to_uint8
from ..ops.metrics import batched_psnr_ssim
from ..utils.pytree import load_npz_tree


def _eval_step(model, x, y, mask):
    """(L1 sum over the real rows, per-image PSNR and SSIM zeroed on
    padding, raw prediction in float32), so that visualizations don't pay
    a second forward pass. ``mask`` is (B,) 1.0 on the real rows."""
    out = model(x).float()
    y = y.float()
    l1_sum = torch.sum(torch.abs(out - y).sum(dim=(1, 2, 3)) * mask)
    psnrs, ssims = batched_psnr_ssim(out, y, clip_pred=True)
    # where(), not *mask: a padded all-zero row can give psnr = inf
    zero = torch.zeros_like(psnrs)
    return l1_sum, torch.where(mask > 0, psnrs, zero), torch.where(mask > 0, ssims, zero), out


def evaluate(model, val_loader, *, device=None, save_visualizations: bool = False,
             visualizations_dir: str | None = None, max_vis_samples: int = 10,
             batch_size: int | None = None, progress: bool = True, mesh=None) -> dict:
    """Evaluate ``model`` (NHWC float in, NHWC float out) over ``val_loader``
    (yields NHWC float32 numpy batches) on ``device``, under
    ``inference_mode``; a float32 model runs its convs without TF32
    (``highest_precision()``, inside its forward).

    Returns {'l1_loss', 'psnr', 'ssim', 'num_samples'} with the reference's
    averaging. ``device`` defaults to CUDA and raises without a card unless
    "cpu" is passed; the model is moved there. ``batch_size`` is the
    largest batch the loader may yield. ``mesh``: a ``parallel.mesh.
    DataMesh``, which owns the device (a ``device`` naming another one
    raises); every rank passes the same global loader (the module
    docstring) and gets the same result; rank 0 writes the visualizations."""
    from ..parallel.mesh import (DataMesh, all_reduce_sum, batch_sharding, fetch_replicated,
                                 put_from_full, run_device)

    dev = run_device(device, mesh)
    model = model.to(dev).eval()
    ranks = mesh if mesh is not None else DataMesh(1, 0, dev)
    world, rank = ranks.world, ranks.rank
    num_batches = total_samples = vis_count = 0
    # per-batch reduced scalars stay ON DEVICE; one stacked fetch at the
    # end (a float() per batch would wait for every step in turn)
    batch_stats: list = []

    iterator = val_loader
    if progress and rank == 0:
        try:
            from tqdm import tqdm

            iterator = tqdm(val_loader, desc="Evaluating")
        except ImportError:
            pass

    for x, y in iterator:
        b = x.shape[0]
        if batch_size is not None and b > batch_size:
            # the JAX harness compiles one batch shape; the port keeps its
            # contract so that a caller's batch_size means the same
            raise ValueError(
                f"loader batch ({b}) exceeds the compiled eval batch "
                f"({batch_size}); pass batch_size >= the loader's batch size")
        pad = -b % world
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        mask = (np.arange(b + pad) < b).astype(np.float32)
        xt, yt, mt = (put_from_full(a, batch_sharding(ranks)) for a in (x, y, mask))
        with torch.inference_mode():
            l1_sum, psnrs, ssims, out = _eval_step(model, xt, yt, mt)
            batch_stats.append(torch.stack([l1_sum / float(b * np.prod(y.shape[1:])),
                                            psnrs.sum(), ssims.sum()]))
        num_batches += 1
        total_samples += b

        if save_visualizations and visualizations_dir and vis_count < max_vis_samples:
            # over several ranks every rank gathers (a collective) and rank 0
            # draws the global rows
            pred = fetch_replicated(out, mesh)
            ps, ss = fetch_replicated(psnrs, mesh), fetch_replicated(ssims, mesh)
            if rank == 0:
                _save_visualizations(x, y, pred, b, visualizations_dir, vis_count,
                                     max_vis_samples, ps, ss)
            vis_count = min(max_vis_samples, vis_count + b)

    totals = np.zeros(3)
    if batch_stats:
        stacked = torch.stack(batch_stats).double()
        if mesh is not None:
            stacked = all_reduce_sum(stacked, mesh)
        totals = stacked.cpu().numpy().sum(axis=0)
    return {
        "l1_loss": float(totals[0]) / max(num_batches, 1),
        "psnr": float(totals[1]) / max(total_samples, 1),
        "ssim": float(totals[2]) / max(total_samples, 1),
        "num_samples": total_samples,
    }


def _save_visualizations(x, y, pred, b, out_dir, vis_count, max_vis, psnrs, ssims) -> int:
    """``sample_{k}.png``: three 8-bit gray panels side by side, input |
    prediction clipped to [0, 1] | target (``ops.image.to_uint8``: clipped,
    truncated), each panel's title (the JAX
    harness's matplotlib titles, reference: evaluate.py:275-305) in a
    ``tEXt`` chunk of its name. The machine with the card has no
    matplotlib; the port's PNG codec writes the figure. ``pred`` is the
    prediction ``_eval_step`` already computed: no second forward pass."""
    from ..data.png import encode_png

    os.makedirs(out_dir, exist_ok=True)
    for i in range(b):
        if vis_count >= max_vis:
            break
        panels = [
            (x[i, ..., 0], "Input", "Input"),
            (np.clip(pred[i, ..., 0], 0, 1), "Prediction",
             f"Prediction\nPSNR: {psnrs[i]:.2f}, SSIM: {ssims[i]:.4f}"),
            (y[i, ..., 0], "Ground Truth", "Ground Truth"),
        ]
        strip = np.concatenate([to_uint8(torch.from_numpy(np.ascontiguousarray(img))).numpy()
                                for img, _, _ in panels], axis=1)
        text = {key: f"{title}\nRange: [{img.min():.2f}, {img.max():.2f}]"
                for img, key, title in panels}
        with open(os.path.join(out_dir, f"sample_{vis_count}.png"), "wb") as f:
            f.write(encode_png(strip, text=text))
        vis_count += 1
    return vis_count


def load_model_for_eval(model_path: str, *, model_arch: str = "auto",
                        compute_dtype: torch.dtype = torch.float32, device="cuda"):
    """(model, params) from an ``.onnx`` file, a torch ``.pth``/``.pt``
    state dict (the reference's names), a flat ``a/b/c`` ``.npz`` or the
    port's checkpoint directory: the family's model in eval mode on
    ``device``, its width taken from the artifact, and the JAX package's
    parameter tree (float32 numpy) it was loaded from. For EnhancedUNet
    ``params`` is the bundle ``{"params": ..., "batch_stats": ...}``: its
    BatchNorm running statistics travel with the weights, and a source
    without them raises, as in the JAX package.

    A LightweightUNet is the H100 serving configuration, ``kernels=True``
    (K1 at the GroupNorm sites, K3 at the encoder blocks of 64 channels and
    more). On a CPU tensor its sites take the composition, so on the CPU
    the model computes what the JAX model does
    with both knobs off. The other families have no kernel, as in the JAX
    package. A Restormer (upstream's names, its widths read from the
    artifact by ``models.restormer.config_from_params``) runs on cuDNN,
    cuBLAS and ATen, and has no ``.onnx`` form. ``model_arch="auto"``
    finds the family in the artifact
    (``detect_model_arch``). ``device`` defaults to CUDA and raises
    without a card unless "cpu" is passed."""
    dev = resolve_device(device)
    lower = model_path.lower()
    if model_arch == "auto":
        model_arch = detect_model_arch(model_path)
    gen = torch.Generator().manual_seed(0)
    stats = None
    if lower.endswith(".onnx"):
        if model_arch == "restormer":
            raise ValueError(f"{model_path}: Restormer has no ONNX form in the port; load a "
                             ".pth, an .npz or a checkpoint directory")
        if model_arch == "enhanced":
            params, stats = enhanced_unet_params_from_onnx(model_path)
        elif model_arch == "optimized":
            params = optimized_unet_params_from_onnx(model_path)
        else:
            params = lightweight_unet_params_from_onnx(model_path)
    elif lower.endswith((".pth", ".pt")):
        sd = load_torch_state_dict(model_path)
        if model_arch == "restormer":
            params = restormer_params_from_state_dict(sd)
        elif model_arch == "enhanced":
            params, stats = enhanced_unet_params_from_state_dict(sd)
        elif model_arch == "optimized":
            params = optimized_unet_params_from_state_dict(sd)
        else:
            params = lightweight_unet_params_from_state_dict(sd)
    elif lower.endswith(".npz"):
        params = load_npz_tree(model_path)
        # extractions of stateful models nest the collections; stateless
        # families may still arrive wrapped the same way
        if set(params.keys()) <= {"params", "batch_stats"}:
            params, stats = params["params"], params.get("batch_stats")
    elif os.path.isdir(model_path):  # the port's checkpoint directory
        from ..train.checkpoint import restore_checkpoint

        item, _ = restore_checkpoint(model_path)
        params, stats = item["params"], item.get("model_state", {}).get("batch_stats")
    else:
        raise ValueError(f"cannot load {model_path!r}: expected .onnx, .pth/.pt, .npz or a "
                         "checkpoint directory")
    # module widths come from the ARTIFACT, not hard-coded defaults:
    # narrow exports (features_start=4) would otherwise fail to load
    if model_arch == "restormer":
        model = Restormer(**restormer_config(params), dtype=compute_dtype, generator=gen)
        load_jax_params(model, params)
        return model.to(dev).eval(), params
    width = _infer_width(params)
    if model_arch == "enhanced":
        if stats is None:
            raise ValueError(f"{model_path} holds no batch_stats; EnhancedUNet needs the "
                             "BatchNorm running statistics saved with the weights")
        model = EnhancedUNet(init_features=width, dtype=compute_dtype, generator=gen)
        params = {"params": params, "batch_stats": stats}
    elif model_arch == "optimized":
        model = OptimizedUNet(init_features=width, dtype=compute_dtype, generator=gen)
    else:
        model = LightweightUNet(features_start=width, dtype=compute_dtype, kernels=True,
                                generator=gen)
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


def write_results_file(metrics: dict, model_path: str, data_dir: str,
                       model_type: str, out_dir: str | None = None) -> str:
    """evaluation_results.txt in the reference's format (reference: evaluate.py:372-379)."""
    out_dir = out_dir if out_dir is not None else (os.path.dirname(model_path) or ".")
    path = os.path.join(out_dir, "evaluation_results.txt")
    with open(path, "w") as f:
        f.write(f"Evaluation results on {data_dir}:\n")
        f.write(f"Model type: {model_type.upper()}\n")
        f.write(f"Model path: {model_path}\n")
        f.write(f"L1 Loss: {metrics['l1_loss']:.4f}\n")
        f.write(f"PSNR: {metrics['psnr']:.2f} dB\n")
        f.write(f"SSIM: {metrics['ssim']:.4f}\n")
    return path
