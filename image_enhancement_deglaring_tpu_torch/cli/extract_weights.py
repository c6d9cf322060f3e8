"""Weights-only extraction CLI (reference: scripts/extract_weights.py:5-88).

    python -m image_enhancement_deglaring_tpu_torch.cli.extract_weights \
        runs/checkpoint_epoch_10 weights.npz [--model auto]

Loads any supported artifact (the port's training checkpoint with its
optimizer state, ``.npz``, ``.pth``, ``.onnx``) and writes the parameters
alone, in the format the output's extension names: ``.npz`` (flat "a/b/c"
names), ``.onnx`` (``modelio.onnx_writer``), else the port's checkpoint
directory (``train.checkpoint.save_checkpoint`` without optimizer state;
the JAX CLI writes an orbax directory there). EnhancedUNet's BatchNorm
running statistics travel with its parameters.
"""

from __future__ import annotations

import argparse
import os


def _enhanced_tree(path: str) -> tuple[dict, dict]:
    """(params, batch_stats) of an EnhancedUNet artifact."""
    from ..modelio import (
        enhanced_unet_params_from_onnx,
        enhanced_unet_params_from_state_dict,
        load_torch_state_dict,
    )

    lower = path.lower()
    if lower.endswith(".onnx"):
        return enhanced_unet_params_from_onnx(path)
    if lower.endswith((".pth", ".pt")):
        return enhanced_unet_params_from_state_dict(load_torch_state_dict(path))
    if lower.endswith(".npz"):
        from ..utils.pytree import load_npz_tree

        tree = load_npz_tree(path)
        return tree["params"], tree["batch_stats"]
    from ..train.checkpoint import restore_checkpoint

    item, _ = restore_checkpoint(path)
    stats = item.get("model_state", {}).get("batch_stats")
    if stats is None:
        raise SystemExit(f"{path} holds no batch_stats; an EnhancedUNet artifact needs the "
                         "BatchNorm running stats")
    return item["params"], stats


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Extract and save only the model parameters from a checkpoint."
    )
    p.add_argument("checkpoint_path")
    p.add_argument("output_path")
    p.add_argument("--model", type=str, default="auto",
                   choices=["auto", "lightweight", "optimized", "enhanced"],
                   help="model family of the checkpoint (auto = detect "
                        "from the artifact)")
    p.add_argument("--num_groups", type=int, default=8,
                   help="GroupNorm budget for lightweight .onnx output "
                        "(must match training, like cli.export_onnx)")
    args = p.parse_args(argv)

    if not os.path.exists(args.checkpoint_path):
        print(f"Error: Checkpoint file not found at {args.checkpoint_path}")
        return 1

    import numpy as np

    from ..modelio import detect_model_arch

    arch = args.model
    if arch == "auto":
        arch = detect_model_arch(args.checkpoint_path)

    stats = None
    if arch == "enhanced":
        params, stats = _enhanced_tree(args.checkpoint_path)
    else:
        from ..eval.harness import load_model_for_eval

        _, params = load_model_for_eval(args.checkpoint_path, model_arch=arch, device="cpu")

    if args.output_path.endswith(".npz"):
        from ..utils.pytree import flatten_tree

        # EnhancedUNet's running statistics are part of its weights (the
        # torch state dict carries them too): nest both collections
        tree = {"params": params, "batch_stats": stats} if stats else params
        np.savez(args.output_path, **flatten_tree(tree))
    elif args.output_path.endswith(".onnx"):
        from ..modelio import onnx_writer

        if arch == "enhanced":
            onnx_writer.export_enhanced_unet(params, stats, args.output_path)
        elif arch == "optimized":
            onnx_writer.export_optimized_unet(params, args.output_path)
        else:
            onnx_writer.export_lightweight_unet(params, args.output_path,
                                                groups=args.num_groups)
    else:
        from ..train.checkpoint import save_checkpoint

        # the running statistics ride along as model_state, the layout the
        # training loop checkpoints
        save_checkpoint(args.output_path, params=params,
                        model_state={"batch_stats": stats} if stats is not None else None)
    print(f"Model parameters saved to: {args.output_path}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
