"""ONNX export CLI (reference: scripts/export_to_onnx.py:251-262 usage).

    python -m image_enhancement_deglaring_tpu_torch.cli.export_onnx \
        --model_path runs/best_model [--model lightweight] [--output best_model.onnx]

Exports a model artifact (the port's checkpoint directory, ``.npz``,
``.pth`` or ``.onnx``) as an opset-11 ONNX model with dynamic
batch/height/width axes named 'input'/'output', for the three U-Net
families, with the JAX CLI's flags and output; a Restormer raises a
``ValueError`` that names the ONNX ops the writer lacks for it. Export is host work: the
artifact is read on the CPU (``load_model_for_eval(..., device="cpu")``)
and written by ``modelio.onnx_writer``, byte for byte the JAX writer's file.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export the de-glaring model to ONNX")
    p.add_argument("--model_path", type=str, required=True,
                   help="checkpoint dir, .npz, .pth, or .onnx")
    p.add_argument("--model", type=str, default="lightweight",
                   choices=["lightweight", "optimized", "enhanced", "restormer"],
                   help="model family the checkpoint belongs to")
    p.add_argument("--output", type=str, default="best_model.onnx")
    p.add_argument("--num_groups", type=int, default=8,
                   help="GroupNorm group budget the lightweight checkpoint "
                        "was trained with (LightweightUNet.num_groups; per-"
                        "block counts resolve to the largest divisor of the "
                        "block width <= this). Must match training: a "
                        "mismatch exports a mis-normalized graph.")
    return p.parse_args(argv)


#: what a Restormer graph needs that the port's ONNX writer does not write
RESTORMER_MISSING_OPS = ("ReduceMean, Sqrt and Div (the channel LayerNorm)",
                         "Conv with group > 1 (the depthwise convs)",
                         "SpaceToDepth and DepthToSpace (pixel-unshuffle and -shuffle)",
                         "ReduceL2, MatMul, Transpose and Softmax (the channel attention)",
                         "Split and Erf (the gated GELU)")


def main(argv=None):
    args = parse_args(argv)
    from ..eval.harness import load_model_for_eval
    from ..modelio import detect_model_arch, onnx_writer

    if args.model == "restormer" or (os.path.exists(args.model_path)
                                     and detect_model_arch(args.model_path) == "restormer"):
        raise ValueError("ONNX export of a Restormer is not supported: the port's ONNX writer "
                         "has no " + ", ".join(RESTORMER_MISSING_OPS))

    # the eval loader reads every artifact the port writes and returns the
    # JAX-named numpy tree ({params, batch_stats} for EnhancedUNet)
    _, params = load_model_for_eval(args.model_path, model_arch=args.model, device="cpu")
    if args.model == "enhanced":
        out = onnx_writer.export_enhanced_unet(params["params"], params["batch_stats"],
                                               args.output)
    elif args.model == "optimized":
        out = onnx_writer.export_optimized_unet(params, args.output)
    else:
        out = onnx_writer.export_lightweight_unet(params, args.output, groups=args.num_groups)
    print(f"Model exported to {out} ({os.path.getsize(out):,} bytes, "
          f"opset 11, dynamic batch/height/width)")


if __name__ == "__main__":
    main()
