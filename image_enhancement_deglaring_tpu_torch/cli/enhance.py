"""Batch de-glaring CLI (reference: main.py:13-136 — file-or-directory
input, PNG outputs).

    python -m image_enhancement_deglaring_tpu_torch.cli.enhance --input DIR_OR_PNG \
        [--output_dir ./results] [--model_path ./models/best_model] \
        [--mode resize|tile] [--device cuda]

The same flags and defaults as the JAX CLI, plus ``--device`` (default
``cuda``; without a card that raises unless ``--device cpu`` is given).
Images (PNG or JPEG) are read by the port's image path (``serve.imaging``,
``data.jpeg``) and written as PNG. ``--visualize`` writes each
``<stem>_comparison.png`` beside its output: the input's luma and the
output side by side as one gray PNG, the panel titles in ``tEXt`` chunks
(the card's machine has no matplotlib). ``--data_parallel [N]`` splits
the work over N local cards with ``cli.serve``'s resolver: resize mode runs
the engine over them with ``--batch_size`` rounded up to a multiple of N,
tile mode the tiler.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="De-glare images using the trained model")
    p.add_argument("--input", type=str, required=True,
                   help="Path to input image or directory")
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--model_path", type=str, default="./models/best_model")
    p.add_argument("--batch_size", type=int, default=1,
                   help="images per device batch in resize mode "
                        "(reference: main.py:19); tile mode batches each "
                        "image's tiles internally and ignores this")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--visualize", action="store_true",
                   help="also write <stem>_comparison.png: input luma | output")
    p.add_argument("--mode", type=str, default="resize", choices=["resize", "tile"])
    p.add_argument("--tile_overlap", type=int, default=32,
                   help="tile-mode overlap in pixels (must be < the tile "
                        "size, i.e. < --image_size)")
    p.add_argument("--data_parallel", type=int, nargs="?", const=0,
                   default=None, metavar="N",
                   help="split work across N local devices (omit N = every "
                        "local device), as cli.serve --data_parallel")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..data.pipeline import decode_inference_image
    from ..eval import load_model_for_eval
    from ..serve import InferenceEngine, TiledInference
    from ..data.png import encode_png
    from ..serve.imaging import decode_image, to_luma
    from ..utils.pytree import flatten_tree

    os.makedirs(args.output_dir, exist_ok=True)
    model, params = load_model_for_eval(args.model_path, compute_dtype=torch.float32,
                                        device=args.device)
    size_mb = sum(np.asarray(p).nbytes for p in flatten_tree(params).values()) / (1024 * 1024)
    print(f"Model loaded successfully - Size: {size_mb:.2f} MB")

    from .serve import build_serving_mesh

    mesh, batch_size = build_serving_mesh(args.data_parallel, max(1, args.batch_size),
                                          args.device)
    if mesh is not None:
        print(f"batch inference data-parallel over {mesh.size} chips (batch {batch_size})")
    device = args.device if mesh is None else None
    if args.mode == "tile":
        tiler = TiledInference(model, tile=args.image_size, overlap=args.tile_overlap,
                               compute_dtype=torch.float32, mesh=mesh, device=device)
        if args.batch_size > 1:
            print("Note: tile mode batches each image's tiles internally; "
                  "--batch_size is ignored")
    else:
        engine = InferenceEngine(model, image_size=args.image_size,
                                 max_batch_size=batch_size, compute_dtype=torch.float32,
                                 warmup=False, mesh=mesh, device=device)

    if os.path.isfile(args.input):
        files = [args.input]
    elif os.path.isdir(args.input):
        files = sorted(
            os.path.join(args.input, f) for f in os.listdir(args.input)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        print(f"Found {len(files)} images to process")
    else:
        raise SystemExit(f"Input path not found: {args.input}")

    def results():
        if args.mode == "tile":
            for path in files:
                print(f"Processing image: {path}")
                with open(path, "rb") as f:
                    img = decode_image(f.read())
                yield path, tiler(to_luma(img.pixels, img.mode, img.palette))
            return
        # decode one image at a time and flush the accumulated prefix on a
        # decode failure, so a corrupt file never discards the outputs of
        # earlier images in the same chunk
        pending_paths: list[str] = []
        pending_xs: list[np.ndarray] = []

        def flush():
            if not pending_paths:
                return
            outs = engine.infer_batch(np.stack(pending_xs))
            for p, out in zip(list(pending_paths), outs):
                yield p, out
            pending_paths.clear()
            pending_xs.clear()

        for path in files:
            print(f"Processing image: {path}")
            try:
                x = decode_inference_image(path, args.image_size)
            except Exception:
                yield from flush()
                raise
            pending_paths.append(path)
            pending_xs.append((x * 255).astype(np.uint8))  # [0,1] -> uint8
            if len(pending_paths) == batch_size:
                yield from flush()
        yield from flush()

    written: set[str] = set()
    for path, out in results():
        # always write PNG (reference: main.py:98); uniquify if two inputs
        # share a stem (scan.png + scan.jpg must not clobber each other)
        stem = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.output_dir, stem + ".png")
        n = 1
        while out_path in written:
            out_path = os.path.join(args.output_dir, f"{stem}_{n}.png")
            n += 1
        written.add(out_path)
        with open(out_path, "wb") as f:
            f.write(encode_png(out))
        print(f"Output saved to: {out_path}")
        if args.visualize:
            # the figure joins the collision set too: an input named
            # x_comparison.png must not be clobbered by x.png's figure
            written.add(_visualize(path, out, out_path, written))

    print(f"All images processed and saved to: {args.output_dir}")


def _visualize(input_path, output_image, output_path, taken=()) -> str:
    """Side-by-side figure (reference: main.py:40-59): the input's luma and
    the output as one gray PNG, top-aligned on white where their heights
    differ, 16 white columns apart, each panel's title in a ``tEXt`` chunk.
    Returns the path written, uniquified against ``taken``."""
    import numpy as np

    from ..data.png import encode_png
    from ..serve.imaging import decode_image, to_luma

    with open(input_path, "rb") as f:
        img = decode_image(f.read())
    panels = [to_luma(img.pixels, img.mode, img.palette), np.asarray(output_image, np.uint8)]
    h = max(p.shape[0] for p in panels)
    left, right = (np.pad(p, ((0, h - p.shape[0]), (0, 0)), constant_values=255) for p in panels)
    fig = np.concatenate([left, np.full((h, 16), 255, np.uint8), right], axis=1)
    base, _ext = os.path.splitext(output_path)
    vis_path = base + "_comparison.png"
    n = 1
    while vis_path in taken:
        vis_path = f"{base}_comparison_{n}.png"
        n += 1
    with open(vis_path, "wb") as f:
        f.write(encode_png(fig, text={"Input": "Input Image (with glare)",
                                      "Output": "De-glared Image"}))
    return vis_path


if __name__ == "__main__":
    main()
