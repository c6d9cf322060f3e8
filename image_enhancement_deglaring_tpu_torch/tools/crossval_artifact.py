"""Cross-validate a candidate model artifact against the shipped one: the
promotion gate used before replacing ``deploy/models/best_model.onnx``.

    python -m image_enhancement_deglaring_tpu_torch.tools.crossval_artifact \
        --candidate RUN/best_model [--incumbent deploy/models/best_model.onnx] \
        [--n 128] [--seed 123] [--size 512] [--batch_size 8] [--device cuda]

Counterpart of the JAX package's ``scripts/crossval_artifact.py``, with
the same flags, defaults and seed, plus ``--device`` (default cuda;
without a card that raises unless ``--device cpu`` is given). It
generates a fresh held-out synthetic set (a seed neither model has seen)
with the port's ``generate_synthetic_sd1`` and evaluates both artifacts on
it in float32 with the port's harness. It prints one JSON line: each
model's L1/PSNR/SSIM and the verdict, ``promote`` when the candidate's
PSNR is higher and its L1 at most 1.02 x the incumbent's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def verdict(cand: dict, inc: dict) -> str:
    return ("promote" if cand["psnr"] > inc["psnr"] and cand["l1_loss"] <= inc["l1_loss"] * 1.02
            else "keep_incumbent")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--candidate", required=True, help=".onnx / .pth / .npz / checkpoint dir")
    p.add_argument("--incumbent", default=os.path.join(REPO, "deploy", "models",
                                                       "best_model.onnx"))
    p.add_argument("--n", type=int, default=128, help="held-out triptychs to generate")
    p.add_argument("--seed", type=int, default=123,
                   help="generator seed: must differ from any training seed "
                        "(train_synthetic_demo uses 0)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on (cuda, or cpu)")
    args = p.parse_args(argv)

    from ..data import generate_synthetic_sd1, make_eval_loader
    from ..eval import evaluate, load_model_for_eval

    with tempfile.TemporaryDirectory(prefix="crossval_") as d:
        generate_synthetic_sd1(d, n_train=args.n, n_val=0, size=args.size, seed=args.seed)
        loader = make_eval_loader(os.path.join(d, "train"), batch_size=args.batch_size,
                                  seed=42, image_size=args.size, cache_images=True)
        results = {}
        for name, path in (("candidate", args.candidate), ("incumbent", args.incumbent)):
            model, _params = load_model_for_eval(path, device=args.device)
            m = evaluate(model, loader, device=args.device, batch_size=args.batch_size,
                         progress=False)
            results[name] = {k: round(float(m[k]), 4) for k in ("l1_loss", "psnr", "ssim")}

    results["verdict"] = verdict(results["candidate"], results["incumbent"])
    results["n_heldout"] = args.n
    results["seed"] = args.seed
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
