"""`python -m image_enhancement_deglaring_tpu_torch` — list the CLI entry points."""

HELP = """image-enhancement-deglaring-tpu, PyTorch/CUDA port — document de-glaring on one GPU

Entry points (python -m image_enhancement_deglaring_tpu_torch.cli.<name>;
each takes --device, default cuda, where it runs a model):

  train            train a model (reference: optimized_train.py)
  sweep            hyperparameter sweep: TPE/random + successive halving,
                   trials in lock-step groups on one GPU, --resume
                   (reference: sweep.py)
  evaluate         L1/PSNR/SSIM on a validation set (reference: evaluate.py)
  enhance          batch de-glaring CLI (reference: main.py)
  serve            HTTP API on the batched GPU engine, --workers N HTTP
                   worker processes, --quantize int8 (reference: api/app.py)
  test_api         API smoke tests (reference: api/test_api.py)
  split_image      triptych splitter (reference: scripts/split_image.py)
  check_dataset    SD1 contract validator (reference: scripts/check_png.py)
  make_synthetic   generate an SD1-contract synthetic dataset (no reference
                   counterpart; the real SD1 data is not redistributable)
  export_onnx      export a checkpoint to opset-11 ONNX
                   (reference: scripts/export_to_onnx.py)
  extract_weights  weights-only artifact: .npz, .onnx or a checkpoint dir
                   (reference: scripts/extract_weights.py)

Lifecycle rehearsal (synthesize, sweep, train, export, evaluate, serve through the CLIs):
python -m image_enhancement_deglaring_tpu_torch.tools.e2e_lifecycle [--device cpu]

Smoke test on the card: python3 chip_smoke.py
Docs: README.md, PERF.md, ROADMAP.md
"""

if __name__ == "__main__":
    print(HELP)
