"""`python -m image_enhancement_deglaring_tpu_torch` — list the CLI entry points."""

HELP = """image-enhancement-deglaring-tpu, PyTorch/CUDA port — document de-glaring on one GPU

Entry points (python -m image_enhancement_deglaring_tpu_torch.cli.<name>;
each takes --device, default cuda, where it runs a model):

  train            train a model (reference: optimized_train.py)
  evaluate         L1/PSNR/SSIM on a validation set (reference: evaluate.py)
  enhance          batch de-glaring CLI (reference: main.py)
  serve            HTTP API on the batched GPU engine, --workers N HTTP
                   worker processes (reference: api/app.py)
  test_api         API smoke tests (reference: api/test_api.py)
  split_image      triptych splitter (reference: scripts/split_image.py)
  check_dataset    SD1 contract validator (reference: scripts/check_png.py)
  make_synthetic   generate an SD1-contract synthetic dataset (no reference
                   counterpart; the real SD1 data is not redistributable)

Smoke test on the card: python3 chip_smoke.py
Docs: README.md, PERF.md, ROADMAP.md
"""

if __name__ == "__main__":
    print(HELP)
