"""Evaluation: L1 / PSNR / SSIM over a validation set, the results file,
and model loading for evaluation and serving."""

from .harness import evaluate, load_model_for_eval, write_results_file

__all__ = ["evaluate", "load_model_for_eval", "write_results_file"]
