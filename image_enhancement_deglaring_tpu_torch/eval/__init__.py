"""Evaluation: model loading for eval and serving (``evaluate`` and
``write_results_file`` come with ROADMAP.md Queue 1 item 6)."""

from .harness import load_model_for_eval

__all__ = ["load_model_for_eval"]
