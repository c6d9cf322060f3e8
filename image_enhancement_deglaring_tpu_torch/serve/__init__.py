"""Serving: the batched inference engine."""

from .engine import InferenceEngine
