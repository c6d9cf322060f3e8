"""Minimal .env loader, a copy of ``image_enhancement_deglaring_tpu.utils.
envfile`` (python-dotenv is not installed; the reference loads .env at
train import, reference: optimized_train.py:18-19, with keys like
PYTHONHASHSEED and W&B credentials)."""

from __future__ import annotations

import os


def load_dotenv(path: str = ".env", *, override: bool = False) -> dict[str, str]:
    """Parse KEY=VALUE lines (``#`` comments, optional ``export``, simple
    quotes) into os.environ. Returns the parsed mapping."""
    parsed: dict[str, str] = {}
    if not os.path.exists(path):
        return parsed
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            if line.startswith("export "):
                line = line[len("export "):]
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            if value[:1] in ("'", '"'):
                # quoted: the value runs to the matching quote; anything
                # after (incl. comments) is dropped
                q = value[0]
                end = value.find(q, 1)
                value = value[1:end] if end > 0 else value[1:]
            else:
                # python-dotenv strips unquoted inline comments:
                # KEY=abc # note  ->  'abc', not 'abc # note'
                value = value.split(" #", 1)[0].rstrip()
            parsed[key] = value
            if override or key not in os.environ:
                os.environ[key] = value
    return parsed
