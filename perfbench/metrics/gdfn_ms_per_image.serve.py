"""Device milliseconds per served image inside Restormer's
``restormer.gdfn`` spans (each block's LayerNorm, gated-Dconv
feed-forward and residual add), summed over a forward's blocks as
``mdta_ms_per_image.serve`` is (``perfbench/block_spans.py``)."""

from perfbench.block_spans import device_ms_per_image


def read(run):
    return device_ms_per_image(run, "restormer.gdfn")
