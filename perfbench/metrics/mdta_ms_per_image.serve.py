"""Device milliseconds per served image inside Restormer's
``restormer.mdta`` spans (each block's LayerNorm, channel attention and
residual add), summed over a forward's blocks: the mean per image of the
whole spans of each level and width in the traced slice, times the
blocks of the forward there (``perfbench/block_spans.py``)."""

from perfbench.block_spans import device_ms_per_image


def read(run):
    return device_ms_per_image(run, "restormer.mdta")
