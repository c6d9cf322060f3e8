"""Device milliseconds per training step in normalization and activation:
kernels launched inside the family's GroupNorm+SiLU or BatchNorm ranges,
by the backward of the ops run inside them, or by a ReLU, forward or
backward, over the traced slice."""

RELU = ("aten::relu", "aten::relu_", "aten::threshold_backward")


def read(run):
    t, steps = run.ops_trace, run.ops_steps
    if t is None or not steps:
        return None
    seconds = t.scoped_kernel_s("perfbench.norm_act", RELU)
    return seconds / steps * 1e3 if seconds else None
