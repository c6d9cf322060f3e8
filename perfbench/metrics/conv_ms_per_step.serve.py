"""Device milliseconds per serving step in cuDNN convolution kernels, over
the traced slice (the port's own kernels are not counted here)."""

PORT = ("gnk::", "conv3x3_tc_kernel", "conv_gn_finalize", "dec1_")
CONV = ("conv", "fprop", "implicit", "cudnn")


def is_conv(name: str) -> bool:
    low = name.lower()
    return not any(p in name for p in PORT) and any(c in low for c in CONV)


def read(run):
    t, steps = run.trace_data, len(run.trace_spans)
    if t is None or not steps:
        return None
    seconds, launches = t.kernel_s(is_conv)
    return seconds / steps * 1e3 if launches else None
