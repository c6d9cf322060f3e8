"""Device milliseconds per training step in ``device_augment_batch``, over
the traced slice."""


def read(run):
    t, steps = run.ops_trace, run.ops_steps
    if t is None or not steps:
        return None
    seconds = t.scoped_kernel_s("perfbench.augment")
    return seconds / steps * 1e3 if seconds else None
