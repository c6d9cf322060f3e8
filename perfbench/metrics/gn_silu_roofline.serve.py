"""GroupNorm+SiLU (``gn_silu_flat``, ``csrc/gn_silu.cu``) against its
roofline over the traced slice of serving: the activation read once and
written once per launch site, at the memory bandwidth."""

from perfbench.roofline import share


def read(run):
    return share(run, "gn_silu", lambda n: "gn_silu_kernel" in n, 1)
