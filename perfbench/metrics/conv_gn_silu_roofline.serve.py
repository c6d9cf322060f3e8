"""Conv3x3+GroupNorm+SiLU (``conv3x3_gn_silu``, ``csrc/conv_gn_silu.cu``:
two conv passes and a statistics pass per call) against its roofline over
the traced slice of serving: input, weights and output once each, and
2 H W 9 Cin Cout operations per image at the bf16 peak."""

from perfbench.roofline import share


def read(run):
    return share(run, "conv_gn_silu",
                 lambda n: "conv3x3_tc_kernel" in n or "conv_gn_finalize_kernel" in n, 2)
