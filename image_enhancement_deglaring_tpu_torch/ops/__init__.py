"""NHWC building blocks and the fused CUDA kernels with their plain versions."""

from .conv_blocks import (
    avg_pool_2x2,
    conv2d,
    conv_block,
    conv_block_dual,
    group_norm,
    highest_precision,
    resolve_group_count,
    silu,
    upsample2x_matmul,
)
from .dec1 import (
    dec1_output_args,
    dec1_output_composition,
    dec1_output_plain,
    fused_dec1_output,
)
from .fused_kernels import (
    LAUNCHES,
    conv3x3_gn_silu,
    conv3x3_gn_silu_batched,
    conv3x3_gn_silu_plain,
    fused_conv3x3_gn_silu,
    fused_group_norm_silu,
    gn_silu_flat,
    gn_silu_nhwc,
    gn_silu_plain,
    reset_launch_counts,
)
