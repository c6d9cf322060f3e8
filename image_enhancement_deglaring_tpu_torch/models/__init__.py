"""The port's models."""

from .enhanced_unet import AttentionGate, BatchNorm, EnhancedUNet, ResidualBlock
from .model_utils import (
    calibrate_act_scales,
    count_parameters,
    dequantize_params_int8,
    get_model_size_mb,
    prune_params,
    quantize_params_int8,
)
from .optimized_unet import ChannelAttention, OptimizedUNet, UpBlockNearest
from .restormer import Restormer
from .unet import ConvBlock, DualConvBlock, LightweightUNet, UpConv2x
