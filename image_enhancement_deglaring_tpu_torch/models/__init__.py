"""The port's models."""

from .enhanced_unet import AttentionGate, BatchNorm, EnhancedUNet, ResidualBlock
from .model_utils import count_parameters, get_model_size_mb, prune_params
from .optimized_unet import ChannelAttention, OptimizedUNet, UpBlockNearest
from .unet import ConvBlock, DualConvBlock, LightweightUNet, UpConv2x
