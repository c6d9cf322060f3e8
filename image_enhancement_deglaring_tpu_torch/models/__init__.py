"""The port's models."""

from .unet import ConvBlock, DualConvBlock, LightweightUNet, UpConv2x
