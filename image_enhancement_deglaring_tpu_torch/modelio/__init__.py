"""Weight import for the port (numpy ONNX reader, JAX parameter trees)."""

from .onnx_reader import load_onnx
from .params_import import (
    export_jax_params,
    lightweight_unet_params_from_onnx,
    load_jax_params,
    load_lightweight_unet,
)
