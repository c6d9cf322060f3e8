"""Weight import for the port (numpy ONNX reader, JAX parameter trees and
optimizer state)."""

from .onnx_reader import load_onnx
from .params_import import (
    arch_from_param_keys,
    detect_model_arch,
    enhanced_unet_params_from_onnx,
    enhanced_unet_params_from_state_dict,
    export_jax_batch_stats,
    export_jax_opt_state,
    export_jax_params,
    lightweight_unet_params_from_onnx,
    lightweight_unet_params_from_state_dict,
    load_jax_opt_state,
    load_jax_params,
    load_lightweight_unet,
    load_torch_state_dict,
    optimized_unet_params_from_onnx,
    optimized_unet_params_from_state_dict,
)
