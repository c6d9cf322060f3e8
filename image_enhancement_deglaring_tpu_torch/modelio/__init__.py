"""Weight import and export for the port (numpy ONNX reader, writer and
executor, JAX parameter trees and optimizer state)."""

from .onnx_exec import run_graph, run_onnx
from .onnx_reader import load_onnx
from .onnx_writer import (
    export_enhanced_unet,
    export_lightweight_unet,
    export_model,
    export_optimized_unet,
)
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
    restormer_params_from_state_dict,
)
