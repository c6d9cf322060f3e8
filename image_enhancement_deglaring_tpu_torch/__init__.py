"""PyTorch/CUDA port of image_enhancement_deglaring_tpu for the NVIDIA H100.

The JAX package beside it is the reference. This package imports torch and
nothing of JAX or of the JAX package. Its hand-written CUDA kernels live in
``csrc/`` and are built with nvcc on first use (``ops._build``).
"""
