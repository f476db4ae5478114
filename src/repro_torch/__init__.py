"""repro_torch: the PyTorch/CUDA port of the Salca reproduction, for an NVIDIA H100.

Sits beside the JAX package `repro` (the reference) and mirrors its layout
module for module; it imports `torch` and nothing of JAX or of `repro`.
"""

__version__ = "0.1.0"
