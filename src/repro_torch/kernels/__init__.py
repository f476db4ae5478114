"""Hand-written Hopper kernels (CUDA C++ under `repro_torch/csrc/`), each
beside its plain PyTorch version."""
