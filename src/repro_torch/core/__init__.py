"""Salca core in PyTorch: quantization, selection and the paged KV cache."""
