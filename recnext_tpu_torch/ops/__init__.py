"""Operators: the plain PyTorch versions and the bindings of the CUDA kernels."""
