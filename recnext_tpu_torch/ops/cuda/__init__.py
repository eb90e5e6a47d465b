"""Bindings of the hand-written CUDA kernels in recnext_tpu_torch/csrc."""
