"""Binding of the fused RecConv2d CUDA kernel (``csrc/recconv.cu``).

The counterpart of ``recnext_tpu/ops/pallas/recconv.py:pallas_rec_conv2d``. The
source is built with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (``ops/cuda/build.py``). Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary

SOURCE = PKG / "csrc" / "recconv.cu"
MAX_LEVEL = 4
KERNEL_SIZES = (3, 5, 7)
# the most dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232448


def _declare(lib: ctypes.CDLL) -> None:
    lib.recconv_forward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                    + [ctypes.c_void_p])
    lib.recconv_forward.restype = ctypes.c_int
    lib.recconv_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.recconv_smem_bytes.restype = ctypes.c_int
    lib.recconv_error_string.argtypes = [ctypes.c_int]
    lib.recconv_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("recconv", SOURCE, _declare)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    return LIBRARY.load()


def recconv_cuda(x: torch.Tensor, down_w: torch.Tensor, conv_ws: Sequence[torch.Tensor],
                 *, level: int) -> torch.Tensor:
    """Launch the fused pyramid on x's current stream. x: contiguous NCHW f32/bf16;
    weights (C, 1, k, k) in x's dtype, on x's device. Raises on anything else."""
    if not x.is_cuda:
        raise ValueError("recconv_cuda: x must be a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"recconv_cuda: dtype {x.dtype} not supported (f32, bf16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("recconv_cuda: x must be a contiguous NCHW tensor")
    if not 1 <= level <= MAX_LEVEL:
        raise ValueError(f"recconv_cuda: level {level} not in 1..{MAX_LEVEL}")
    if len(conv_ws) != level + 1:
        raise ValueError(f"recconv_cuda: expected {level + 1} conv kernels, got {len(conv_ws)}")
    n, c, h, w = x.shape
    k = int(down_w.shape[-1])
    if k not in KERNEL_SIZES:
        raise ValueError(f"recconv_cuda: kernel size {k} not in {KERNEL_SIZES}")
    for wt in (down_w, *conv_ws):
        if (tuple(wt.shape) != (c, 1, k, k) or wt.dtype != x.dtype
                or wt.device != x.device or not wt.is_contiguous()):
            raise ValueError(f"recconv_cuda: weights must be contiguous ({c}, 1, {k}, {k}) "
                             f"{x.dtype} on {x.device}, got {tuple(wt.shape)} {wt.dtype} "
                             f"on {wt.device}")
    lib = load_library()
    smem = lib.recconv_smem_bytes(h, w, level, k)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"recconv_cuda: a {h}x{w} plane at level {level} needs {smem} "
                         f"bytes of shared memory, more than {MAX_SMEM_BYTES}")
    y = torch.empty_like(x)
    ptrs = [wt.data_ptr() for wt in conv_ws] + [None] * (MAX_LEVEL + 1 - len(conv_ws))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recconv_forward(x.data_ptr(), y.data_ptr(), down_w.data_ptr(), *ptrs,
                                  n, c, h, w, level, k, int(x.dtype == torch.bfloat16),
                                  stream)
    if err != 0:
        raise RuntimeError(f"recconv kernel launch failed: "
                           f"{lib.recconv_error_string(err).decode()} ({err})")
    return y
