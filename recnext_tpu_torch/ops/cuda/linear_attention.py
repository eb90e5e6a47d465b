"""Binding of the linear-attention CUDA kernel (``csrc/linear_attention.cu``).

The counterpart of ``recnext_tpu/ops/pallas/linear_attention.py:pallas_linear_attention``.
The source is built with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (``ops/cuda/build.py``). Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes

import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary

SOURCE = PKG / "csrc" / "linear_attention.cu"
MAX_DIM = 128  # the largest D and DV the kernel takes


def _declare(lib: ctypes.CDLL) -> None:
    lib.linear_attention_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.linear_attention_forward.restype = ctypes.c_int
    lib.linear_attention_error_string.argtypes = [ctypes.c_int]
    lib.linear_attention_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("linear_attention", SOURCE, _declare)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    return LIBRARY.load()


def linear_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on q's current stream, writing ``out``. Every operand is a
    (B, H, N, D) view with any strides: q and k (B, H, N, D), v and out
    (B, H, N, DV), all f32 or all bf16, on one CUDA device. Raises on anything else."""
    ts = (q, k, v, out)
    if not all(t.is_cuda for t in ts):
        raise ValueError("linear_attention_cuda: every operand must be a CUDA tensor")
    if any(t.device != q.device for t in ts):
        raise ValueError("linear_attention_cuda: operands on different devices")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"linear_attention_cuda: dtype {q.dtype} not supported "
                         "(all operands f32, or all bf16)")
    if any(t.dim() != 4 for t in ts):
        raise ValueError("linear_attention_cuda: operands must be (B, H, N, D) views")
    b, h, n, d = q.shape
    dv = v.shape[-1]
    if (tuple(k.shape) != (b, h, n, d) or tuple(v.shape) != (b, h, n, dv)
            or out.shape != v.shape):
        raise ValueError(f"linear_attention_cuda: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out {tuple(out.shape)}")
    if not (0 < d <= MAX_DIM and 0 < dv <= MAX_DIM) or n == 0:
        raise ValueError(f"linear_attention_cuda: D={d}, DV={dv} and N={n}: the kernel "
                         f"takes 1 <= D, DV <= {MAX_DIM} and N >= 1")
    lib = load_library()
    strides = (ctypes.c_longlong * 16)(*(s for t in ts for s in t.stride()))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.linear_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, n, d, dv, eps, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"linear attention kernel launch failed: "
                           f"{lib.linear_attention_error_string(err).decode()} ({err})")
    return out
