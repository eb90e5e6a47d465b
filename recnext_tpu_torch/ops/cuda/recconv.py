"""Binding of the fused RecConv2d CUDA kernel (``csrc/recconv.cu``).

The counterpart of ``recnext_tpu/ops/pallas/recconv.py:pallas_rec_conv2d``. The
source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface at first use, into ``recnext_tpu_torch/_build/`` (git-ignored), and
loaded with ``ctypes``. The library name carries a hash of the source, so an edited
kernel is never served from a stale build. Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "recconv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
MAX_LEVEL = 4
KERNEL_SIZES = (3, 5, 7)
# the most dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232448

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process did


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the RecConv2d kernel is built from "
                       f"{SOURCE} with the CUDA toolkit at first use")


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librecconv-{digest[:12]}.so"


def _build(out: Path) -> None:
    """Compile the kernel source into ``out`` (atomically: a half-written library
    is never visible under its final name)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not path.exists():
            t0 = time.perf_counter()
            _build(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        lib.recconv_forward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
        lib.recconv_forward.restype = ctypes.c_int
        lib.recconv_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.recconv_smem_bytes.restype = ctypes.c_int
        lib.recconv_error_string.argtypes = [ctypes.c_int]
        lib.recconv_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


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
