"""Binding of the peeled level's backward kernels (``csrc/recconv_level_bwd.cu``).

The backward of one level of ``ops/recconv.py:rec_conv2d_peeled``, for planes whose
whole backward does not fit in the shared memory of ``csrc/recconv_bwd.cu``:
``level_dgrad_cuda`` (the conv's input gradient at stride 1 or 2, plus an optional
fine-grid gradient), ``level_wgrad_cuda`` (its weight gradient, z = x + up(u) built
in the kernel's window) and ``up_adjoint_cuda`` (the up-step's adjoint). The source
is its own library (``ops/cuda/build.py``), built with ``nvcc`` for ``sm_90a`` at
first use; nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes

import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary
from recnext_tpu_torch.ops.cuda.recconv import (
    KERNEL_SIZES,
    MODES,
    _device_plan_table,
    pyramid_sizes,
)
from recnext_tpu_torch.ops.cuda.recconv_bwd import MAX_FAN, _device_transposed_table

SOURCE = PKG / "csrc" / "recconv_level_bwd.cu"
TILE = 32  # outputs per side of one block's tile (csrc/recconv_level_bwd.cu: kTile)
KINDS = {"dgrad": 0, "wgrad": 1, "up_adjoint": 2}


def _declare(lib: ctypes.CDLL) -> None:
    lib.recconv_level_dgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.recconv_level_dgrad.restype = ctypes.c_int
    lib.recconv_level_wgrad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.recconv_level_wgrad.restype = ctypes.c_int
    lib.recconv_up_adjoint.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.recconv_up_adjoint.restype = ctypes.c_int
    lib.recconv_level_bwd_attributes.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.recconv_level_bwd_attributes.restype = ctypes.c_int
    lib.recconv_level_bwd_error_string.argtypes = [ctypes.c_int]
    lib.recconv_level_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("recconv_level_bwd", SOURCE, _declare)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    return LIBRARY.load()


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"recconv level backward {what} failed: "
                           f"{lib.recconv_level_bwd_error_string(err).decode()} ({err})")


def kernel_attributes(kind: str, k: int = 5, stride: int = 1,
                      dtypes: tuple = (torch.float32, torch.float32)) -> dict:
    """Registers and local bytes per thread of kernel ``kind`` (dgrad: the dtypes of g
    and of the output; wgrad: of x and of g; up_adjoint: fp32 only)."""
    lib = load_library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    a, b = (int(d == torch.bfloat16) for d in dtypes)
    _raise(lib, lib.recconv_level_bwd_attributes(KINDS[kind], k, stride, a, b,
                                                 ctypes.byref(regs), ctypes.byref(local)),
           f"{kind} attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def tiles(oh: int, ow: int) -> int:
    """Tiles of TILE x TILE outputs that cover an oh x ow plane."""
    return -(-oh // TILE) * -(-ow // TILE)


def _check_planes(name: str, t: torch.Tensor, dtypes=(torch.float32, torch.bfloat16)):
    if not t.is_cuda or t.dtype not in dtypes or t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{name}: a contiguous NCHW CUDA tensor of {dtypes} is needed, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_weight(name: str, w: torch.Tensor, c: int, device) -> int:
    k = int(w.shape[-1])
    if (k not in KERNEL_SIZES or tuple(w.shape) != (c, 1, k, k) or w.dtype != torch.float32
            or w.device != device or not w.is_contiguous()):
        raise ValueError(f"{name}: weights must be contiguous float32 ({c}, 1, k, k), k in "
                         f"{KERNEL_SIZES}, on {device}; got {w.dtype} {tuple(w.shape)} on "
                         f"{w.device}")
    return k


def level_dgrad_cuda(g: torch.Tensor, w: torch.Tensor, *, size: tuple, stride: int = 1,
                     add: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The input gradient of the depthwise conv at ``stride`` (zero padding k/2) whose
    input is ``size`` = (H, W): conv^T(g) (+ add), in ``out_dtype``. g: contiguous NCHW
    f32/bf16 of (ceil(H/stride), ceil(W/stride)); w: contiguous (C, 1, k, k) f32; add:
    None or contiguous f32 (N, C, H, W)."""
    _check_planes("level_dgrad_cuda", g)
    n, c, oh, ow = g.shape
    h, wd = (int(s) for s in size)
    if stride not in (1, 2) or (oh, ow) != (-(-h // stride), -(-wd // stride)):
        raise ValueError(f"level_dgrad_cuda: g of {oh}x{ow} is not the stride-{stride} "
                         f"output of {h}x{wd}")
    k = _check_weight("level_dgrad_cuda", w, c, g.device)
    if add is not None:
        _check_planes("level_dgrad_cuda", add, (torch.float32,))
        if tuple(add.shape) != (n, c, h, wd) or add.device != g.device:
            raise ValueError(f"level_dgrad_cuda: add must be ({n}, {c}, {h}, {wd}) on "
                             f"{g.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"level_dgrad_cuda: out_dtype {out_dtype} not in (f32, bf16)")
    y = torch.empty(n, c, h, wd, dtype=out_dtype, device=g.device)
    lib = load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.recconv_level_dgrad(g.data_ptr(), w.data_ptr(),
                                      None if add is None else add.data_ptr(), y.data_ptr(),
                                      n * c, c, h, wd, k, stride,
                                      int(g.dtype == torch.bfloat16),
                                      int(out_dtype == torch.bfloat16), stream)
    _raise(lib, err, "dgrad launch")
    return y


def level_wgrad_cuda(x: torch.Tensor, g: torch.Tensor, *, k: int, stride: int = 1,
                     up: torch.Tensor | None = None, mode: str = "bilinear") -> torch.Tensor:
    """The weight gradient (C, 1, k, k) f32 of y = conv(x + resize(up, size(x)), w) at
    ``stride`` for dL/dy = g. x: contiguous NCHW f32/bf16; g: contiguous f32/bf16 of the
    output size; up: None or (stride 1) contiguous f32 (N, C, ceil(H/2), ceil(W/2))."""
    _check_planes("level_wgrad_cuda", x)
    _check_planes("level_wgrad_cuda", g)
    n, c, h, wd = x.shape
    if stride not in (1, 2) or k not in KERNEL_SIZES:
        raise ValueError(f"level_wgrad_cuda: stride {stride} / k {k} not supported")
    oh, ow = (h, wd) if stride == 1 else pyramid_sizes(h, wd, 1)[1]
    if tuple(g.shape) != (n, c, oh, ow) or g.device != x.device:
        raise ValueError(f"level_wgrad_cuda: g must be ({n}, {c}, {oh}, {ow}) on {x.device}")
    plans = None
    if up is not None:
        _check_planes("level_wgrad_cuda", up, (torch.float32,))
        uh, uw = pyramid_sizes(h, wd, 1)[1]
        if stride != 1 or tuple(up.shape) != (n, c, uh, uw) or up.device != x.device:
            raise ValueError(f"level_wgrad_cuda: up must be ({n}, {c}, {uh}, {uw}) on "
                             f"{x.device} at stride 1")
        if mode not in MODES:
            raise ValueError(f"level_wgrad_cuda: mode {mode!r} not in {MODES}")
        plans = _device_plan_table(h, wd, 1, mode, x.device)
    partial = torch.empty(c, n * tiles(oh, ow), k * k, dtype=torch.float32, device=x.device)
    dw = torch.empty(c, 1, k, k, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recconv_level_wgrad(x.data_ptr(), None if up is None else up.data_ptr(),
                                      None if plans is None else plans.data_ptr(),
                                      g.data_ptr(), partial.data_ptr(), dw.data_ptr(), n, c, h,
                                      wd, k, stride, int(x.dtype == torch.bfloat16),
                                      int(g.dtype == torch.bfloat16), stream)
    _raise(lib, err, "wgrad launch")
    return dw


def up_adjoint_cuda(dz: torch.Tensor, *, mode: str = "bilinear") -> torch.Tensor:
    """The adjoint of the resize (N, C, ceil(H/2), ceil(W/2)) -> (N, C, H, W), bilinear
    (align_corners=False) or nearest, at dz: a contiguous f32 NCHW CUDA tensor."""
    _check_planes("up_adjoint_cuda", dz, (torch.float32,))
    if mode not in MODES:
        raise ValueError(f"up_adjoint_cuda: mode {mode!r} not in {MODES}")
    n, c, h, wd = dz.shape
    uh, uw = pyramid_sizes(h, wd, 1)[1]
    plans = _device_transposed_table(h, wd, 1, mode, dz.device)
    du = torch.empty(n, c, uh, uw, dtype=torch.float32, device=dz.device)
    lib = load_library()
    with torch.cuda.device(dz.device):
        stream = torch.cuda.current_stream(dz.device).cuda_stream
        err = lib.recconv_up_adjoint(dz.data_ptr(), plans.data_ptr(), du.data_ptr(), n * c, h,
                                     wd, uh * MAX_FAN, stream)
    _raise(lib, err, "up adjoint launch")
    return du
