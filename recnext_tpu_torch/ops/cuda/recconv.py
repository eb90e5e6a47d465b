"""Binding of the fused RecConv2d CUDA kernel (``csrc/recconv.cu``).

The counterpart of ``recnext_tpu/ops/pallas/recconv.py:pallas_rec_conv2d``. The
source is built with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (``ops/cuda/build.py``). Nothing is built or loaded at import.

The host side lays the kernel out, once per plane shape: ``launch_config`` picks
the team size (threads per (n, c) plane), the planes per block and the shared
memory of one block, and carries the geometry (level sizes, row pitches and
offsets) that the kernel reads as a struct. ``lerp_plan_table`` packs the
plans of every up-step, bilinear from ``ops/resize.py:_bilinear_axis_plan`` or
nearest from ``_nearest_axis_plan``; a copy of it is cached on each device.
``levels_to_peel`` says how many outer levels a plane too large for shared memory
must leave to ``ops/recconv.py:rec_conv2d_peeled``. All are plain Python, so the CPU
tests reach them. ``recconv_level_cuda`` computes one such outer level at any plane
size through ``csrc/recconv_level_bwd.cu:recconv_level_kernel``, the peeled level's
library (``ops/cuda/recconv_level_bwd.py``), beside that level's backward kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary
from recnext_tpu_torch.ops.resize import _bilinear_axis_plan, _nearest_axis_plan

SOURCE = PKG / "csrc" / "recconv.cu"
MAX_LEVEL = 4
KERNEL_SIZES = (3, 5, 7)
MODES = ("bilinear", "nearest")
# the most dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232448
BLOCK_THREADS = 256
TEAM_SIZES = (8, 16, 32, 64, 128, 256)
STRIP = 4  # outputs one thread computes along a row (csrc/recconv.cu: kStrip)


def _declare(lib: ctypes.CDLL) -> None:
    lib.recconv_forward.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_void_p, ctypes.c_int]
                                    + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.recconv_forward.restype = ctypes.c_int
    lib.recconv_kernel_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int),
                                              ctypes.POINTER(ctypes.c_int)]
    lib.recconv_kernel_attributes.restype = ctypes.c_int
    lib.recconv_error_string.argtypes = [ctypes.c_int]
    lib.recconv_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("recconv", SOURCE, _declare)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    return LIBRARY.load()


def kernel_attributes(k: int, dtype: torch.dtype) -> dict:
    """Registers per thread and local (spill and stack) bytes per thread of the
    kernel built for kernel size k and ``dtype``, as the CUDA runtime reports them."""
    lib = load_library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.recconv_kernel_attributes(k, int(dtype == torch.bfloat16), ctypes.byref(regs),
                                        ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"recconv kernel attributes: "
                           f"{lib.recconv_error_string(err).decode()} ({err})")
    return {"registers": regs.value, "local_bytes": local.value}


def level_kernel_attributes(k: int, stride: int, dtype: torch.dtype) -> dict:
    """``kernel_attributes`` of the level kernel (``recconv_level_cuda``) for an
    input of ``dtype``."""
    from recnext_tpu_torch.ops.cuda import recconv_level_bwd

    out = dtype if stride == 1 else torch.float32
    return recconv_level_bwd.kernel_attributes("level", k, stride, (dtype, out))


def pyramid_sizes(h: int, w: int, level: int) -> list[tuple[int, int]]:
    """(h, w) of level 0 (the plane) .. ``level``, each ceil(prev / 2)."""
    sizes = [(h, w)]
    for _ in range(level):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    return sizes


def _ceil_to(a: int, m: int) -> int:
    return -(-a // m) * m


def _axis_plan(in_size: int, out_size: int, mode: str) -> tuple:
    """(idx0, idx1, w1) of one axis; nearest is the lerp (idx, idx, 0), which the
    kernel's ``t0 + (t1 - t0) * w`` turns into the source value exactly."""
    if mode == "bilinear":
        return _bilinear_axis_plan(in_size, out_size)
    if mode == "nearest":
        idx = _nearest_axis_plan(in_size, out_size)
        return idx, idx, np.zeros(len(idx), np.float32)
    raise ValueError(f"recconv_cuda: mode {mode!r} not in {MODES}")


def lerp_plan_table(h: int, w: int, level: int,
                    mode: str = "bilinear") -> tuple[np.ndarray, list[int], list[int]]:
    """The plans of the up-steps l -> l-1 (l = 1..level) packed in one (n, 4) int32
    table of rows (idx0, idx1, w1 as fp32 bits, 0), one 16-byte load each, and the
    row offsets of each up-step's row plan and column plan (index l; 0 at l = 0)."""
    sizes = pyramid_sizes(h, w, level)
    parts, rows, cols, off = [], [0], [0], 0
    for l in range(1, level + 1):
        for axis, offsets in ((0, rows), (1, cols)):
            idx0, idx1, w1 = _axis_plan(sizes[l][axis], sizes[l - 1][axis], mode)
            parts.append(np.stack([idx0.astype(np.int32), idx1.astype(np.int32),
                                   w1.astype(np.float32).view(np.int32),
                                   np.zeros_like(idx0, dtype=np.int32)], axis=1))
            offsets.append(off)
            off += len(idx0)
    return np.concatenate(parts, axis=0), rows, cols


@functools.lru_cache(maxsize=None)
def _device_plan_table(h: int, w: int, level: int, mode: str,
                       device: torch.device) -> torch.Tensor:
    table = lerp_plan_table(h, w, level, mode)[0]
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(table)).to(device)


class LaunchConfig(NamedTuple):
    team: int              # threads that own one (n, c) plane
    planes_per_block: int  # teams in one block
    smem_bytes: int        # dynamic shared memory of one block
    geometry: tuple        # csrc/recconv.cu:Geometry, field by field


def _team_layout(h: int, w: int, level: int, k: int):
    """Shared-memory layout of one team, in 4-byte words: the channel's weights, the
    padded level buffers, the conv output at one level and (odd widths only) the
    staged output plane."""
    p = k // 2
    sizes = pyramid_sizes(h, w, level)
    pitch, buf = [0] * (MAX_LEVEL + 1), [0] * (MAX_LEVEL + 1)
    off = (level + 2) * _ceil_to(k * k, 4)  # weights first, 16-byte rows
    for l, (lh, lw) in enumerate(sizes):
        # the strips of a stride-1 conv at level l and of the downsample from it read
        # up to these columns (outputs past the edge are computed and dropped)
        need = _ceil_to(lw, STRIP) + 2 * p
        if l < level:
            need = max(need, 2 * _ceil_to(sizes[l + 1][1], STRIP) + k - 2)
        # an odd pitch: the lanes of a warp, on consecutive rows, hit distinct banks
        pitch[l], buf[l] = need | 1, off
        off += (lh + 2 * p) * pitch[l]
    tmp_pitch = sizes[1][1] | 1
    tmp, off = off, off + sizes[1][0] * tmp_pitch
    # an even row width lets the kernel write each strip straight to y in vector
    # stores of 2 or 4 elements (no staged output: pitch 0)
    out_pitch = 0 if w % 2 == 0 else w | 1
    out, off = off, off + h * out_pitch
    return sizes, pitch, buf, tmp, tmp_pitch, out, out_pitch, _ceil_to(off, 4)


def _team_stride(words: int, team: int) -> int:
    """Words from one team's region to the next: for teams that share a warp, an odd
    multiple of ``team`` modulo 32, so their lanes on the same row fall in distinct
    banks."""
    return words if team >= 32 else _ceil_to(words - team, 32) + team


def team_size(h: int, w: int) -> int:
    """Threads per plane, from the plane's area: 7^2 and 14^2 -> 8, 28^2 -> 32,
    56^2 -> 128, larger -> 256. Small teams keep the lanes busy at the coarse levels,
    where a plane has few outputs (measured: PERF.md, section 6)."""
    hw = h * w
    return next(t for t, most in ((8, 256), (32, 1024), (128, 4096), (256, None))
                if most is None or hw <= most)


def _staged_span_words(planes: int, h: int, w: int, elem_bytes: int) -> int:
    """Words of the 16-byte chunks that hold a span of planes at any alignment."""
    return _ceil_to(15 + planes * h * w * elem_bytes, 16) // 4


def _check(level: int, k: int) -> None:
    if not 1 <= level <= MAX_LEVEL:
        raise ValueError(f"recconv_cuda: level {level} not in 1..{MAX_LEVEL}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"recconv_cuda: kernel size {k} not in {KERNEL_SIZES}")


def _layout(h: int, w: int, level: int, k: int, elem_bytes: int) -> LaunchConfig:
    """``launch_config`` without its check that the block fits in shared memory."""
    sizes, pitch, buf, tmp, tmp_pitch, out, out_pitch, words = _team_layout(h, w, level, k)
    table, rows, cols = lerp_plan_table(h, w, level)  # the same rows in either mode
    plan_rows = len(table)

    def layout(team):  # the teams, the staged spans of x and of y, the plan table
        per_block = BLOCK_THREADS // team
        xraw = _ceil_to(_team_stride(words, team) * per_block, 4)
        yraw = xraw + _staged_span_words(per_block, h, w, elem_bytes)
        plan = yraw + (_staged_span_words(per_block, h, w, elem_bytes) if out_pitch else 0)
        return per_block, xraw, yraw, plan, plan + 4 * plan_rows

    team = team_size(h, w)
    while team < BLOCK_THREADS and layout(team)[-1] * 4 > MAX_SMEM_BYTES:
        team *= 2  # fewer planes per block
    per_block, xraw, yraw, plan, end = layout(team)
    stride = _team_stride(words, team)
    pad = [0] * (MAX_LEVEL + 1 - len(sizes))
    geometry = ((level,) + tuple(s[0] for s in sizes) + tuple(pad)
                + tuple(s[1] for s in sizes) + tuple(pad) + tuple(pitch) + tuple(buf)
                + tuple(rows) + tuple(pad) + tuple(cols) + tuple(pad)
                + (tmp, tmp_pitch, out, out_pitch, 0, stride, xraw, yraw, plan, plan_rows))
    return LaunchConfig(team, per_block, end * 4, geometry)


@functools.lru_cache(maxsize=None)
def launch_config(h: int, w: int, level: int, k: int, elem_bytes: int) -> LaunchConfig:
    """Team size, planes per block, shared bytes and geometry of an h x w plane whose
    elements take ``elem_bytes``. Raises ValueError when one plane's pyramid does not
    fit in shared memory (``levels_to_peel`` says how many levels to take off)."""
    _check(level, k)
    cfg = _layout(h, w, level, k, elem_bytes)
    if cfg.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"recconv_cuda: a {h}x{w} plane at level {level} needs "
                         f"{cfg.smem_bytes} bytes of shared memory, more than {MAX_SMEM_BYTES}")
    return cfg


@functools.lru_cache(maxsize=None)
def levels_to_peel(h: int, w: int, level: int, k: int, elem_bytes: int) -> int:
    """The fewest outer levels of an h x w plane's pyramid to compute outside the
    kernel so that the kernel's plane (``pyramid_sizes(h, w, level)[p]`` at level
    ``level - p``) fits in shared memory: 0 where the plane fits as it is, ``level``
    where only the conv at the coarsest level is left. The peeled route keeps its
    inner plane in fp32, so ``rec_conv2d_fused`` asks again with ``elem_bytes`` 4
    where the plane does not fit in its own dtype."""
    _check(level, k)
    for p, (ph, pw) in enumerate(pyramid_sizes(h, w, level)[:level]):
        if _layout(ph, pw, level - p, k, elem_bytes).smem_bytes <= MAX_SMEM_BYTES:
            return p
    return level


def recconv_cuda(x: torch.Tensor, down_w: torch.Tensor, conv_ws: Sequence[torch.Tensor],
                 *, level: int, mode: str = "bilinear") -> torch.Tensor:
    """Launch the fused pyramid on x's current stream. x: contiguous NCHW f32/bf16;
    weights (C, 1, k, k) in x's dtype, on x's device; ``mode`` of the up-steps
    bilinear or nearest. Raises on anything else."""
    if not x.is_cuda:
        raise ValueError("recconv_cuda: x must be a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"recconv_cuda: dtype {x.dtype} not supported (f32, bf16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("recconv_cuda: x must be a contiguous NCHW tensor")
    if mode not in MODES:
        raise ValueError(f"recconv_cuda: mode {mode!r} not in {MODES}")
    if len(conv_ws) != level + 1:
        raise ValueError(f"recconv_cuda: expected {level + 1} conv kernels, got {len(conv_ws)}")
    n, c, h, w = x.shape
    k = int(down_w.shape[-1])
    for wt in (down_w, *conv_ws):
        if (tuple(wt.shape) != (c, 1, k, k) or wt.dtype != x.dtype
                or wt.device != x.device or not wt.is_contiguous()):
            raise ValueError(f"recconv_cuda: weights must be contiguous ({c}, 1, {k}, {k}) "
                             f"{x.dtype} on {x.device}, got {tuple(wt.shape)} {wt.dtype} "
                             f"on {wt.device}")
    cfg = launch_config(h, w, level, k, x.element_size())
    lib = load_library()
    plans = _device_plan_table(h, w, level, mode, x.device)
    geometry = (ctypes.c_int * len(cfg.geometry))(*cfg.geometry)
    y = torch.empty_like(x)
    ptrs = [wt.data_ptr() for wt in conv_ws] + [None] * (MAX_LEVEL + 1 - len(conv_ws))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recconv_forward(x.data_ptr(), y.data_ptr(), down_w.data_ptr(), *ptrs,
                                  plans.data_ptr(), ctypes.cast(geometry, ctypes.c_void_p),
                                  len(cfg.geometry), n * c, c, k, cfg.team,
                                  cfg.planes_per_block, cfg.smem_bytes,
                                  int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"recconv kernel launch failed: "
                           f"{lib.recconv_error_string(err).decode()} ({err})")
    return y


def recconv_level_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                       up: torch.Tensor | None = None,
                       mode: str = "bilinear") -> torch.Tensor:
    """Launch one level of a peeled pyramid (``csrc/recconv_level_bwd.cu:
    recconv_level_kernel``) on x's current stream: ``conv(x + resize(up, size(x)), w)``
    at ``stride`` (1 or 2) with zero padding k/2, in fp32; f32 out at stride 2, x's
    dtype at stride 1. x: contiguous NCHW f32/bf16; w: contiguous (C, 1, k, k) f32 on
    x's device; up: None, or (stride 1) contiguous f32 (N, C, ceil(H/2), ceil(W/2)).
    Raises on anything else."""
    if not x.is_cuda:
        raise ValueError("recconv_level_cuda: x must be a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"recconv_level_cuda: dtype {x.dtype} not supported (f32, bf16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("recconv_level_cuda: x must be a contiguous NCHW tensor")
    n, c, h, wd = x.shape
    k = int(w.shape[-1])
    if k not in KERNEL_SIZES:
        raise ValueError(f"recconv_level_cuda: kernel size {k} not in {KERNEL_SIZES}")
    if (tuple(w.shape) != (c, 1, k, k) or w.dtype != torch.float32 or w.device != x.device
            or not w.is_contiguous()):
        raise ValueError(f"recconv_level_cuda: weights must be contiguous ({c}, 1, {k}, {k}) "
                         f"float32 on {x.device}, got {tuple(w.shape)} {w.dtype} on {w.device}")
    if stride not in (1, 2):
        raise ValueError(f"recconv_level_cuda: stride {stride} not in (1, 2)")
    if up is not None:
        uh, uw = pyramid_sizes(h, wd, 1)[1]
        if (stride != 1 or tuple(up.shape) != (n, c, uh, uw) or up.dtype != torch.float32
                or up.device != x.device or not up.is_contiguous()):
            raise ValueError(f"recconv_level_cuda: up must be a contiguous float32 "
                             f"({n}, {c}, {uh}, {uw}) on {x.device} at stride 1")
        if mode not in MODES:
            raise ValueError(f"recconv_level_cuda: mode {mode!r} not in {MODES}")
    from recnext_tpu_torch.ops.cuda import recconv_level_bwd

    return recconv_level_bwd.level_forward_cuda(x, w, stride=stride, up=up, mode=mode)
