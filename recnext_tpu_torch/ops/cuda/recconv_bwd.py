"""Binding of the RecConv2d backward kernel (``csrc/recconv_bwd.cu``).

The gradient of ``recnext_tpu/ops/recconv.py:rec_conv2d`` (bias-free, bilinear or
nearest), which has no Pallas backward in the JAX package: given x, the weights and
g = dL/dy, the kernel returns dx and the weight gradients. The source is its own
library (``ops/cuda/build.py``), built with ``nvcc`` for ``sm_90a`` at first use;
nothing is built or loaded at import.

The host side lays the kernel out, once per plane shape, in plain Python that the
CPU tests reach: ``launch_config`` gives the team size (threads per (n, c) plane),
the teams in a block of 256 threads, the block's shared memory and the geometry the
kernel reads as a struct (level sizes, row pitches, buffer offsets, plan offsets);
``transposed_plan_table`` packs the adjoint of every up-step as a gather: for each
coarse index, the fine indices and weights that read it (at most ``MAX_FAN`` per
axis), built from the same ``_axis_plan`` as the forward kernel's
``lerp_plan_table``. ``levels_to_peel_backward`` says how many outer levels a
plane whose backward does not fit in one block's shared memory must leave to
``ops/recconv.py:rec_conv2d_peeled_backward`` (the peeled levels' kernels are
``csrc/recconv_level_bwd.cu``), chosen by shape before any launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary
from recnext_tpu_torch.ops.cuda.recconv import (
    BLOCK_THREADS,
    KERNEL_SIZES,
    MAX_LEVEL,
    MAX_SMEM_BYTES,
    MODES,
    STRIP,
    _axis_plan,
    _ceil_to,
    _device_plan_table,
    _team_stride,
    lerp_plan_table,
    pyramid_sizes,
)

SOURCE = PKG / "csrc" / "recconv_bwd.cu"
MAX_FAN = 4  # fine indices that read one coarse index, per axis (bilinear 4, nearest 2)
# the dynamic shared memory a block may take: the H100's 227 KB less the kernel's
# static copy of its geometry (csrc/recconv_bwd.cu: Geometry, 58 ints), rounded up
MAX_DYNAMIC_SMEM = MAX_SMEM_BYTES - 256


def _declare(lib: ctypes.CDLL) -> None:
    lib.recconv_backward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_void_p, ctypes.c_int]
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.recconv_backward.restype = ctypes.c_int
    lib.recconv_backward_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.POINTER(ctypes.c_int),
                                                ctypes.POINTER(ctypes.c_int)]
    lib.recconv_backward_attributes.restype = ctypes.c_int
    lib.recconv_backward_resident.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.recconv_backward_resident.restype = ctypes.c_int
    lib.recconv_backward_error_string.argtypes = [ctypes.c_int]
    lib.recconv_backward_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("recconv_bwd", SOURCE, _declare)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    return LIBRARY.load()


def kernel_attributes(k: int, dtype: torch.dtype) -> dict:
    """Registers and local (spill and stack) bytes per thread of the backward kernel
    built for kernel size k and ``dtype``, as the CUDA runtime reports them."""
    lib = load_library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.recconv_backward_attributes(k, int(dtype == torch.bfloat16),
                                          ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"recconv backward kernel attributes: "
                           f"{lib.recconv_backward_error_string(err).decode()} ({err})")
    return {"registers": regs.value, "local_bytes": local.value}


def resident_blocks(h: int, w: int, level: int, k: int, dtype: torch.dtype) -> int:
    """Blocks of the backward of an h x w plane that one SM of the current device
    holds at once, as the CUDA runtime reports them."""
    lib = load_library()
    blocks = ctypes.c_int()
    err = lib.recconv_backward_resident(k, int(dtype == torch.bfloat16),
                                        launch_config(h, w, level, k).smem_bytes,
                                        ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"recconv backward kernel occupancy: "
                           f"{lib.recconv_backward_error_string(err).decode()} ({err})")
    return blocks.value


def transposed_axis_plan(coarse: int, fine: int, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """The adjoint of one axis of the up-step coarse -> fine, as a gather: (idx, w),
    each (coarse, MAX_FAN), so that ``upT(b)[c] = sum_e w[c, e] * b[idx[c, e]]``.
    Fine i reads idx0[i] with weight 1 - w1[i] and idx1[i] with w1[i] (one entry
    of weight 1 where they coincide); zero weights are left out, and unused entries
    are (0, 0.0)."""
    idx0, idx1, w1 = _axis_plan(coarse, fine, mode)
    taps: list[dict] = [dict() for _ in range(coarse)]
    for i in range(fine):
        for c, wt in ((int(idx0[i]), 1.0 - float(w1[i])), (int(idx1[i]), float(w1[i]))):
            if wt != 0.0:
                taps[c][i] = taps[c].get(i, 0.0) + wt
    idx = np.zeros((coarse, MAX_FAN), np.int32)
    wts = np.zeros((coarse, MAX_FAN), np.float32)
    for c, t in enumerate(taps):
        if len(t) > MAX_FAN:
            raise ValueError(f"up-step {coarse} -> {fine}: coarse index {c} is read by "
                             f"{len(t)} fine indices, more than {MAX_FAN}")
        for e, (i, wt) in enumerate(sorted(t.items())):
            idx[c, e], wts[c, e] = i, wt
    return idx, wts


def transposed_plan_table(h: int, w: int, level: int,
                          mode: str = "bilinear") -> tuple[np.ndarray, list[int], list[int]]:
    """The transposed plans of the up-steps l -> l-1 (l = 1..level) in one (n, 2) int32
    table of entries (fine index, weight as fp32 bits), MAX_FAN consecutive entries
    per coarse index, and the entry offsets of each up-step's row plan and column
    plan (index l; 0 at l = 0)."""
    sizes = pyramid_sizes(h, w, level)
    parts, rows, cols, off = [], [0], [0], 0
    for l in range(1, level + 1):
        for axis, offsets in ((0, rows), (1, cols)):
            idx, wts = transposed_axis_plan(sizes[l][axis], sizes[l - 1][axis], mode)
            parts.append(np.stack([idx.reshape(-1), wts.reshape(-1).view(np.int32)], axis=1))
            offsets.append(off)
            off += idx.size
    return np.concatenate(parts, axis=0), rows, cols


@functools.lru_cache(maxsize=None)
def _device_transposed_table(h: int, w: int, level: int, mode: str,
                             device: torch.device) -> torch.Tensor:
    table = transposed_plan_table(h, w, level, mode)[0]
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(table)).to(device)


class LaunchConfig(NamedTuple):
    team: int              # threads that own one (n, c) plane
    planes_per_block: int  # teams in one block of BLOCK_THREADS threads
    smem_bytes: int        # dynamic shared memory of one block
    geometry: tuple        # csrc/recconv_bwd.cu:Geometry, field by field


def team_size(h: int, w: int) -> int:
    """Threads per plane, from the plane's area: 8 up to 8^2 (m1's 7^2), 16 up to 16^2
    (14^2), 64 up to 32^2 (28^2), 128 up to 64^2 (56^2), 256 above; the fastest team
    at each of m1's planes (tools/k1_bwd_phases.py, PERF.md section 6). Planes whose
    block does not fit take larger teams (``_layout``)."""
    hw = h * w
    return next(t for t, most in ((8, 64), (16, 256), (64, 1024), (128, 4096), (256, None))
                if most is None or hw <= most)


def fragments(team: int) -> int:
    """Fragments of a block, each the lanes of one team within one warp: each keeps
    one row of weight-gradient sums in shared memory."""
    return BLOCK_THREADS // min(team, 32)


def _down_t_reach(k: int) -> int:
    """The furthest column of df, past q0 / 2, that a strip of the stride-2 conv's
    adjoint at an even column q0 reads (csrc/recconv_bwd.cu: dt_hi)."""
    return max((s + k // 2 - v) // 2 for s in range(STRIP) for v in range(k)
               if (s + k // 2 - v) % 2 == 0)


def _pitches(sizes: list[tuple[int, int]], k: int) -> list[int]:
    """Row pitch of each level's haloed buffers: odd (the lanes of a warp, on
    consecutive rows, hit distinct banks), and wide enough for the strips that run
    past a row's edge (their outputs are computed and dropped): the stride-1 convs
    and correlations at level l, the stride-2 ones into level l + 1, and the stride-2
    conv's adjoint out of level l into level l - 1."""
    p, level = k // 2, len(sizes) - 1
    pitch = []
    for l, (_, lw) in enumerate(sizes):
        need = _ceil_to(lw, STRIP) + 2 * p
        if l < level:
            need = max(need, 2 * _ceil_to(sizes[l + 1][1], STRIP) + k - 2)
        if l > 0:
            need = max(need, _ceil_to(sizes[l - 1][1], STRIP) // 2 + _down_t_reach(k) + p + 1)
        pitch.append(need | 1)
    return pitch


def _team_layout(h: int, w: int, level: int, k: int) -> tuple:
    """One team's shared memory, in 4-byte words: at level 0 two buffers, F[0] (x, h_0,
    dh_0, df_0) and H[0] (scratch, g, scratch, x again); at each level l > 0 the
    pyramid's F[l] (f_l; at l = level then dh_l, df_l), H[l] for l < level (h_l, then
    dh_l, df_l) and G[l] (scratch, dy_l, scratch). Each has a zero halo of k/2 and a
    row pitch from ``_pitches``. Returns (sizes, pitch, F, H, G, words), G[0] unused."""
    p = k // 2
    sizes = pyramid_sizes(h, w, level)
    pitch = _pitches(sizes, k)
    region = [(lh + 2 * p) * pitch[l] for l, (lh, _) in enumerate(sizes)]
    off = 0
    fb, hb, gb = [], [], [0]
    for bufs, levels in ((fb, range(level + 1)), (hb, range(level)),
                         (gb, range(1, level + 1))):
        for l in levels:
            bufs.append(off)
            off += region[l]
    hb.append(0)  # h_level is F[level]: no buffer of its own
    return sizes, pitch, fb, hb, gb, off


def _layout(h: int, w: int, level: int, k: int) -> LaunchConfig:
    """``launch_config`` without its check that the block fits in shared memory. The
    teams' regions first (spaced by ``_team_stride``), then the channel's weights,
    one row of weight-gradient sums per fragment and copies of the two plan tables."""
    sizes, pitch, fb, hb, gb, words = _team_layout(h, w, level, k)
    taps = (level + 2) * k * k
    ftable, frows, fcols = lerp_plan_table(h, w, level)
    btable, brows, bcols = transposed_plan_table(h, w, level)

    def layout(team):
        per_block = BLOCK_THREADS // team
        stride = _team_stride(words, team)
        wts = stride * per_block
        slots = wts + taps
        return per_block, stride, wts, slots, slots + fragments(team) * taps

    team = team_size(h, w)
    while team < BLOCK_THREADS and layout(team)[-1] * 4 > MAX_DYNAMIC_SMEM:
        team *= 2  # fewer planes per block
    per_block, stride, wts, slots, end = layout(team)
    fplan = _ceil_to(end, 4)  # int4 rows
    bplan = fplan + ftable.size
    end = bplan + btable.size
    pad = [0] * (MAX_LEVEL + 1 - len(sizes))
    lpad = [0] * (MAX_LEVEL + 1 - len(frows))
    geometry = ((level,) + tuple(s[0] for s in sizes) + tuple(pad)
                + tuple(s[1] for s in sizes) + tuple(pad) + tuple(pitch) + tuple(pad)
                + tuple(fb) + tuple(pad) + tuple(hb) + tuple(pad) + tuple(gb) + tuple(pad)
                + tuple(frows) + tuple(lpad) + tuple(fcols) + tuple(lpad)
                + tuple(brows) + tuple(lpad) + tuple(bcols) + tuple(lpad)
                + (stride, wts, slots, fplan, bplan, ftable.size, btable.size))
    return LaunchConfig(team, per_block, end * 4, geometry)


def partial_shape(n: int, c: int, level: int, k: int, planes_per_block: int) -> tuple:
    """The kernel's weight-gradient partials: one (level + 2, k, k) row for each
    channel and group of ``planes_per_block`` consecutive n."""
    return (c, -(-n // planes_per_block), level + 2, k, k)


def _check(level: int, k: int) -> None:
    if not 1 <= level <= MAX_LEVEL:
        raise ValueError(f"recconv_backward_cuda: level {level} not in 1..{MAX_LEVEL}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"recconv_backward_cuda: kernel size {k} not in {KERNEL_SIZES}")


@functools.lru_cache(maxsize=None)
def launch_config(h: int, w: int, level: int, k: int) -> LaunchConfig:
    """Team size, planes per block, shared bytes and geometry of the backward of an
    h x w plane. Raises ValueError where one plane's backward does not fit in shared
    memory (``levels_to_peel_backward`` says how many levels to take off)."""
    _check(level, k)
    cfg = _layout(h, w, level, k)
    if cfg.smem_bytes > MAX_DYNAMIC_SMEM:
        raise ValueError(f"recconv backward: a {h}x{w} plane at level {level} (k={k}) needs "
                         f"{cfg.smem_bytes} bytes of shared memory, more than "
                         f"{MAX_DYNAMIC_SMEM}; peel levels_to_peel_backward({h}, {w}, "
                         f"{level}, {k}) outer levels first")
    return cfg


@functools.lru_cache(maxsize=None)
def levels_to_peel_backward(h: int, w: int, level: int, k: int) -> int:
    """The fewest outer levels of an h x w plane's pyramid whose backward runs
    outside the kernel (``ops/recconv.py:rec_conv2d_peeled_backward``) so that the
    kernel's plane (``pyramid_sizes(h, w, level)[p]`` at level ``level - p``) fits in
    shared memory: 0 where the plane fits as it is, ``level`` where only the coarsest
    conv is left (then no call of the kernel). The counterpart of
    ``ops/cuda/recconv.py:levels_to_peel``; the kernel keeps fp32 planes, so the
    dtype does not enter."""
    _check(level, k)
    for p, (ph, pw) in enumerate(pyramid_sizes(h, w, level)[:level]):
        if _layout(ph, pw, level - p, k).smem_bytes <= MAX_DYNAMIC_SMEM:
            return p
    return level


def recconv_backward_cuda(x: torch.Tensor, down_w: torch.Tensor,
                          conv_ws: Sequence[torch.Tensor], g: torch.Tensor, *, level: int,
                          mode: str = "bilinear"):
    """Launch the backward on x's current stream: (dx in x's dtype, d down_w fp32,
    [d conv_ws[i] fp32]). x, g: contiguous NCHW of one dtype (f32 or bf16); the
    weights (C, 1, k, k) of any float dtype on x's device (read as fp32). Raises on
    anything else."""
    if not (x.is_cuda and g.is_cuda):
        raise ValueError("recconv_backward_cuda: x and g must be CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16) or g.dtype != x.dtype:
        raise ValueError(f"recconv_backward_cuda: x and g must share a dtype of f32 or "
                         f"bf16, got {x.dtype} and {g.dtype}")
    if (x.dim() != 4 or not x.is_contiguous() or g.shape != x.shape
            or not g.is_contiguous() or g.device != x.device):
        raise ValueError("recconv_backward_cuda: x and g must be contiguous NCHW tensors "
                         "of one shape on one device")
    if mode not in MODES:
        raise ValueError(f"recconv_backward_cuda: mode {mode!r} not in {MODES}")
    if len(conv_ws) != level + 1:
        raise ValueError(f"recconv_backward_cuda: expected {level + 1} conv kernels, "
                         f"got {len(conv_ws)}")
    n, c, h, w = x.shape
    k = int(down_w.shape[-1])
    for wt in (down_w, *conv_ws):
        if tuple(wt.shape) != (c, 1, k, k) or wt.device != x.device:
            raise ValueError(f"recconv_backward_cuda: weights must be ({c}, 1, {k}, {k}) on "
                             f"{x.device}, got {tuple(wt.shape)} on {wt.device}")
    cfg = launch_config(h, w, level, k)
    weights = torch.stack([down_w, *conv_ws]).float().contiguous()  # (L+2, C, 1, k, k)
    fplans = _device_plan_table(h, w, level, mode, x.device)
    bplans = _device_transposed_table(h, w, level, mode, x.device)
    dx = torch.empty_like(x)
    partial = torch.empty(partial_shape(n, c, level, k, cfg.planes_per_block),
                          dtype=torch.float32, device=x.device)
    dw = torch.empty(level + 2, c, 1, k, k, dtype=torch.float32, device=x.device)
    geometry = (ctypes.c_int * len(cfg.geometry))(*cfg.geometry)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recconv_backward(x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                   weights.data_ptr(), fplans.data_ptr(), bplans.data_ptr(),
                                   partial.data_ptr(), dw.data_ptr(),
                                   ctypes.cast(geometry, ctypes.c_void_p), len(cfg.geometry),
                                   n, c, k, cfg.team, cfg.smem_bytes,
                                   int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"recconv backward kernel launch failed: "
                           f"{lib.recconv_backward_error_string(err).decode()} ({err})")
    return dx, dw[0], list(dw[1:])
