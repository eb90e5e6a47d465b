"""Binding of a peeled RecConv2d level's kernels (``csrc/recconv_level_bwd.cu``).

One level of ``ops/recconv.py:rec_conv2d_peeled``, for planes whose pyramid (forward)
or whole backward does not fit in the shared memory of ``csrc/recconv.cu`` or
``csrc/recconv_bwd.cu``: ``level_forward_cuda`` (the level's stride-2 down conv, or its
stride-1 conv of x + up(u), z built in the kernel's shared memory; called by
``ops/cuda/recconv.py:recconv_level_cuda``), ``level_dgrad_cuda`` (the conv's input
gradient at stride 1 or 2, plus an optional fine-grid gradient), ``level_wgrad_cuda``
(its weight gradient) and ``up_adjoint_cuda`` (the up-step's adjoint). The source is
its own library (``ops/cuda/build.py``), built with ``nvcc`` for ``sm_90a`` at first
use; nothing is built or loaded at import.

The host lays every kernel out in plain Python that the CPU tests reach:
``launch_config`` cuts each plane into bands of rows and column tiles of ``TILE``
outputs, one warp walking each (band, tile) down a ring of shared-memory rows fed by
``cp.async``; it picks the band height from the grid's fill (the blocks an SM holds,
from the kernel's registers and shared memory), the ring depth, the copy chunks from
the rows' alignment, and the shared layout, which the kernel reads as ``Geometry``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary
from recnext_tpu_torch.ops.cuda.recconv import (
    KERNEL_SIZES,
    MAX_SMEM_BYTES,
    MODES,
    _axis_plan,
    _device_plan_table,
    pyramid_sizes,
)
from recnext_tpu_torch.ops.cuda.recconv_bwd import (
    MAX_FAN,
    _device_transposed_table,
    transposed_axis_plan,
)

SOURCE = PKG / "csrc" / "recconv_level_bwd.cu"
KINDS = {"dgrad": 0, "wgrad": 1, "up_adjoint": 2, "level": 3}
STRIP = 4            # outputs a lane computes along a row (csrc: kStrip)
TILE = 32 * STRIP    # output columns one warp walks (csrc: kTile)
PAD = 8              # halo elements on each side of a ring row (csrc: kPad)
ROW1 = TILE + 2 * PAD       # a stride-1 row of g, x or z (csrc: kRow1)
ROWC = TILE // 2 + 2 * PAD  # a coarse row: dd of the stride-2 dgrad, u (csrc: kRowC)
ROW2 = 2 * TILE + 2 * PAD   # a fine row at stride 2 (x), or the adjoint's dz (csrc: kRow2)
MAX_WARPS = 8        # warps a block (csrc: kMaxThreads / 32)
STAGES = (2, 4)      # ring rows of a stream (a power of two): 1 or 3 in flight
MAX_STAGES = 4
MIN_BAND = 4         # output rows a warp walks at least (the halo is k - 1 rows a band)
SMS = 132            # an H100 SXM's SMs
SM_SMEM = 233472     # shared memory of one SM (228 KB)
BLOCK_SMEM_RESERVED = 1024
SM_REGISTERS = 65536
SM_THREADS = 2048
SM_BLOCKS = 32
# registers a thread, where the caller gives none (the CPU tests): about what nvcc
# gives the k = 5 kernels
DEFAULT_REGISTERS = {"dgrad": 72, "wgrad": 96, "level": 80, "up_adjoint": 80}


class Geometry(NamedTuple):
    """``csrc/recconv_level_bwd.cu:Geometry``, field by field (offsets in words)."""
    rows: int              # walk units of a plane
    row0: int              # the first unit
    band: int              # units one warp walks
    per_block: int         # bands a block
    tiles: int             # column tiles across the plane
    tiles_pb: int          # column tiles a block
    tile_groups: int       # blocks across one band group's tiles
    blocks_per_plane: int  # band groups x tile groups
    stages: int            # ring rows of each input stream: 2 or 4
    uring: int             # ring rows of u's coarse rows, a power of two
    gring: int             # ring rows of g (wgrad, stride 1), a power of two
    warp_words: int        # from one warp's rings to the next
    a_off: int             # first stream's ring (g: dgrad; x: wgrad)
    b_off: int             # g's ring (wgrad)
    u_off: int             # u's ring (wgrad, stride 1, with u)
    z_off: int             # two rows of z (the same)
    plan_off: int          # block-wide, after the warps: the lerp plans, an int2 a row and
                           # a column (the same)
    sums_off: int          # block-wide: each warp's k*k sums (wgrad)
    chunk_a: int           # bytes a copy moves: 16, 8, 4 (cp.async) or 0 (plain loads)
    chunk_b: int
    chunk_u: int
    vec: int               # dgrad: 4-wide stores of dx (and loads of add)


class LaunchConfig(NamedTuple):
    threads: int           # 32 x column tiles x bands a block
    blocks_per_plane: int
    smem_bytes: int        # dynamic shared memory of one block
    resident_blocks: int   # blocks an SM holds: registers, shared memory, threads
    geometry: Geometry


def _declare(lib: ctypes.CDLL) -> None:
    lib.recconv_level_dgrad.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    lib.recconv_level_dgrad.restype = ctypes.c_int
    lib.recconv_level_wgrad.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    lib.recconv_level_wgrad.restype = ctypes.c_int
    lib.recconv_level_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                          + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p])
    lib.recconv_level_forward.restype = ctypes.c_int
    lib.recconv_up_adjoint.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p])
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
        raise RuntimeError(f"recconv level {what} failed: "
                           f"{lib.recconv_level_bwd_error_string(err).decode()} ({err})")


def _flags(dtypes) -> tuple[int, int]:
    return tuple(int(d == torch.bfloat16) for d in dtypes)


def kernel_attributes(kind: str, k: int = 5, stride: int = 1,
                      dtypes: tuple = (torch.float32, torch.float32)) -> dict:
    """Registers and local bytes per thread of kernel ``kind`` (dgrad: the dtypes of g
    and of the output; wgrad: of x and of g; level: of x and of y; up_adjoint: fp32
    only)."""
    lib = load_library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    a, b = _flags(dtypes)
    _raise(lib, lib.recconv_level_bwd_attributes(KINDS[kind], k, stride, a, b,
                                                 ctypes.byref(regs), ctypes.byref(local)),
           f"{kind} attributes")
    return {"registers": regs.value, "local_bytes": local.value}


@functools.lru_cache(maxsize=None)
def registers(kind: str, k: int, stride: int, dtypes: tuple) -> int:
    """``kernel_attributes(...)["registers"]``, once a process (the planner's input)."""
    return kernel_attributes(kind, k, stride, dtypes)["registers"]


# ---- the planner ------------------------------------------------------------------------

def walk(kind: str, h: int, w: int, k: int, stride: int) -> tuple[int, int, int, int]:
    """(rows, row0, halo, cols) of a plane's walk: the units a warp walks (output rows;
    the stride-2 input gradient's pairs of output rows 2m - k/2, 2m - k/2 + 1 for m
    from row0; the adjoint's coarse rows), the steps a band takes beyond its units (the
    adjoint's: about one coarse row's fine rows more than two a coarse row), and the
    output columns."""
    p = k // 2
    if kind == "dgrad":
        if stride == 1:
            return h, 0, 2 * p, w
        m0, m1 = p // 2, (h - 1 + p) // 2
        return m1 - m0 + 1, m0, p, w
    if kind == "up_adjoint":
        uh, uw = pyramid_sizes(h, w, 1)[1]
        return uh, 0, 1, uw
    oh, ow = (h, w) if stride == 1 else pyramid_sizes(h, w, 1)[1]  # wgrad: g's; level: y's
    return oh, 0, 2 * p if stride == 1 else p, ow


def chunk_bytes(width: int, elem_bytes: int, align: int = 16) -> int:
    """Bytes one copy of a row stream moves: the largest of 16, 8 and 4 that divides
    the row's bytes and the base pointer's alignment (so no chunk straddles a row's
    end), or 0 (plain loads: a bf16 row of odd width)."""
    return next((c for c in (16, 8, 4) if (width * elem_bytes) % c == 0 and align % c == 0),
                0)


def u_ring_rows(h: int, stages: int, mode: str) -> int:
    """Ring rows of u's coarse rows that the stride-1 weight gradient needs, a power of
    two: while the z row r is built, the coarse rows from the least that row r reads
    to the most that row r + stages - 2 reads (copied just before) are in the ring."""
    idx0, idx1, _ = _axis_plan((h + 1) // 2, h, mode)
    lo, hi = np.minimum(idx0, idx1), np.maximum(idx0, idx1)
    ahead = np.minimum(np.arange(h) + stages - 2, h - 1)
    return 1 << (int((hi[ahead] - lo + 1).max()) - 1).bit_length()


def _u_columns_fit(h: int, w: int, mode: str, k: int) -> bool:
    """Whether each tile's z columns [c0 - k/2, c0 + TILE + k/2) read only the coarse
    columns its ring rows hold, [c0/2 - PAD, c0/2 - PAD + ROWC)."""
    idx0, idx1, _ = _axis_plan((w + 1) // 2, w, mode)
    p = k // 2
    for c0 in range(0, w, TILE):
        cols = np.arange(max(c0 - p, 0), min(c0 + TILE + p, w))
        lo, hi = c0 // 2 - PAD, c0 // 2 - PAD + ROWC
        if min(idx0[cols].min(), idx1[cols].min()) < lo or max(idx0[cols].max(),
                                                                idx1[cols].max()) >= hi:
            return False
    return True


def _fine_reads(h: int, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) per coarse index of the up-step ceil(h/2) -> h: the least and the most
    fine index that reads it with a weight (its transposed plan's entries)."""
    idx, wts = transposed_axis_plan((h + 1) // 2, h, mode)
    return idx[:, 0], np.where(wts != 0, idx, -1).max(axis=1)


def fine_ring_rows(h: int, stages: int, mode: str) -> int:
    """Ring rows of dz's fine rows that the adjoint needs, a power of two: before its
    first step a band copies the fine rows from the least that its first coarse row a
    reads to the most that row a + stages - 2 reads, none summed yet; after step t the
    ring holds the rows not yet summed, those past the most that row u0 + t reads, up
    to the most that row u0 + t + stages - 1 reads, which the first bound covers."""
    lo, hi = _fine_reads(h, mode)
    uh = len(lo)
    ahead = np.minimum(np.arange(uh) + stages - 2, uh - 1)
    return 1 << (int((hi[ahead] - lo + 1).max()) - 1).bit_length()


def _adjoint_columns_fit(w: int, mode: str) -> bool:
    """Whether each tile's coarse columns [b0, b0 + TILE) read (with a weight) only the
    fine columns its ring rows hold, [2 b0 - PAD, 2 b0 - PAD + ROW2)."""
    idx, wts = transposed_axis_plan((w + 1) // 2, w, mode)
    for b0 in range(0, len(idx), TILE):
        used = idx[b0:b0 + TILE][wts[b0:b0 + TILE] != 0]
        if used.min() < 2 * b0 - PAD or used.max() >= 2 * b0 - PAD + ROW2:
            return False
    return True


def _words(elems: int, elem_bytes: int) -> int:
    """4-byte words of `elems` elements, rounded up to 16 bytes."""
    return -(-elems * elem_bytes // 16) * 4


def g_ring_rows(k: int, stages: int) -> int:
    """Ring rows of g that the stride-1 weight gradient reads its k taps' rows from, a
    power of two: the row copied stages - 1 steps ahead must not overwrite one of the
    k rows still to be read, k + stages - 2 in all."""
    return 1 << (k + stages - 3).bit_length()


def _warp_layout(kind: str, stride: int, stages: int, uring: int, gring: int, a_bytes: int,
                 b_bytes: int, up: bool) -> tuple[int, int, int, int, int]:
    """(words, a_off, b_off, u_off, z_off) of one warp's rings."""
    if kind == "dgrad":
        return _words(stages * (ROW1 if stride == 1 else ROWC), a_bytes), 0, 0, 0, 0
    if kind == "up_adjoint":  # dz's ring, then MAX_FAN rows of fine rows' column sums
        return gring * ROW2 + MAX_FAN * TILE, 0, gring * ROW2, 0, 0
    a = _words(stages * (ROW1 if stride == 1 else 2 * ROW2), a_bytes)
    b = _words((gring if stride == 1 else stages) * TILE, b_bytes) if kind == "wgrad" else 0
    u = uring * ROWC if up else 0
    z = 2 * ROW1 if up else 0
    return a + b + u + z, 0, a if b else 0, a + b, a + b + u


def _resident(threads: int, smem: int, regs: int) -> int:
    """Blocks an SM holds, by its registers (allocated 256 a warp at a time), shared
    memory (1 KB reserved a block) and threads."""
    warp_regs = -(-regs * 32 // 256) * 256
    by_regs = (SM_REGISTERS // warp_regs) // (threads // 32)
    by_smem = SM_SMEM // (smem + BLOCK_SMEM_RESERVED)
    return min(by_regs, by_smem, SM_THREADS // threads, SM_BLOCKS)


@functools.lru_cache(maxsize=None)
def launch_config(kind: str, h: int, w: int, k: int, stride: int, planes: int, *,
                  a_bytes: int = 4, b_bytes: int = 4, up: bool = False,
                  mode: str = "bilinear", regs: int | None = None, align: int = 16,
                  band: int | None = None,
                  stages: int | None = None) -> LaunchConfig:
    """The layout of ``kind`` ("dgrad", "wgrad", "level" or "up_adjoint") at stride 1
    or 2 on ``planes`` planes of h x w (dgrad: the input gradient's plane; wgrad and
    level: x's; up_adjoint: dz's fine plane, stride 1, k unused), k x k.

    a_bytes / b_bytes: the element bytes of g and dx (dgrad), x and g (wgrad) or x and
    y (level); up: the stride-1 weight gradient or level builds z = x + up(u) with
    ``mode``'s plans (the adjoint reads ``mode``'s transposed plans); regs: the
    kernel's registers a thread; align: the least alignment of the tensors' pointers,
    bytes. ``band`` (units a warp walks) and ``stages`` (ring rows a stream) override
    the planner's choice (the phase tools sweep them).

    The band (at least MIN_BAND output rows): the one whose steps (its units and the
    halo's) times the waves of warps it takes, by the warps the card holds by the
    registers, are fewest; the longer band where two tie. Long bands read the halo's
    rows less often; short ones fill the card (a small grid: the shortest). A block
    takes the column tiles of a few bands: the most warps an SM holds, less the warps
    of the last block that have no band, then the larger block (planes wider than
    MAX_WARPS tiles: several blocks across). The ring: the most rows of STAGES that do
    not lower the blocks an SM holds below what the registers allow."""
    adjoint = kind == "up_adjoint"
    if (kind not in KINDS or stride not in (1, 2) or (adjoint and stride != 1)
            or (not adjoint and k not in KERNEL_SIZES)):
        raise ValueError(f"recconv level: {kind} stride {stride} k {k} not supported")
    if up and (kind not in ("wgrad", "level") or stride != 1):
        raise ValueError("recconv level: z = x + up(u) only in the stride-1 weight gradient "
                         "and level")
    rows, row0, halo, cols = walk(kind, h, w, k, stride)
    if rows < 1 or cols < 1 or planes < 1:
        raise ValueError(f"recconv level: empty plane {h}x{w} or no planes")
    regs = regs or DEFAULT_REGISTERS[kind]
    # building z a row ahead needs that row landed too: 4 ring rows
    stage_options = (MAX_STAGES,) if up else STAGES
    tiles = -(-cols // TILE)
    tile_groups = -(-tiles // MAX_WARPS)
    tiles_pb = -(-tiles // tile_groups)
    unit_rows = 2 if (kind, stride) == ("dgrad", 2) else 1  # output rows a unit
    by_regs = min(SM_REGISTERS // (-(-regs * 32 // 256) * 256), SM_THREADS // 32)
    if band is None:
        least = max(1, -(-MIN_BAND // unit_rows))

        def cost(b):  # steps a warp walks times the waves of warps
            return (b + halo) * -(-planes * tiles * -(-rows // b) // (SMS * by_regs))

        band = min(range(min(rows, least), rows + 1), key=lambda b: (cost(b), -b))
    band = max(1, min(band, rows))
    bands = -(-rows // band)

    uh, uw = (h + 1) // 2, (w + 1) // 2
    if up and max(uh, uw) >= 1 << 16:
        raise ValueError(f"recconv level: the up-step's {uh}x{uw} does not fit the "
                         "kernel's 16-bit plans")
    if up and not _u_columns_fit(h, w, mode, k):
        raise ValueError(f"recconv level: the {mode} plans of {h}x{w} read coarse "
                         "columns outside a tile's ring rows")
    if adjoint and not _adjoint_columns_fit(w, mode):
        raise ValueError(f"recconv level: the {mode} transposed plans of {h}x{w} read "
                         "fine columns outside a tile's ring rows")
    kk_pad = 32 if k * k <= 32 else 64
    plan_words = (-(-2 * (h + w) // 4) * 4 if up else
                  -(-2 * MAX_FAN * (uh + uw) // 4) * 4 if adjoint else 0)

    def layout(ns, warps):
        uring = u_ring_rows(h, ns, mode) if up else 0
        gring = (g_ring_rows(k, ns) if (kind, stride) == ("wgrad", 1) else
                 fine_ring_rows(h, ns, mode) if adjoint else 0)
        words, a_off, b_off, u_off, z_off = _warp_layout(kind, stride, ns, uring, gring,
                                                         a_bytes, b_bytes, up)
        plan_off = warps * words
        sums_off = plan_off + plan_words
        end = sums_off + (warps * kk_pad if kind == "wgrad" else 0)
        return uring, gring, words, a_off, b_off, u_off, z_off, plan_off, sums_off, end * 4

    def fill(b):  # warps an SM holds with blocks of b bands, times the share with a band
        warps = b * tiles_pb
        smem = min(layout(ns, warps)[-1] for ns in stage_options)
        return (_resident(32 * warps, smem, regs) * warps * bands / (-(-bands // b) * b)
                if smem <= MAX_SMEM_BYTES else 0)

    per_block = max(range(1, max(1, min(MAX_WARPS // tiles_pb, bands)) + 1),
                    key=lambda b: (fill(b), b))
    band_groups = -(-bands // per_block)
    threads = 32 * tiles_pb * per_block
    warps = threads // 32
    fits = [ns for ns in stage_options if layout(ns, warps)[-1] <= MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(f"recconv level: a block of {kind} at {h}x{w} needs "
                         f"{layout(min(stage_options), warps)[-1]} bytes of shared memory, "
                         f"more than {MAX_SMEM_BYTES}")
    if stages is None:
        best = max(_resident(threads, layout(ns, warps)[-1], regs) for ns in fits)
        stages = max(ns for ns in fits
                     if _resident(threads, layout(ns, warps)[-1], regs) == best)
    elif stages not in fits:
        raise ValueError(f"recconv level: {stages} ring rows do not fit (z = x + up(u) is "
                         "built a row ahead: 4)")
    (uring, gring, words, a_off, b_off, u_off, z_off, plan_off, sums_off,
     smem) = layout(stages, warps)

    if kind == "dgrad":
        in_w = w if stride == 1 else (w + 1) // 2
        chunks = (chunk_bytes(in_w, a_bytes, align), 0, 0)
    elif kind == "wgrad":
        chunks = (chunk_bytes(w, a_bytes, align), chunk_bytes(cols, b_bytes, align),
                  chunk_bytes(uw, 4, align) if up else 0)
    elif kind == "level":
        chunks = (chunk_bytes(w, a_bytes, align), 0, chunk_bytes(uw, 4, align) if up else 0)
    else:
        chunks = (chunk_bytes(w, 4, align), 0, 0)
    # dx (dgrad) and y (level) rows take 4-wide stores at every 4th column
    vec = int(kind in ("dgrad", "level") and cols % 4 == 0 and align % 16 == 0)
    geometry = Geometry(rows, row0, band, per_block, tiles, tiles_pb, tile_groups,
                        band_groups * tile_groups, stages, uring, gring, words, a_off, b_off,
                        u_off,
                        z_off, plan_off, sums_off, *chunks, vec)
    return LaunchConfig(threads, geometry.blocks_per_plane, smem,
                        _resident(threads, smem, regs), geometry)


def warp_places(geo: Geometry, threads: int):
    """(band group and tile group index bp, warp, tile, first unit, end unit) of every
    warp of one plane's blocks, as ``csrc/recconv_level_bwd.cu:place_of`` finds them."""
    for bp in range(geo.blocks_per_plane):
        for warp in range(threads // 32):
            tile = (bp % geo.tile_groups) * geo.tiles_pb + warp % geo.tiles_pb
            band = (bp // geo.tile_groups) * geo.per_block + warp // geo.tiles_pb
            u0 = geo.row0 + band * geo.band
            yield bp, warp, tile, u0, min(u0 + geo.band, geo.row0 + geo.rows)


def partial_shape(n: int, c: int, k: int, cfg: LaunchConfig) -> tuple[int, int, int]:
    """The weight gradient's partial sums: one k*k row per (channel; n, block of the
    plane), added by ``recconv_level_wgrad_sum_kernel`` in a fixed tree."""
    return (c, n * cfg.blocks_per_plane, k * k)


# ---- the entries -----------------------------------------------------------------------

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


def _align(*tensors) -> int:
    """The largest of 16, 8, 4, 2, 1 that divides every pointer."""
    return math.gcd(16, *(t.data_ptr() for t in tensors if t is not None))


def _geometry(cfg: LaunchConfig):
    return (ctypes.c_int * len(cfg.geometry))(*cfg.geometry)


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
    dtypes = (g.dtype, out_dtype)
    cfg = launch_config("dgrad", h, wd, k, stride, n * c, a_bytes=g.element_size(),
                        b_bytes=y.element_size(), regs=registers("dgrad", k, stride, dtypes),
                        align=_align(g, y, add))
    lib = load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.recconv_level_dgrad(g.data_ptr(), w.data_ptr(),
                                      None if add is None else add.data_ptr(), y.data_ptr(),
                                      n * c, c, h, wd, k, stride, *_flags(dtypes),
                                      ctypes.cast(_geometry(cfg), ctypes.c_void_p),
                                      len(cfg.geometry), cfg.smem_bytes, stream)
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
    dtypes = (x.dtype, g.dtype)
    cfg = launch_config("wgrad", h, wd, k, stride, n * c, a_bytes=x.element_size(),
                        b_bytes=g.element_size(), up=up is not None, mode=mode,
                        regs=registers("wgrad", k, stride, dtypes), align=_align(x, g, up))
    partial = torch.empty(partial_shape(n, c, k, cfg), dtype=torch.float32, device=x.device)
    dw = torch.empty(c, 1, k, k, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recconv_level_wgrad(x.data_ptr(), None if up is None else up.data_ptr(),
                                      None if plans is None else plans.data_ptr(),
                                      g.data_ptr(), partial.data_ptr(), dw.data_ptr(), n, c, h,
                                      wd, k, stride, *_flags(dtypes),
                                      ctypes.cast(_geometry(cfg), ctypes.c_void_p),
                                      len(cfg.geometry), cfg.smem_bytes, stream)
    _raise(lib, err, "wgrad launch")
    return dw


def level_forward_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                       up: torch.Tensor | None = None,
                       mode: str = "bilinear") -> torch.Tensor:
    """``conv(x + resize(up, size(x)), w)`` at ``stride`` with zero padding k/2 in fp32
    (``recconv_level_kernel``), on x's current stream: f32 out at stride 2, x's dtype at
    stride 1. The caller (``ops/cuda/recconv.py:recconv_level_cuda``) has checked x
    (contiguous NCHW f32/bf16 on the card), w (contiguous (C, 1, k, k) f32) and up (None,
    or at stride 1 contiguous f32 (N, C, ceil(H/2), ceil(W/2)))."""
    n, c, h, wd = x.shape
    k = int(w.shape[-1])
    out_dtype = torch.float32 if stride == 2 else x.dtype
    oh, ow = (h, wd) if stride == 1 else pyramid_sizes(h, wd, 1)[1]
    y = torch.empty(n, c, oh, ow, dtype=out_dtype, device=x.device)
    plans = None if up is None else _device_plan_table(h, wd, 1, mode, x.device)
    dtypes = (x.dtype, out_dtype)
    cfg = launch_config("level", h, wd, k, stride, n * c, a_bytes=x.element_size(),
                        b_bytes=y.element_size(), up=up is not None, mode=mode,
                        regs=registers("level", k, stride, dtypes), align=_align(x, y, up))
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recconv_level_forward(x.data_ptr(), w.data_ptr(),
                                        None if up is None else up.data_ptr(),
                                        None if plans is None else plans.data_ptr(),
                                        y.data_ptr(), n * c, c, h, wd, k, stride,
                                        *_flags(dtypes),
                                        ctypes.cast(_geometry(cfg), ctypes.c_void_p),
                                        len(cfg.geometry), cfg.smem_bytes, stream)
    _raise(lib, err, "forward launch")
    return y


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
    fp32 = (torch.float32, torch.float32)
    cfg = launch_config("up_adjoint", h, wd, 0, 1, n * c, mode=mode,
                        regs=registers("up_adjoint", 5, 1, fp32), align=_align(dz))
    lib = load_library()
    with torch.cuda.device(dz.device):
        stream = torch.cuda.current_stream(dz.device).cuda_stream
        err = lib.recconv_up_adjoint(dz.data_ptr(), plans.data_ptr(), du.data_ptr(), n * c, h,
                                     wd, ctypes.cast(_geometry(cfg), ctypes.c_void_p),
                                     len(cfg.geometry), cfg.smem_bytes, stream)
    _raise(lib, err, "up adjoint launch")
    return du
