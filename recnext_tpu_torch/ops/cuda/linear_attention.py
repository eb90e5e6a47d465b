"""Binding of the linear-attention CUDA kernel (``csrc/linear_attention.cu``).

The counterpart of ``recnext_tpu/ops/pallas/linear_attention.py:pallas_linear_attention``.
The source is built with ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (``ops/cuda/build.py``). Nothing is built or loaded at import.

The host side lays the kernel out, once per shape: ``launch_config`` picks the team
size (threads per (batch, head)), the heads per block, the tile of positions that
one staging buffer holds, and each team's shared-memory layout, which the kernel
reads as its ``Geometry`` struct. It is plain Python, so the CPU tests reach it.
Each head's q, k, v and out must each be one contiguous span of memory, in one of
two orders: n-fastest (``"n"``: D rows of N positions, the model's NCHW planes) or
d-fastest (``"d"``: N rows of D values, the JAX package's (BH, N, D) layout).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary

SOURCE = PKG / "csrc" / "linear_attention.cu"
MAX_DIM = 128  # the largest D and DV the kernel takes
# the most dynamic shared memory one block may use on an H100 (227 KB), and the share
# a block aims at, so that four blocks stay resident on an SM
MAX_SMEM_BYTES = 232448
BLOCK_SMEM_BYTES = MAX_SMEM_BYTES // 4
BLOCK_THREADS = 128  # threads of a block of teams of at most a warp
TEAM_SIZES = (16, 32, 64, 128, 256)
LAYOUTS = ("n", "d")
KV_BLOCK = 8  # kv rows and columns of one pass-1 item (csrc: kBD, kBE)
OUT_ROWS = 2  # positions of one pass-2 item (csrc: kBN)


def _declare(lib: ctypes.CDLL) -> None:
    lib.linear_attention_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 2
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.linear_attention_forward.restype = ctypes.c_int
    lib.linear_attention_kernel_attributes.argtypes = [ctypes.c_int,
                                                       ctypes.POINTER(ctypes.c_int),
                                                       ctypes.POINTER(ctypes.c_int)]
    lib.linear_attention_kernel_attributes.restype = ctypes.c_int
    lib.linear_attention_error_string.argtypes = [ctypes.c_int]
    lib.linear_attention_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("linear_attention", SOURCE, _declare)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    return LIBRARY.load()


def kernel_attributes(dtype: torch.dtype) -> dict:
    """Registers per thread and local (spill and stack) bytes per thread of the
    kernel built for ``dtype``, as the CUDA runtime reports them."""
    lib = load_library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.linear_attention_kernel_attributes(int(dtype == torch.bfloat16),
                                                 ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"linear attention kernel attributes: "
                           f"{lib.linear_attention_error_string(err).decode()} ({err})")
    return {"registers": regs.value, "local_bytes": local.value}


def _ceil_to(a: int, m: int) -> int:
    return -(-a // m) * m


class LaunchConfig(NamedTuple):
    team: int             # threads that own one (batch, head)
    heads_per_block: int  # teams in one block
    tile: int             # positions of one staging buffer (the last tile may be shorter)
    tiles: int            # tiles per head
    smem_bytes: int       # dynamic shared memory of one block
    geometry: tuple       # csrc/linear_attention.cu:Geometry, field by field


def team_size(n: int, d: int, dv: int) -> int:
    """Threads per head: from the number of positions, 16 up to 16 positions, 32 up
    to 64, 128 up to 1024, else 256 (measured at recnext_a1's shapes, D = DV = 24:
    PERF.md, section 6); and at least one lane per 8x8 block of pass 1's kv, up to
    128, so that no lane sums two blocks one after the other (the L family's D 64,
    DV 128 heads: 128 blocks, 3.0x faster than a team of 16; PERF.md, section 6)."""
    by_n = next(t for t, most in ((16, 16), (32, 64), (128, 1024), (256, None))
                if most is None or n <= most)
    blocks = -(-d // KV_BLOCK) * -(-dv // KV_BLOCK)
    by_work = next(t for t in TEAM_SIZES if t >= min(blocks, 128))
    return max(by_n, by_work)


def _span_bytes(elems: int, elem_bytes: int) -> int:
    """Bytes of the 16-byte chunks that hold a span of ``elems`` at any alignment."""
    return _ceil_to(15 + elems * elem_bytes, 16)


def _piece_pitch(n: int, tile: int, elem_bytes: int) -> int:
    """Bytes from one row piece of an n-fastest tile to the next: room for a piece's
    chunks at any alignment, and congruent to a row's bytes (N * elem_bytes) modulo
    16, so every row lands at the same offset within its chunk."""
    p = tile * elem_bytes + 30
    return p + (n * elem_bytes - p) % 16


def _team_layout(n, d, dv, elem_bytes, layout, tile):
    """(pitch, v_off, buf0, buf1, kv, ks, kv_pitch, team_bytes) of one team in bytes,
    with tiles of ``tile`` positions; pitch 0 where a tile is one span."""
    tiles = -(-n // tile)
    pitch = _piece_pitch(n, tile, elem_bytes) if layout == "n" and tiles > 1 else 0

    def footprint(rows):  # one operand's tile in a staging buffer
        if pitch:
            return rows * pitch
        return _span_bytes(rows * (n if layout == "n" else tile), elem_bytes)

    # pass 1 reads whole 8-row blocks of k and of v (rows past D or DV are read and
    # dropped), so their tiles take whole blocks of rows
    v_off = _ceil_to(footprint(_ceil_to(d, KV_BLOCK)), 16)
    kv_tile = v_off + _ceil_to(footprint(_ceil_to(dv, KV_BLOCK)), 16)
    q_tile = _ceil_to(footprint(d), 16)
    buf0 = 0
    buf1 = kv_tile  # pass 1 fills buffer 0; buffer 1 takes q, and k and v tiles too
    kv = buf1 + (q_tile if tiles == 1 else kv_tile)
    kv_pitch = _ceil_to(dv, KV_BLOCK)
    ks = kv + 4 * d * kv_pitch
    team_bytes = _ceil_to(ks + 4 * d, 16)
    return pitch, v_off, buf0, buf1, kv, ks, kv_pitch, team_bytes


def _tile_lengths(n):
    """Tile lengths to try, longest first: all of N, then N split evenly into 2, 3, ...
    tiles of a multiple of 8 positions, down to 8."""
    yield n
    last, tiles = n, 2
    while last > 8:
        tile = _ceil_to(-(-n // tiles), 8)
        if tile < last:
            yield tile
            last = tile
        tiles += 1


@functools.lru_cache(maxsize=None)
def launch_config(n: int, d: int, dv: int, elem_bytes: int, layout: str) -> LaunchConfig:
    """Team size, heads per block, tile, shared bytes and geometry for heads of N
    positions with D-wide q and k and DV-wide v and out, ``elem_bytes`` per element,
    in ``layout`` ("n" or "d"). The longest tile that keeps a block within its share
    of shared memory (a quarter of the SM's; all of it where no tile fits a quarter),
    with fewer heads per block before shorter tiles. Raises ValueError where the
    kernel cannot run."""
    if not (1 <= d <= MAX_DIM and 1 <= dv <= MAX_DIM) or n < 1:
        raise ValueError(f"linear_attention_cuda: D={d}, DV={dv} and N={n}: the kernel "
                         f"takes 1 <= D, DV <= {MAX_DIM} and N >= 1")
    if layout not in LAYOUTS:
        raise ValueError(f"linear_attention_cuda: layout {layout!r} not in {LAYOUTS}")
    team = team_size(n, d, dv)
    # pass 1's kv blocks and the lanes that share one (a power of two of at most a
    # warp, so that shuffles sum their blocks); the lanes left over sum k's rows
    blocks = -(-d // KV_BLOCK) * -(-dv // KV_BLOCK)
    splits = 1
    while splits < 32 and 2 * splits * blocks <= team:
        splits *= 2
    ks_parts = max(1, (team - splits * blocks) // d)
    most = BLOCK_THREADS // team if team <= 32 else 1  # a larger team is the block

    def rounds_filled(tile):  # the share of pass 2's lanes that a tile keeps busy
        items = -(-dv // KV_BLOCK) * -(-tile // OUT_ROWS)
        return items / (-(-items // team) * team)

    for budget in (BLOCK_SMEM_BYTES, MAX_SMEM_BYTES):
        fits = []
        for tile in _tile_lengths(n):
            lay = _team_layout(n, d, dv, elem_bytes, layout, tile)
            heads = most
            while heads > 1 and heads * lay[-1] > budget:
                heads //= 2
            if heads * lay[-1] <= budget:
                fits.append((tile, heads, lay))
            if fits and (tile == n or 2 * tile <= fits[0][0]):
                break
        if fits:
            # a head that fits is one tile; else, of the tiles down to half the longest
            # that fits, the one whose pass 2 fills its rounds best (measured: PERF.md)
            tile, heads, lay = max(fits, key=lambda f: (rounds_filled(f[0]), f[0]))
            pitch, v_off, buf0, buf1, kv, ks, kv_pitch, team_bytes = lay
            tiles = -(-n // tile)
            geometry = (n, d, dv, int(layout == "n"), team, heads, tile, tiles, pitch,
                        v_off, buf0, buf1, kv, ks, kv_pitch, team_bytes, splits, ks_parts)
            return LaunchConfig(team, heads, tile, tiles, heads * team_bytes, geometry)
    raise ValueError(f"linear_attention_cuda: N={n}, D={d}, DV={dv} does not fit in "
                     f"{MAX_SMEM_BYTES} bytes of shared memory")


def _layout_of(specs: tuple) -> str:
    ok = set(LAYOUTS)
    for (_, _, n, r), (_, _, sn, sr) in specs:
        if not ((n == 1 or sn == 1) and (r == 1 or sr == n)):
            ok.discard("n")
        if not ((r == 1 or sr == 1) and (n == 1 or sn == r)):
            ok.discard("d")
    if not ok:
        raise ValueError("linear_attention_cuda: each head of q, k, v and out must be one "
                         "contiguous span, n-fastest (NCHW planes) or d-fastest "
                         "((BH, N, D) rows), all in the same order")
    return "n" if "n" in ok else "d"


def head_layout(*ts: torch.Tensor) -> str:
    """The order in which each (batch, head) of every (B, H, N, R) view is one
    contiguous span: "n" (n-fastest) or "d" (d-fastest), "n" where both hold.
    Raises ValueError ("contiguous") where neither holds for all."""
    return _layout_of(tuple((tuple(t.shape), t.stride()) for t in ts))


@functools.lru_cache(maxsize=1024)
def _launch_args(specs: tuple, elem_bytes: int):
    """The launch configuration and the C entry's stride and geometry arrays for
    operands of these (shape, stride) pairs: built once, as the host's time per
    launch bounds small shapes."""
    (_, _, n, d), _ = specs[0]
    cfg = launch_config(n, d, specs[2][0][3], elem_bytes, _layout_of(specs))
    strides = (ctypes.c_longlong * 8)(*(x for _, st in specs for x in st[:2]))
    geometry = (ctypes.c_int * len(cfg.geometry))(*cfg.geometry)
    return cfg, strides, geometry


def linear_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on q's current stream, writing ``out``. Every operand is a
    (B, H, N, D) view whose heads are each one contiguous span (``head_layout``): q
    and k (B, H, N, D), v and out (B, H, N, DV), all f32 or all bf16, on one CUDA
    device. Raises on anything else."""
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
    cfg, strides, geometry = _launch_args(tuple((tuple(t.shape), t.stride()) for t in ts),
                                          q.element_size())
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.linear_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b * h, h,
            geometry, len(cfg.geometry), cfg.smem_bytes, eps, int(q.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"linear attention kernel launch failed: "
                           f"{lib.linear_attention_error_string(err).decode()} ({err})")
    return out
