"""Binding of the linear-attention backward kernel (``csrc/linear_attention_bwd.cu``).

The gradient of ``recnext_tpu/ops/attention.py:linear_attention_kv_first``, which has
no Pallas backward in the JAX package: given q, k, v and g = dL/dout, the kernel
returns dq, dk and dv. The source is its own library (``ops/cuda/build.py``), built
with ``nvcc`` for ``sm_90a`` at first use; nothing is built or loaded at import.

The host side lays the kernel out, once per shape, in plain Python that the CPU
tests reach. ``launch_config`` picks a route before any launch (each is one launch):

* ``"packed"``: a team of 32-256 threads holds a whole head in shared memory for
  all three passes, and a 256-thread block packs 256 / team heads;
* ``"cluster"``: a head is split over the 2-8 blocks of a thread-block cluster,
  each holding a slice of its positions; the blocks add each other's partial sums
  through distributed shared memory in rank order;
* ``"tiled"``: one block a head walks N in tiles three times, where a slice of a
  head cannot be resident even over 8 blocks.

Of the resident configurations that fit (``candidates``), it takes the one that
keeps the most warps on an SM, then the fewest blocks a head, then the smallest
team. The kernel reads the layout as a ``ResidentGeometry`` or ``TiledGeometry``
struct, after an int that names the route. Each head's operands are one contiguous
span, in one of K2's two orders (``head_layout`` of ``ops/cuda/linear_attention.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary
from recnext_tpu_torch.ops.cuda.linear_attention import LAYOUTS, MAX_DIM, MAX_SMEM_BYTES, _layout_of

SOURCE = PKG / "csrc" / "linear_attention_bwd.cu"
ROUTES = ("packed", "cluster", "tiled")
ROUTE_CODE = {"tiled": 0, "packed": 1, "cluster": 1}  # csrc: kTiled, kResident
# resident routes
ROWS = 4  # rows of an outer-product block, outputs of a product item (csrc: kR)
QUAD = 4  # positions of a product item (csrc: kQ)
BLOCK_THREADS = 256  # threads of a resident block
TEAM_SIZES = (32, 64, 128, 256)
MAX_CLUSTER = 8  # blocks of a cluster (the portable most)
REGISTERS = 64  # registers a thread at most (csrc: __launch_bounds__(256, 4))
SM_REGISTERS = 65536
SM_SMEM_BYTES = 233472  # shared memory of an SM; a block also takes RESERVED_SMEM_BYTES
RESERVED_SMEM_BYTES = 1024
SM_THREADS = 2048
SM_BLOCKS = 32
RESIDENT_FIELDS = ("n", "d", "dv", "n_fastest", "team", "heads_per_block", "cluster", "len",
                   "pn", "dr", "dvr", "splits", "k", "v", "q", "g", "x1", "x2", "f1", "f2",
                   "pm", "pt", "bn", "team_floats")
# the tiled route
BLOCK = 8  # rows and columns of an outer-product block, outputs of a product item (csrc: kB)
POSITIONS = 2  # positions of a product item (csrc: kP)
MAX_TILE = 128  # the most positions of one tile
TILED_FIELDS = ("n", "d", "dv", "n_fastest", "team", "tile", "tiles", "tp", "dp", "dvp",
                "mt", "mk", "vm", "vdm", "ta", "tb", "tt", "tr", "tbn", "floats", "splits")


def _declare(lib: ctypes.CDLL) -> None:
    lib.linear_attention_backward.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 2
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.linear_attention_backward.restype = ctypes.c_int
    lib.linear_attention_backward_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                                         ctypes.POINTER(ctypes.c_int),
                                                         ctypes.POINTER(ctypes.c_int)]
    lib.linear_attention_backward_attributes.restype = ctypes.c_int
    lib.linear_attention_backward_resident.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.linear_attention_backward_resident.restype = ctypes.c_int
    lib.linear_attention_backward_error_string.argtypes = [ctypes.c_int]
    lib.linear_attention_backward_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("linear_attention_bwd", SOURCE, _declare)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    return LIBRARY.load()


def _raise(lib, what: str, err: int):
    raise RuntimeError(f"linear attention backward {what}: "
                       f"{lib.linear_attention_backward_error_string(err).decode()} ({err})")


def kernel_attributes(dtype: torch.dtype, route: str) -> dict:
    """Registers per thread and local (spill and stack) bytes per thread of the
    route's kernel built for ``dtype``, as the CUDA runtime reports them."""
    lib = load_library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.linear_attention_backward_attributes(int(dtype == torch.bfloat16),
                                                   ROUTE_CODE[route], ctypes.byref(regs),
                                                   ctypes.byref(local))
    if err != 0:
        _raise(lib, "attributes", err)
    return {"registers": regs.value, "local_bytes": local.value}


def resident_blocks(cfg: "LaunchConfig", dtype: torch.dtype) -> int:
    """Blocks of ``cfg`` that one SM holds at once (the CUDA runtime's occupancy for
    the route's kernel built for ``dtype``)."""
    lib = load_library()
    blocks = ctypes.c_int()
    err = lib.linear_attention_backward_resident(int(dtype == torch.bfloat16),
                                                 ROUTE_CODE[cfg.route], cfg.threads,
                                                 cfg.smem_bytes, ctypes.byref(blocks))
    if err != 0:
        _raise(lib, "occupancy", err)
    return blocks.value


def _ceil_to(a: int, m: int) -> int:
    return -(-a // m) * m


class LaunchConfig(NamedTuple):
    route: str            # "packed", "cluster" or "tiled" (ROUTES)
    team: int             # threads that own one head (packed), or one slice of it
    heads_per_block: int  # teams of a block (1 but where packed)
    cluster: int          # blocks of a head (a thread-block cluster where > 1)
    threads: int          # threads of a block
    tile: int             # positions a block holds at once: the head, its slice, a tile
    tiles: int            # tiles a block walks (1 but where tiled)
    splits: int           # lanes that share one outer-product block
    smem_bytes: int       # dynamic shared memory of a block
    geometry: tuple       # the route's code, then the csrc geometry struct field by field


def warps_per_sm(cfg: LaunchConfig) -> int:
    """Warps an SM holds of ``cfg``'s blocks, with REGISTERS registers a thread."""
    blocks = min(SM_BLOCKS, SM_THREADS // cfg.threads,
                 SM_REGISTERS // (REGISTERS * cfg.threads),
                 SM_SMEM_BYTES // (cfg.smem_bytes + RESERVED_SMEM_BYTES))
    return blocks * cfg.threads // 32


def _check(n: int, d: int, dv: int, elem_bytes: int, layout: str) -> None:
    if not (1 <= d <= MAX_DIM and 1 <= dv <= MAX_DIM) or n < 1:
        raise ValueError(f"linear_attention_backward_cuda: D={d}, DV={dv} and N={n}: the "
                         f"kernel takes 1 <= D, DV <= {MAX_DIM} and N >= 1")
    if layout not in LAYOUTS:
        raise ValueError(f"linear_attention_backward_cuda: layout {layout!r} not in {LAYOUTS}")
    if elem_bytes not in (2, 4):
        raise ValueError(f"linear_attention_backward_cuda: {elem_bytes}-byte elements "
                         "(f32 or bf16 only)")


def resident_splits(d: int, dv: int, team: int) -> int:
    """Lanes per outer-product block: the most (a power of two, at most 32) that leave
    a lane for each row sum; 1 where the blocks alone fill the team."""
    blocks, rows = (-(-d // ROWS)) * (-(-dv // ROWS)), _ceil_to(d, ROWS)
    splits = 1
    while splits < 32 and 2 * splits * blocks + rows <= team:
        splits *= 2
    return splits


def pitch(length: int, splits: int) -> int:
    """Floats per position row of a slice of ``length`` positions: at least the
    length rounded up to QUAD, and 2s modulo 4s for s = splits clamped to 2..8, so
    that the 16 lanes of a float2 load on different rows (4 s apart in floats) or
    positions (one pair each) fall on different banks."""
    s = max(2, min(splits, 8))
    l4 = _ceil_to(length, QUAD)
    return l4 + (2 * s - l4) % (4 * s)


def resident_layout(length: int, d: int, dv: int, cluster: int, splits: int) -> dict:
    """A team's shared-memory regions, in floats, for a slice of ``length``
    positions; each region starts on a 16-byte boundary. Where cluster == 1 the
    head's sums are the team's own (f1 = x1, f2 = x2)."""
    dr, dvr, pn = _ceil_to(d, ROWS), _ceil_to(dv, ROWS), pitch(length, splits)
    mat = dr * dvr + dr
    sizes = [("k", dr * pn), ("v", dvr * pn), ("q", dr * pn), ("g", dvr * pn), ("x1", mat),
             ("x2", mat)] + ([("f1", mat), ("f2", mat)] if cluster > 1 else []) + [
        ("pm", dr // ROWS * pn), ("pt", dr // ROWS * pn), ("bn", pn)]
    out, at = {"pn": pn, "dr": dr, "dvr": dvr}, 0
    for name, size in sizes:
        out[name] = at
        at += _ceil_to(size, 4)
    if cluster == 1:
        out["f1"], out["f2"] = out["x1"], out["x2"]
    out["team_floats"] = at
    return out


def resident_config(n: int, d: int, dv: int, layout: str, cluster: int,
                    team: int) -> LaunchConfig | None:
    """The packed (cluster == 1: BLOCK_THREADS // team heads a block) or cluster
    (team == BLOCK_THREADS) configuration, or None where it does not fit: each
    pass-2 item of a slice (a 4-row block by QUAD positions) needs a lane of its own,
    every block of a cluster holds at least one position, and a block's regions fit
    in MAX_SMEM_BYTES."""
    length = -(-n // cluster)
    if (cluster - 1) * length >= n or (-(-d // ROWS)) * (-(-length // QUAD)) > team:
        return None
    if cluster > 1 and team != BLOCK_THREADS:
        return None
    heads = BLOCK_THREADS // team if cluster == 1 else 1
    splits = resident_splits(d, dv, team)
    lay = resident_layout(length, d, dv, cluster, splits)
    smem = 4 * lay["team_floats"] * heads
    if smem > MAX_SMEM_BYTES:
        return None
    fields = dict(lay, n=n, d=d, dv=dv, n_fastest=int(layout == "n"), team=team,
                  heads_per_block=heads, cluster=cluster, len=length, splits=splits)
    route = "packed" if cluster == 1 else "cluster"
    geometry = (ROUTE_CODE[route], *(fields[f] for f in RESIDENT_FIELDS))
    return LaunchConfig(route, team, heads, cluster, team * heads, length, 1, splits, smem,
                        geometry)


def tiled_team(n: int) -> int:
    """Threads of a head's block on the tiled route, from its positions: 32 up to 16,
    64 up to 64, 128 up to 256, else 256."""
    return next(t for t, most in ((32, 16), (64, 64), (128, 256), (256, None))
                if most is None or n <= most)


def tiled_layout(n: int, d: int, dv: int, tile: int) -> dict:
    """The tiled route's shared-memory regions of one block, in floats, for tiles of
    ``tile`` positions: each region starts on a 16-byte boundary."""
    dp, dvp = _ceil_to(d, BLOCK), _ceil_to(dv, BLOCK)
    tp = tile | 1  # odd: a tile's rows fall on different banks
    sizes = (("mt", dv * dp), ("mk", d * dvp), ("vm", dp), ("vdm", dp), ("ta", dp * tp),
             ("tb", dvp * tp), ("tt", dp * tp), ("tr", tp), ("tbn", tp))
    out, at = {"dp": dp, "dvp": dvp, "tp": tp}, 0
    for name, size in sizes:
        out[name] = at
        at += _ceil_to(size, 4)
    out["floats"] = at
    return out


def tiled_config(n: int, d: int, dv: int, layout: str) -> LaunchConfig:
    """The tiled route: a block of ``tiled_team(n)`` threads a head; N cut into the
    fewest tiles of at most ``MAX_TILE`` positions, evenly, that fit in shared memory."""
    team = tiled_team(n)
    blocks = -(-d // BLOCK) * -(-dv // BLOCK)
    splits = 1
    while splits < 32 and 2 * splits * blocks <= team:
        splits *= 2
    # the two D x DV matrices take at most 128 KB, so a short enough tile always fits
    tiles = -(-n // MAX_TILE)
    while 4 * tiled_layout(n, d, dv, -(-n // tiles))["floats"] > MAX_SMEM_BYTES:
        tiles += 1
    tile = -(-n // tiles)
    lay = tiled_layout(n, d, dv, tile)
    tiles = -(-n // tile)
    fields = dict(lay, n=n, d=d, dv=dv, n_fastest=int(layout == "n"), team=team, tile=tile,
                  tiles=tiles, splits=splits)
    geometry = (ROUTE_CODE["tiled"], *(fields[f] for f in TILED_FIELDS))
    return LaunchConfig("tiled", team, 1, 1, team, tile, tiles, splits, 4 * lay["floats"],
                        geometry)


def candidates(n: int, d: int, dv: int, elem_bytes: int, layout: str) -> dict:
    """Every launch configuration of these heads that the kernel takes, by label:
    "packed_t{team}", "cluster{C}" and "tiled" (``tools/k2_bwd_phases.py`` times
    each). Raises ValueError where the kernel cannot run."""
    _check(n, d, dv, elem_bytes, layout)
    out = {}
    for cluster in range(1, MAX_CLUSTER + 1):
        for team in TEAM_SIZES:
            cfg = resident_config(n, d, dv, layout, cluster, team)
            if cfg is not None:
                out[f"packed_t{team}" if cluster == 1 else f"cluster{cluster}"] = cfg
    out["tiled"] = tiled_config(n, d, dv, layout)
    return out


@functools.lru_cache(maxsize=None)
def launch_config(n: int, d: int, dv: int, elem_bytes: int, layout: str) -> LaunchConfig:
    """The route and layout of the backward of heads of N positions with D-wide q and
    k and DV-wide v and g, ``elem_bytes`` per element, in ``layout`` ("n" or "d"): of
    the resident configurations that fit, the one with the most warps an SM
    (``warps_per_sm``), then the fewest blocks a head, then the smallest team; the
    tiled route where none fits. Raises ValueError where the kernel cannot run."""
    options = candidates(n, d, dv, elem_bytes, layout)
    resident = [c for c in options.values() if c.route != "tiled"]
    if not resident:
        return options["tiled"]
    return max(resident, key=lambda c: (warps_per_sm(c), -c.cluster, -c.team))


@functools.lru_cache(maxsize=1024)
def _launch_args(specs: tuple, elem_bytes: int):
    """The launch configuration and the C entry's stride and geometry arrays for
    operands of these (shape, stride) pairs: built once per set of shapes."""
    (_, _, n, d), _ = specs[0]
    cfg = launch_config(n, d, specs[2][0][3], elem_bytes, _layout_of(specs))
    strides = (ctypes.c_longlong * 14)(*(x for _, st in specs for x in st[:2]))
    geometry = (ctypes.c_int * len(cfg.geometry))(*cfg.geometry)
    return cfg, strides, geometry


def linear_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   g: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                                   dv: torch.Tensor, *, eps: float = 1e-6):
    """Launch the backward on q's current stream, writing dq, dk and dv. Every
    operand is a (B, H, N, R) view whose heads are each one contiguous span, all in
    one order (``head_layout``): q, k, dq, dk (B, H, N, D); v, g, dv (B, H, N, DV); all
    f32 or all bf16, on one CUDA device. Raises on anything else, before any launch."""
    ts = (q, k, v, g, dq, dk, dv)
    if not all(t.is_cuda for t in ts):
        raise ValueError("linear_attention_backward_cuda: every operand must be a CUDA tensor")
    if any(t.device != q.device for t in ts):
        raise ValueError("linear_attention_backward_cuda: operands on different devices")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"linear_attention_backward_cuda: dtype {q.dtype} not supported "
                         "(all operands f32, or all bf16)")
    if any(t.dim() != 4 for t in ts):
        raise ValueError("linear_attention_backward_cuda: operands must be (B, H, N, D) views")
    b, h, n, d = q.shape
    dvw = v.shape[-1]
    qs, vs = (b, h, n, d), (b, h, n, dvw)
    if any(tuple(t.shape) != qs for t in (k, dq, dk)) or any(
            tuple(t.shape) != vs for t in (g, dv)):
        raise ValueError(f"linear_attention_backward_cuda: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, g {tuple(g.shape)}, dq "
                         f"{tuple(dq.shape)}, dk {tuple(dk.shape)}, dv {tuple(dv.shape)}")
    cfg, strides, geometry = _launch_args(tuple((tuple(t.shape), t.stride()) for t in ts),
                                          q.element_size())
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.linear_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, b * h, h, geometry, len(cfg.geometry),
            cfg.smem_bytes, eps, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"linear attention backward launch failed: "
                           f"{lib.linear_attention_backward_error_string(err).decode()} ({err})")
    return dq, dk, dv
