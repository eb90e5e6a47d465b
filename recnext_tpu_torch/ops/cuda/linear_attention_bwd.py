"""Binding of the linear-attention backward kernel (``csrc/linear_attention_bwd.cu``).

The gradient of ``recnext_tpu/ops/attention.py:linear_attention_kv_first``, which has
no Pallas backward in the JAX package: given q, k, v and g = dL/dout, the kernel
returns dq, dk and dv. The source is its own library (``ops/cuda/build.py``), built
with ``nvcc`` for ``sm_90a`` at first use; nothing is built or loaded at import.

The host side lays the kernel out, once per shape, in plain Python that the CPU
tests reach: ``launch_config`` gives the threads of the block that owns one head,
the tile of positions a pass walks, the lanes that share an outer-product block and
the shared-memory layout, which the kernel reads as its ``Geometry`` struct. Each
head's operands are one contiguous span, in one of K2's two orders (``head_layout``
of ``ops/cuda/linear_attention.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from recnext_tpu_torch.ops.cuda.build import PKG, CudaLibrary
from recnext_tpu_torch.ops.cuda.linear_attention import LAYOUTS, MAX_DIM, MAX_SMEM_BYTES, _layout_of

SOURCE = PKG / "csrc" / "linear_attention_bwd.cu"
BLOCK = 8  # rows and columns of an outer-product block, outputs of a product item (csrc: kB)
POSITIONS = 2  # positions of a product item (csrc: kP)
MAX_TILE = 128  # the most positions of one tile
GEOMETRY_FIELDS = ("n", "d", "dv", "n_fastest", "team", "tile", "tiles", "tp", "dp", "dvp",
                   "mt", "mk", "vm", "vdm", "ta", "tb", "tt", "tr", "tbn", "floats", "splits")


def _declare(lib: ctypes.CDLL) -> None:
    lib.linear_attention_backward.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 2
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.linear_attention_backward.restype = ctypes.c_int
    lib.linear_attention_backward_attributes.argtypes = [ctypes.c_int,
                                                         ctypes.POINTER(ctypes.c_int),
                                                         ctypes.POINTER(ctypes.c_int)]
    lib.linear_attention_backward_attributes.restype = ctypes.c_int
    lib.linear_attention_backward_error_string.argtypes = [ctypes.c_int]
    lib.linear_attention_backward_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("linear_attention_bwd", SOURCE, _declare)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the kernel library; thread-safe."""
    return LIBRARY.load()


def kernel_attributes(dtype: torch.dtype) -> dict:
    """Registers per thread and local (spill and stack) bytes per thread of the
    kernel built for ``dtype``, as the CUDA runtime reports them."""
    lib = load_library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.linear_attention_backward_attributes(int(dtype == torch.bfloat16),
                                                   ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"linear attention backward attributes: "
                           f"{lib.linear_attention_backward_error_string(err).decode()} ({err})")
    return {"registers": regs.value, "local_bytes": local.value}


def _ceil_to(a: int, m: int) -> int:
    return -(-a // m) * m


class LaunchConfig(NamedTuple):
    team: int        # threads of the block that owns one head
    tile: int        # positions of a tile (the last may be shorter)
    tiles: int       # tiles per head
    splits: int      # lanes that share one 8 x 8 outer-product block
    smem_bytes: int  # dynamic shared memory of a block
    geometry: tuple  # csrc/linear_attention_bwd.cu:Geometry, field by field (GEOMETRY_FIELDS)


def team_size(n: int) -> int:
    """Threads of a head's block, from its positions: 32 up to 16, 64 up to 64, 128 up
    to 256, else 256."""
    return next(t for t, most in ((32, 16), (64, 64), (128, 256), (256, None))
                if most is None or n <= most)


def _layout(n: int, d: int, dv: int, tile: int) -> dict:
    """The shared-memory regions of one block, in floats, for tiles of ``tile``
    positions: each region starts on a 16-byte boundary."""
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


@functools.lru_cache(maxsize=None)
def launch_config(n: int, d: int, dv: int, elem_bytes: int, layout: str) -> LaunchConfig:
    """Team, tile, splits, shared bytes and geometry of the backward of heads of N
    positions with D-wide q and k and DV-wide v and g, ``elem_bytes`` per element, in
    ``layout`` ("n" or "d"). N is cut into the fewest tiles of at most ``MAX_TILE``
    positions, evenly, that fit in shared memory. Raises ValueError where the kernel
    cannot run."""
    if not (1 <= d <= MAX_DIM and 1 <= dv <= MAX_DIM) or n < 1:
        raise ValueError(f"linear_attention_backward_cuda: D={d}, DV={dv} and N={n}: the "
                         f"kernel takes 1 <= D, DV <= {MAX_DIM} and N >= 1")
    if layout not in LAYOUTS:
        raise ValueError(f"linear_attention_backward_cuda: layout {layout!r} not in {LAYOUTS}")
    if elem_bytes not in (2, 4):
        raise ValueError(f"linear_attention_backward_cuda: {elem_bytes}-byte elements "
                         "(f32 or bf16 only)")
    team = team_size(n)
    blocks = -(-d // BLOCK) * -(-dv // BLOCK)
    splits = 1
    while splits < 32 and 2 * splits * blocks <= team:
        splits *= 2
    # the two D x DV matrices take at most 128 KB, so a short enough tile always fits
    tiles = -(-n // MAX_TILE)
    while 4 * _layout(n, d, dv, -(-n // tiles))["floats"] > MAX_SMEM_BYTES:
        tiles += 1
    tile = -(-n // tiles)
    lay = _layout(n, d, dv, tile)
    tiles = -(-n // tile)
    fields = dict(lay, n=n, d=d, dv=dv, n_fastest=int(layout == "n"), team=team, tile=tile,
                  tiles=tiles, splits=splits)
    geometry = tuple(fields[f] for f in GEOMETRY_FIELDS)
    return LaunchConfig(team, tile, tiles, splits, 4 * lay["floats"], geometry)


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
