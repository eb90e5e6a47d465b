"""The gradient of the port's linear attention against the JAX package's.

The plain backward (autograd over the kv-first form in fp32) against ``jax.vjp`` of
``recnext_tpu.ops.attention.linear_attention_kv_first`` and ``_qk_first``; a numpy
transcription of the backward kernel on the route ``launch_config`` picks (the
resident routes in their shared-memory layout, the tiled walk in its tiles; the
formulas and their order) against the same ``jax.vjp``; the tiled walk's launch
layout (tests/test_torch_attention_bwd_plan.py tests every route's); the entries
under grad on CPU tensors (the plain version under autograd; the Function that carries
both kernels takes CUDA tensors only); and the LinearAttention and RecAttn2d mixers'
parameter and input gradients against ``jax.grad`` of the flax modules on the same
weights. Inputs are made with numpy and handed to both; NHWC <-> NCHW is explicit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.models.mixers import LinearAttention as JaxLinearAttention
from recnext_tpu.models.mixers import RecAttn2d as JaxRecAttn2d
from recnext_tpu.ops.attention import linear_attention_kv_first as jax_kv_first
from recnext_tpu.ops.attention import linear_attention_qk_first as jax_qk_first
from recnext_tpu_torch.convert import jax_to_torch
from recnext_tpu_torch.models.mixers import LinearAttention, RecAttn2d
from recnext_tpu_torch.ops import attention as A
from recnext_tpu_torch.ops.cuda import linear_attention_bwd as B
from recnext_tpu_torch.ops.cuda.linear_attention import MAX_SMEM_BYTES

EPS = 1e-6
# tests/test_pallas.py:29-34's (BH, N, D, DV); recnext_a1's four head shapes (N 784,
# 196, 49, 16; D = DV = 24) at BH <= 8; DV != D (the L family's LA3: D 12, DV 24);
# N = 1
SHAPES = [(2, 16, 32, 32), (4, 64, 64, 64), (2, 49, 20, 20), (2, 196, 20, 40),
          (2, 784, 24, 24), (4, 196, 24, 24), (8, 49, 24, 24), (8, 16, 24, 24),
          (3, 49, 12, 24), (3, 1, 24, 40)]
IDS = [f"bh{bh}_n{n}_d{d}_dv{dv}" for bh, n, d, dv in SHAPES]


def _qkvg(bh, n, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    # elu(x)+1 features are positive: so are q and k here, as in tests/test_pallas.py
    q = np.abs(rng.normal(size=(bh, n, d))).astype(np.float32) + 0.1
    k = np.abs(rng.normal(size=(bh, n, d))).astype(np.float32) + 0.1
    v = rng.normal(size=(bh, n, dv)).astype(np.float32)
    g = rng.normal(size=(bh, n, dv)).astype(np.float32)
    return q, k, v, g


def _jax_vjp(fn, q, k, v, g):
    _, pull = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in pull(jnp.asarray(g))]


def _close(got, want, name):
    """Within 2e-5 max|ref| of each tensor: fp32 sums in another order. A gradient
    that is 0 in exact arithmetic (dq and dk at N = 1, where out = v whatever q and
    k are) holds rounding noise on both sides, with no scale: under 1e-5 each."""
    scale = np.abs(want).max()
    if scale < 1e-5:
        assert np.abs(got).max() < 1e-5, (name, np.abs(got).max(), scale)
        return
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= 2e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("bh,n,d,dv", SHAPES, ids=IDS)
def test_plain_backward_matches_jax_vjp(bh, n, d, dv):
    q, k, v, g = _qkvg(bh, n, d, dv)
    got = A.linear_attention_backward_plain(*(torch.from_numpy(a) for a in (q, k, v, g)))
    for fn in (jax_kv_first, jax_qk_first):
        for name, a, b in zip("qkv", got, _jax_vjp(fn, q, k, v, g)):
            assert a.dtype == torch.float32 and a.shape == b.shape
            _close(a.numpy(), b, f"d{name} vs {fn.__name__}")


def transcribe_kernel(q, k, v, g, layout="n", eps=EPS, elem_bytes=4, cfg=None, shift=0):
    """csrc/linear_attention_bwd.cu, one head at a time, in numpy fp32, on the route
    ``launch_config`` picks (or ``cfg``): the resident routes through
    ``transcribe_resident``, the tiled one through ``transcribe_tiled``."""
    bh, n, d = q.shape
    cfg = cfg or B.launch_config(n, d, v.shape[-1], elem_bytes, layout)
    if cfg.route == "tiled":
        return transcribe_tiled(q, k, v, g, cfg, eps)
    return transcribe_resident(q, k, v, g, cfg, layout, eps, elem_bytes, shift)


def transcribe_tiled(q, k, v, g, cfg, eps=EPS):
    """The tiled route: the launch configuration's tiles, the outer products split
    over ``splits`` lanes (each lane's positions in order, then the butterfly), the
    row sums one lane a row, the three passes with the kernel's formulas in the
    kernel's order."""
    bh, n, d = q.shape
    dv = v.shape[-1]
    f32 = np.float32
    inv_n = f32(1.0) / f32(n)

    def outer(a_tile, b_tile):  # (D, len) x (DV, len) -> (D, DV), as the lanes sum
        parts = [np.zeros((a_tile.shape[0], b_tile.shape[0]), f32)
                 for _ in range(cfg.splits)]
        for sp in range(cfg.splits):
            for i in range(sp, a_tile.shape[1], cfg.splits):
                parts[sp] = parts[sp] + np.outer(a_tile[:, i], b_tile[:, i]).astype(f32)
        return _butterfly(parts)

    out = [np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)]
    for h in range(bh):
        qh, kh, vh, gh = (x[h].T.astype(f32) for x in (q, k, v, g))  # (rows, N) tiles
        tiles = [(t * cfg.tile, min(cfg.tile, n - t * cfg.tile)) for t in range(cfg.tiles)]
        kv = np.zeros((d, dv), f32)
        ksum = np.zeros(d, f32)
        for n0, ln in tiles:  # pass 1
            sl = slice(n0, n0 + ln)
            kv += outer(kh[:, sl], vh[:, sl])
            ksum += kh[:, sl].sum(axis=1, dtype=f32)
        kv *= inv_n
        m = ksum * inv_n
        dkv = np.zeros((d, dv), f32)
        dm = np.zeros(d, f32)
        for n0, ln in tiles:  # pass 2
            sl = slice(n0, n0 + ln)
            qt, gt = qh[:, sl], gh[:, sl]
            t = kv @ gt                                  # (D, len): t_n = kv g_n
            r = f32(1.0) / ((qt * m[:, None]).sum(axis=0, dtype=f32) + f32(eps))
            b = -r * r * (qt * t).sum(axis=0, dtype=f32)  # -r (g_n . o_n)
            out[0][h, sl] = (r * t + b * m[:, None]).T    # dq_n = r t_n + b m
            dkv += outer(qt, r * gt)                      # a_n = r g_n
            dm += (qt * b).sum(axis=1, dtype=f32)
        dkv *= inv_n
        dm *= inv_n
        for n0, ln in tiles:  # pass 3
            sl = slice(n0, n0 + ln)
            out[1][h, sl] = (dkv @ vh[:, sl] + dm[:, None]).T  # s2 dKV v_n + dm / N
            out[2][h, sl] = (dkv.T @ kh[:, sl]).T              # s2 dKV^T k_n
    return out


def _butterfly(parts):
    """The kernel's butterfly over the lanes of one block: lane l adds lane l ^ off's
    partial, off = splits / 2 .. 1; lane 0's sum."""
    off = len(parts) // 2
    while off:
        parts = [parts[lane] + parts[lane ^ off] for lane in range(len(parts))]
        off //= 2
    return parts[0]


def _block_order(rows: int) -> np.ndarray:
    """Where row r of a 4-row-block matrix sits in the kernel's block order:
    (r % nb) * 4 + r // nb for nb = rows / 4 (``ROWS``)."""
    nb = rows // B.ROWS
    r = np.arange(rows)
    return (r % nb) * B.ROWS + r // nb


def load_slice(sm, off, span, rows, n0, length, geo, layout, elem_bytes, shift):
    """The kernel's load_slices for one operand: the 16-byte chunks that cover each
    piece of the slice (at the head's misalignment ``shift`` elements), each element
    stored at row * pn + position of the region at ``off`` of ``sm``."""
    rowwise = layout == "n" and geo["cluster"] > 1
    pieces, plen = (rows, length) if rowwise else (1, rows * length)
    chunks = (30 + plen * elem_bytes) >> 4
    start = n0 if layout == "n" else n0 * rows
    w = length if layout == "n" else rows
    for p in range(pieces):
        ps = start + p * geo["n"]
        sh = ((shift + ps) * elem_bytes) % 16
        for j in range(chunks):
            if 16 * j >= sh + plen * elem_bytes:
                continue
            i0 = (16 * j - sh) // elem_bytes
            lo = max(0, -i0)
            slow, fast = divmod(p * plen + i0 + lo, w)
            for e in range(lo, 16 // elem_bytes):
                if i0 + e >= plen:
                    break
                row, pos = (slow, fast) if layout == "n" else (fast, slow)
                sm[off + row * geo["pn"] + pos] = span[ps + i0 + e]
                fast += 1
                if fast == w:
                    fast, slow = 0, slow + 1


def _zero_pad(sm, off, rows, rows_r, length, l4, pn):
    reg = sm[off:off + rows_r * pn].reshape(rows_r, pn)
    reg[:rows, length:l4] = 0.0
    reg[rows:rows_r, :l4] = 0.0


def _outer_resident(sm, a_off, nba, b_off, nbb, length, geo, dst, rowsum, w, scale):
    """outer: each 4 x 4 block's splits (every splits-th pair of positions) summed by
    the butterfly, times ``scale``, into dr rows of dvr with the columns in block
    order; the row sums (even and odd positions apart, then added) times ``scale``."""
    pn, splits = geo["pn"], geo["splits"]
    ra, rb = nba * B.ROWS, nbb * B.ROWS
    A = sm[a_off:a_off + ra * pn].reshape(ra, pn)
    Bm = sm[b_off:b_off + rb * pn].reshape(rb, pn)
    pairs = (length + 1) // 2
    parts = []
    for sp in range(splits):
        pos = np.array([2 * j + o for j in range(sp, pairs, splits) for o in (0, 1)], int)
        parts.append((A[:, pos] @ Bm[:, pos].T).astype(np.float32) if len(pos)
                     else np.zeros((ra, rb), np.float32))
    total = _butterfly(parts) * np.float32(scale)
    sm[dst + np.arange(ra)[:, None] * rb + _block_order(rb)[None, :]] = total
    wt = np.ones(2 * pairs, np.float32) if w is None else sm[w:w + 2 * pairs]
    prod = A[:, :2 * pairs] * wt
    sm[rowsum:rowsum + ra] = (prod[:, 0::2].sum(axis=1, dtype=np.float32)
                              + prod[:, 1::2].sum(axis=1, dtype=np.float32)) * np.float32(scale)


def transcribe_resident(q, k, v, g, cfg, layout, eps=EPS, elem_bytes=4, shift=0):
    """The packed and cluster routes: each block's team region as one float32 array
    filled with NaN (a read of a word the kernel has not written shows as NaN), the
    slices loaded chunk by chunk and zero-padded, the outer products' splits summed by
    the butterfly once a pass (scaled by 1/N where the slice is the head), a
    cluster's partial sums added in rank order and then scaled, pass 2's dots as
    shares of 4-row blocks summed in block order, the kernel's formulas and block
    orders throughout."""
    geo = dict(zip(B.RESIDENT_FIELDS, cfg.geometry[1:]))
    bh, n, d = q.shape
    dv = v.shape[-1]
    f32 = np.float32
    inv_n = f32(1.0) / f32(n)
    pn, dr, dvr, C = geo["pn"], geo["dr"], geo["dvr"], geo["cluster"]
    nbd = dr // B.ROWS
    mat = dr * dvr
    scale = f32(1.0) if C > 1 else inv_n
    natural = _block_order(dvr)  # column e of a matrix sits at natural[e]
    out = [np.full_like(q, np.nan), np.full_like(k, np.nan), np.full_like(v, np.nan)]

    def span(x):  # a head's span in the layout's order
        return (x.T if layout == "n" else x).reshape(-1).astype(f32)

    def combine(sms, x_off, f_off):  # the head's sums: the blocks' in rank order, scaled
        if C == 1:
            return
        parts = [sm[x_off:x_off + mat + dr].copy() for sm in sms]
        for sm in sms:
            total = np.zeros_like(parts[0])
            for part in parts:
                total = total + part
            sm[f_off:f_off + mat + dr] = total * inv_n

    for h in range(bh):
        sms = [np.full(geo["team_floats"], np.nan, f32) for _ in range(C)]
        slices = [(r * geo["len"], min(geo["len"], n - r * geo["len"])) for r in range(C)]
        for sm, (n0, ln) in zip(sms, slices):
            l4 = -(-ln // B.QUAD) * B.QUAD
            for name, x, rows, rows_r in (("k", k, d, dr), ("v", v, dv, dvr), ("q", q, d, dr),
                                          ("g", g, dv, dvr)):
                load_slice(sm, geo[name], span(x[h]), rows, n0, ln, geo, layout, elem_bytes,
                           shift)
                _zero_pad(sm, geo[name], rows, rows_r, ln, l4, pn)
            _outer_resident(sm, geo["k"], nbd, geo["v"], dvr // B.ROWS, ln, geo, geo["x1"],
                            geo["x1"] + mat, None, scale)
        combine(sms, geo["x1"], geo["f1"])
        for sm, (n0, ln) in zip(sms, slices):
            l4 = -(-ln // B.QUAD) * B.QUAD
            G = sm[geo["g"]:geo["g"] + dvr * pn].reshape(dvr, pn)
            Q = sm[geo["q"]:geo["q"] + dr * pn].reshape(dr, pn)
            kv = sm[geo["f1"]:geo["f1"] + mat].reshape(dr, dvr)[:, natural]  # (d, e)
            m = sm[geo["f1"] + mat:geo["f1"] + mat + dr]
            t = (kv[:, :dv] @ G[:dv, :l4]).astype(f32)  # (d, n): t_n = kv g_n
            # each item's shares over its rows db + i nbd, summed over i
            PM = sm[geo["pm"]:geo["pm"] + nbd * pn].reshape(nbd, pn)
            PT = sm[geo["pt"]:geo["pt"] + nbd * pn].reshape(nbd, pn)
            PM[:, :l4] = (Q[:, :l4] * m[:, None]).reshape(B.ROWS, nbd, l4).sum(axis=0, dtype=f32)
            PT[:, :l4] = (Q[:, :l4] * t).reshape(B.ROWS, nbd, l4).sum(axis=0, dtype=f32)
            sm4, st4 = np.zeros(l4, f32), np.zeros(l4, f32)
            for x in range(nbd):  # the shares in block order
                sm4, st4 = sm4 + PM[x, :l4], st4 + PT[x, :l4]
            r = f32(1.0) / (sm4 + f32(eps))
            b = -r * r * st4
            out[0][h, n0:n0 + ln] = (r * t + b * m[:, None])[:d, :ln].T  # dq_n = r t_n + b m
            G[:dv, :l4] *= r  # a_n = r_n g_n
            sm[geo["bn"]:geo["bn"] + l4] = b
            _outer_resident(sm, geo["q"], nbd, geo["g"], dvr // B.ROWS, ln, geo, geo["x2"],
                            geo["x2"] + mat, geo["bn"], scale)
        combine(sms, geo["x2"], geo["f2"])
        for sm, (n0, ln) in zip(sms, slices):
            l4 = -(-ln // B.QUAD) * B.QUAD
            V = sm[geo["v"]:geo["v"] + dvr * pn].reshape(dvr, pn)
            K = sm[geo["k"]:geo["k"] + dr * pn].reshape(dr, pn)
            dkv = sm[geo["f2"]:geo["f2"] + mat].reshape(dr, dvr)[:, natural]  # (d, e)
            dm = sm[geo["f2"] + mat:geo["f2"] + mat + dr]
            dk = (dkv[:, :dv] @ V[:dv, :l4]).astype(f32) + dm[:, None]  # s2 dKV v_n + dm / N
            dvv = (dkv[:d].T @ K[:d, :l4]).astype(f32)  # s2 dKV^T k_n
            out[1][h, n0:n0 + ln] = dk[:d, :ln].T
            out[2][h, n0:n0 + ln] = dvv[:dv, :ln].T
    return out


@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("bh,n,d,dv", SHAPES, ids=IDS)
def test_kernel_transcription_matches_jax_vjp(bh, n, d, dv, layout):
    q, k, v, g = _qkvg(bh, n, d, dv, seed=1)
    got = transcribe_kernel(q, k, v, g, layout)
    for name, a, b in zip("qkv", got, _jax_vjp(jax_kv_first, q, k, v, g)):
        _close(a, b, f"d{name}")


def test_kernel_transcription_tiles_a_long_head():
    """A head of more positions than one tile (N = 300 at D = DV = 128: 13 tiles of
    24) walks every pass tile by tile."""
    q, k, v, g = _qkvg(1, 300, 128, 128, seed=2)
    assert B.launch_config(300, 128, 128, 4, "n").tiles > 2
    got = transcribe_kernel(q, k, v, g)
    for name, a, b in zip("qkv", got, _jax_vjp(jax_kv_first, q, k, v, g)):
        _close(a, b, f"d{name}")


LAYOUT_SHAPES = [(n, d, dv) for _, n, d, dv in SHAPES] + [
    (784, 128, 128), (3136, 24, 24), (5, 7, 128), (127, 128, 1), (1, 1, 1)]


@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n,d,dv", LAYOUT_SHAPES)
def test_launch_config_fits_and_divides_its_block(n, d, dv, elem_bytes, layout):
    """The tiled route's layout, which the kernel takes at every shape (launch_config
    picks it where no resident layout fits: tests/test_torch_attention_bwd_plan.py)."""
    B.launch_config(n, d, dv, elem_bytes, layout)  # the kernel takes the shape
    cfg = B.tiled_config(n, d, dv, layout)
    geo = dict(zip(B.TILED_FIELDS, cfg.geometry[1:]))
    assert cfg.route == "tiled" and cfg.geometry[0] == B.ROUTE_CODE["tiled"]
    assert len(cfg.geometry) == 1 + len(B.TILED_FIELDS)
    assert cfg.smem_bytes == 4 * geo["floats"] <= MAX_SMEM_BYTES
    assert cfg.team in (32, 64, 128, 256) and cfg.team == B.tiled_team(n)
    # the lanes of an outer-product block are consecutive lanes of one warp, and the
    # block items fill whole groups of them
    assert cfg.splits in (1, 2, 4, 8, 16, 32) and cfg.team % cfg.splits == 0
    blocks = -(-d // B.BLOCK) * -(-dv // B.BLOCK)
    assert cfg.splits == 1 or cfg.splits * blocks <= cfg.team
    # the tiles cover N, the last one not empty, each of at most MAX_TILE positions
    assert (cfg.tiles - 1) * cfg.tile < n <= cfg.tiles * cfg.tile
    assert cfg.tile <= B.MAX_TILE and geo["tp"] % 2 == 1 and geo["tp"] >= cfg.tile
    assert geo["n_fastest"] == (layout == "n")
    # the regions: in order, 16-byte aligned, disjoint, each its size
    dp, dvp, tp = geo["dp"], geo["dvp"], geo["tp"]
    assert dp % B.BLOCK == dvp % B.BLOCK == 0 and dp >= d and dvp >= dv
    sizes = {"mt": dv * dp, "mk": d * dvp, "vm": dp, "vdm": dp, "ta": dp * tp,
             "tb": dvp * tp, "tt": dp * tp, "tr": tp, "tbn": tp}
    names = list(sizes)
    for a, b in zip(names, names[1:] + ["floats"]):
        assert geo[a] % 4 == 0 and geo[a] + sizes[a] <= geo[b], (a, b)


def test_launch_config_takes_the_fewest_tiles_that_fit():
    def tiled(*a):
        c = B.tiled_config(*a)
        return c.team, c.tile, c.tiles, c.splits

    assert tiled(784, 24, 24, "n") == (256, 112, 7, 16)
    assert tiled(196, 24, 24, "n") == (128, 98, 2, 8)
    assert tiled(49, 24, 24, "n") == (64, 49, 1, 4)
    assert tiled(16, 24, 24, "n") == (32, 16, 1, 2)
    # the largest D and DV: no slice is resident, and on the tiled route the two
    # matrices take 128 KB, the tiles what is left
    big = B.launch_config(784, 128, 128, 4, "d")
    assert big.route == "tiled" and big.tiles > -(-784 // B.MAX_TILE)
    assert 4 * B.tiled_layout(784, 128, 128, -(-784 // (big.tiles - 1)))["floats"] > MAX_SMEM_BYTES


@pytest.mark.parametrize("n,d,dv,elem_bytes,layout,match", [
    (16, 129, 24, 2, "n", "D=129"), (16, 24, 129, 4, "d", "DV=129"), (0, 8, 8, 2, "n", "N=0"),
    (16, 0, 8, 2, "n", "D=0"), (16, 8, 8, 2, "x", "layout"), (16, 8, 8, 8, "n", "8-byte")])
def test_launch_config_refuses_what_the_kernel_does_not_take(n, d, dv, elem_bytes, layout,
                                                             match):
    with pytest.raises(ValueError, match=match):
        B.launch_config(n, d, dv, elem_bytes, layout)


def test_backward_entries_on_cpu_are_the_plain_version():
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(3, 20, 8, 12, seed=3))
    before = A.linear_attention_backward.launches
    got = A.linear_attention_backward(q, k, v, g)
    want = A.linear_attention_backward_plain(q, k, v, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert A.linear_attention_backward.launches == before  # no kernel ran


@pytest.mark.parametrize("variant", [1, 2])
def test_cpu_entries_differentiate_the_plain_version_and_the_function_takes_cuda_only(
        variant):
    """On CPU tensors under grad, the NCHW entry is the plain version of ``variant``
    under autograd (the Function is not in the graph); the Function and the NCHW
    backward refuse CPU tensors before any launch. The Function's gradients are held
    against autograd over the plain version on the card (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(4)
    qk = torch.from_numpy(np.abs(rng.normal(size=(2, 2 * 3 * 8, 5, 6))).astype(np.float32) + .1)
    v = torch.from_numpy(rng.normal(size=(2, 3 * 10, 5, 6)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 3 * 10, 5, 6)).astype(np.float32))
    qk.requires_grad_()
    v.requires_grad_()
    out = A.linear_attention_nchw(qk, v, 3, variant=variant)
    assert "LinearAttentionFunction" not in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (qk, v), g)
    want = torch.autograd.grad(A.linear_attention_nchw_plain(qk, v, 3, variant=variant),
                               (qk, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    before = (A.linear_attention_fused.launches, A.linear_attention_backward.launches)
    with pytest.raises(ValueError, match="CUDA"):
        A.LinearAttentionFunction.apply(3, EPS, qk, v)
    with pytest.raises(ValueError, match="CUDA"):
        A.linear_attention_nchw_backward(qk.detach(), v.detach(), g, 3)
    assert (A.linear_attention_fused.launches, A.linear_attention_backward.launches) == before


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _perturbed(variables, seed=4):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(a.dtype),
                        variables)


def _compare_gradients(jax_module, port_module, x):
    """Train mode (batch statistics), f32: the gradient of sum(out * r) with respect
    to every parameter and the input, through the flax module under ``jax.grad`` and
    through the port's module under autograd, from the same weights."""
    variables = _perturbed(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    stats = variables["batch_stats"]
    port_module.load_state_dict(jax_to_torch(variables, port_module), strict=True)
    port_module.train()
    out_shape = jax.eval_shape(lambda: jax_module.apply(variables, jnp.asarray(x))).shape
    r = np.random.default_rng(7).normal(size=out_shape).astype(np.float32)

    def loss(params, xj):
        out, _ = jax_module.apply({"params": params, "batch_stats": stats}, xj,
                                  training=True, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(r))

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    want = jax_to_torch({"params": gp, "batch_stats": stats}, port_module)
    xt = _nchw(x).requires_grad_()
    (port_module(xt) * _nchw(r)).sum().backward()
    _close(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(gx), "input")
    names = [name for name, _ in port_module.named_parameters()]
    assert names
    for name, p in port_module.named_parameters():
        w = want[name].numpy()
        if np.abs(w).max() < 1e-6:  # a shift that a train-mode BatchNorm follows
            assert np.abs(p.grad.numpy()).max() < 1e-5, name
            continue
        _close(p.grad.numpy(), w, name)


@pytest.mark.parametrize("variant", [1, 2])
def test_linear_attention_module_gradients_match_flax(variant):
    x = np.random.default_rng(8).normal(size=(2, 7, 7, 16)).astype(np.float32)
    _compare_gradients(JaxLinearAttention(num_heads=2, variant=variant),
                       LinearAttention(16, 2, variant), x)


@pytest.mark.parametrize("variant,side", [(1, 8), (2, 7)])
def test_rec_attn2d_gradients_match_flax(variant, side):
    x = np.random.default_rng(9).normal(size=(2, side, side, 16)).astype(np.float32)
    _compare_gradients(JaxRecAttn2d(num_heads=4, la_variant=variant),
                       RecAttn2d(16, 4, la_variant=variant), x)
