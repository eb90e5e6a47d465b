"""The host side of the linear-attention CUDA kernel, on the CPU: the launch
configuration (team size, heads per block, tiles, shared-memory layout) that the
kernel reads as its geometry, the order in which the wrapper finds each head's span,
and a numpy transcription of the kernel's index arithmetic (csrc/linear_attention.cu:
fetch_tile, tile_of, the pass-1 and pass-2 items) that replays every 16-byte chunk of
each head's spans, at misaligned starts, in both layouts."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from recnext_tpu_torch.ops.cuda import linear_attention as la

# recnext_a1's four attention shapes (N, D, DV), then the edges the kernel takes
A1 = [(784, 24, 24), (196, 24, 24), (49, 24, 24), (16, 24, 24)]
SHAPES = A1 + [(1, 1, 1), (50, 20, 40), (4096, 128, 128), (16, 16, 32), (196, 20, 20)]


class Geometry(NamedTuple):  # csrc/linear_attention.cu:Geometry, field by field
    n: int
    d: int
    dv: int
    n_fastest: int
    team: int
    heads_per_block: int
    tile: int
    tiles: int
    pitch: int
    v_off: int
    buf0: int
    buf1: int
    kv: int
    ks: int
    kv_pitch: int
    team_bytes: int
    splits: int
    ks_parts: int


def _geometry(n, d, dv, eb, layout):
    cfg = la.launch_config(n, d, dv, eb, layout)
    return cfg, Geometry(*cfg.geometry)


@pytest.mark.parametrize("layout", la.LAYOUTS)
@pytest.mark.parametrize("eb", [2, 4])
@pytest.mark.parametrize("n,d,dv", SHAPES)
def test_launch_config_fits_a_block(n, d, dv, eb, layout):
    cfg, g = _geometry(n, d, dv, eb, layout)
    assert (g.n, g.d, g.dv, g.n_fastest) == (n, d, dv, int(layout == "n"))
    assert cfg.team == g.team == la.team_size(n, d, dv) and cfg.team in la.TEAM_SIZES
    # teams divide the block; a team larger than a warp is the whole block
    assert cfg.heads_per_block == g.heads_per_block >= 1
    assert cfg.team * cfg.heads_per_block <= 256
    assert cfg.team <= 32 or cfg.heads_per_block == 1
    assert 0 < cfg.smem_bytes == g.team_bytes * g.heads_per_block <= la.MAX_SMEM_BYTES
    # the tiles cover N exactly once
    assert (cfg.tile, cfg.tiles) == (g.tile, g.tiles)
    assert (g.tiles - 1) * g.tile < n <= g.tiles * g.tile
    assert g.tiles == 1 or g.tile % 8 == 0
    # the regions follow one another, 16-byte aligned, and kv rows take 8-float reads
    assert g.buf0 == 0 < g.v_off < g.buf1 < g.kv < g.ks <= g.team_bytes
    assert all(x % 16 == 0 for x in (g.v_off, g.buf1, g.kv, g.ks, g.team_bytes))
    assert g.kv_pitch % la.KV_BLOCK == 0 and g.kv_pitch >= dv
    assert g.ks - g.kv == 4 * d * g.kv_pitch and g.team_bytes >= g.ks + 4 * d
    assert g.pitch == 0 if g.tiles == 1 or layout == "d" else g.pitch % 16 == (n * eb) % 16
    # pass 1 keeps every thread on at most one (kv block, split) where it can; the
    # lanes of a block are a power of two within one warp (csrc: the shuffle sum),
    # and the lanes left over sum k's rows
    blocks = -(-d // 8) * -(-dv // 8)
    assert g.splits in (1, 2, 4, 8, 16, 32) and g.splits <= g.team
    assert g.splits * blocks <= g.team or g.splits == 1
    assert 2 * g.splits * blocks > g.team or g.splits == 32
    assert g.ks_parts == max(1, (g.team - g.splits * blocks) // d)


@pytest.mark.parametrize("n,team,heads,tiles", [(784, 128, 1, 5), (196, 128, 1, 1),
                                                (49, 32, 4, 1), (16, 16, 8, 1)])
def test_launch_config_of_the_a1_shapes(n, team, heads, tiles):
    cfg = la.launch_config(n, 24, 24, 2, "n")
    assert (cfg.team, cfg.heads_per_block, cfg.tiles) == (team, heads, tiles)


# the L family's shapes (N, D, DV): a team has a lane per 8x8 kv block (up to 128);
# recnext_a1's D = DV = 24 (9 blocks) keep their teams by N
L_SHAPES = [((49, 32, 32), 32), ((16, 64, 64), 64), ((16, 64, 128), 128),
            ((196, 32, 32), 128), ((49, 64, 64), 64), ((16, 96, 96), 128),
            ((49, 32, 64), 32)]


@pytest.mark.parametrize("shape,team", L_SHAPES)
def test_launch_config_of_the_l_shapes(shape, team):
    n, d, dv = shape
    for eb in (2, 4):
        cfg, g = _geometry(n, d, dv, eb, "n")
        assert cfg.team == team and (team <= 32 or cfg.heads_per_block == 1)
        blocks = -(-d // 8) * -(-dv // 8)
        assert g.splits * blocks <= g.team or blocks > 128  # one kv block a lane at most
    assert [la.team_size(n, 24, 24) for n, _, _ in A1] == [128, 128, 32, 16]


@pytest.mark.parametrize("n,d,dv,match", [(16, 129, 16, "D=129"), (16, 16, 129, "DV=129"),
                                          (0, 16, 16, "N=0")])
def test_launch_config_rejects_what_the_kernel_does_not_take(n, d, dv, match):
    with pytest.raises(ValueError, match=match):
        la.launch_config(n, d, dv, 2, "n")
    with pytest.raises(ValueError, match="layout"):
        la.launch_config(16, 16, 16, 2, "x")


def _views(b, h, n, d):
    nchw = torch.zeros(b, h * d, n).view(b, h, d, n).transpose(2, 3)  # n-fastest
    bh = torch.zeros(b * h, n, d)[:, None]  # d-fastest: (BH, 1, N, D)
    return nchw, bh


@pytest.mark.parametrize("n,d", [(49, 24), (1, 8), (16, 1), (1, 1)])
def test_head_layout(n, d):
    nchw, bh = _views(2, 3, n, d)
    assert la.head_layout(nchw, nchw) == "n"
    assert la.head_layout(bh) == ("n" if n == 1 or d == 1 else "d")
    halves = torch.zeros(2, 2 * 3 * d, n)[:, : 3 * d].view(2, 3, d, n).transpose(2, 3)
    assert la.head_layout(halves) == "n"  # q and k as halves of one tensor
    if n > 1 and d > 1:
        with pytest.raises(ValueError, match="contiguous"):
            la.head_layout(nchw, bh)
        with pytest.raises(ValueError, match="contiguous"):
            la.head_layout(torch.zeros(2, 3, d, n).transpose(2, 3)[:, :, ::2])


# --- a numpy transcription of csrc/linear_attention.cu's index arithmetic ---

def tile_of(dst, src, rows, n0, g, eb):
    """(at, rs, ns): element (r, n) of the tile at byte at + r * rs + n * ns."""
    if g.n_fastest:
        return dst + ((src + n0 * eb) & 15), (g.pitch or g.n * eb), eb
    return dst + ((src + n0 * rows * eb) & 15), eb, rows * eb


def fetch_tile(dst, src, rows, n0, length, g, eb):
    """The (shared byte, device byte) of every 16-byte cp.async that fetch_tile issues
    (its thread loop flattened)."""
    if g.n_fastest and g.pitch:
        s0 = src + n0 * eb
        c, nbytes = s0 & 15, length * eb
        per_row = (nbytes + 30) >> 4
        out = []
        for i in range(rows * per_row):
            r, j = divmod(i, per_row)
            s = s0 + r * g.n * eb
            sh = s & 15
            if j < ((sh + nbytes + 15) >> 4):
                out.append((dst + r * g.pitch + c - sh + 16 * j, s - sh + 16 * j))
        return out
    s0 = src if g.n_fastest else src + n0 * rows * eb
    sh = s0 & 15
    chunks = (sh + (g.n if g.n_fastest else length) * rows * eb + 15) >> 4
    return [(dst + 16 * i, s0 - sh + 16 * i) for i in range(chunks)]


def _replay_operand(g, eb, rows, offset, tiles, region, rng, read_rows):
    """Copy one head's operand (``rows`` rows, at ``offset`` elements past a 16-byte
    boundary) tile by tile as the kernel does, and read every element back through
    tile_of. ``region(t)`` gives the shared bytes [lo, hi) that tile t may fill, and
    every read of ``read_rows`` rows (pass 1 reads whole 8-row blocks) stays in it."""
    n = g.n
    src = 16 * 3 + offset * eb
    mem = rng.integers(0, 256, size=src + rows * n * eb + 64, dtype=np.uint8)
    end = src + rows * n * eb
    for t in range(tiles):
        n0 = t * g.tile
        length = min(g.tile, n - n0)
        lo, hi = region(t)
        copies = np.array(fetch_tile(lo, src, rows, n0, length, g, eb), dtype=np.int64)
        dst, dev = copies[:, 0], copies[:, 1]
        # 16-byte aligned at both ends, each chunk holds a byte of the head's span, and
        # no chunk leaves its region or lands twice
        assert (dst % 16 == 0).all() and (dev % 16 == 0).all()
        assert (dev < end).all() and (dev + 16 > src).all()
        assert (dst >= lo).all() and (dst + 16 <= hi).all()
        assert len(np.unique(dst)) == len(dst)
        smem = np.zeros(hi, dtype=np.uint8)
        smem[(dst[:, None] + np.arange(16)).ravel()] = mem[(dev[:, None] + np.arange(16)).ravel()]
        at, rs, ns = tile_of(lo, src, rows, n0, g, eb)
        assert at >= lo and at + (read_rows - 1) * rs + (length - 1) * ns + eb <= hi
        r, p = np.meshgrid(np.arange(rows), np.arange(length), indexing="ij")
        got = at + r * rs + p * ns
        pos = n0 + p
        want = src + eb * (r * n + pos if g.n_fastest else pos * rows + r)
        for b in range(eb):
            np.testing.assert_array_equal(smem[got + b], mem[want + b])


@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("layout", la.LAYOUTS)
@pytest.mark.parametrize("eb", [2, 4])
@pytest.mark.parametrize("n,d,dv", [(49, 24, 24), (784, 24, 24), (3000, 24, 40),
                                    (16, 16, 32), (1, 1, 1), (196, 20, 20)])
def test_transcription_copies_every_element(n, d, dv, eb, layout, offset):
    cfg, g = _geometry(n, d, dv, eb, layout)
    rng = np.random.default_rng(offset)

    def buffer(i):  # staging buffer i's bytes in the team's region
        return (g.buf0, g.buf1) if i % 2 == 0 else (g.buf1, g.kv)

    # pass 1: k and v tile t in buffer t; pass 2: q tile t in buffer tiles + t
    blocks = lambda r: -(-r // la.KV_BLOCK) * la.KV_BLOCK  # noqa: E731
    _replay_operand(g, eb, d, offset, g.tiles,
                    lambda t: (buffer(t)[0], buffer(t)[0] + g.v_off), rng, blocks(d))
    _replay_operand(g, eb, dv, offset, g.tiles,
                    lambda t: (buffer(t)[0] + g.v_off, buffer(t)[1]), rng, blocks(dv))
    _replay_operand(g, eb, d, offset, g.tiles, lambda t: buffer(g.tiles + t), rng, d)


@pytest.mark.parametrize("n,d,dv", SHAPES + [(3000, 24, 40)])
def test_items_cover_kv_and_out_once(n, d, dv):
    """Pass 1's (kv block, split) items cover every kv entry of every position of a
    tile once and its (row, part) items every ksum entry; pass 2's (column block,
    position group) items cover every output of a tile once."""
    _, g = _geometry(n, d, dv, 2, "n")
    nbe = -(-dv // 8)
    kv_items = -(-d // 8) * nbe * g.splits
    for t in range(g.tiles):
        length = min(g.tile, n - t * g.tile)
        count = np.zeros((d, dv + 1, length), dtype=np.int64)  # column dv: ksum
        for it in range(kv_items + d * g.ks_parts):
            if it >= kv_items:
                row, part = divmod(it - kv_items, g.ks_parts)
                count[row, dv, part:length:g.ks_parts] += 1
                continue
            blk, sp = divmod(it, g.splits)
            db, eb = divmod(blk, nbe)
            d0, e0 = 8 * db, 8 * eb
            rows = [d0 + i for i in range(8) if d0 + i < d]
            cols = [e0 + j for j in range(8) if e0 + j < dv]
            count[np.ix_(rows, cols, list(range(sp, length, g.splits)))] += 1
        assert (count == 1).all()
        out = np.zeros((length, dv), dtype=np.int64)
        s = -(-length // la.OUT_ROWS)
        for it in range(-(-dv // 8) * s):
            eb, ns = divmod(it, s)
            for j in range(la.OUT_ROWS):
                if ns + j * s < length:
                    out[ns + j * s, 8 * eb: min(8 * eb + 8, dv)] += 1
        assert (out == 1).all()
