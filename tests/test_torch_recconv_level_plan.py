"""A peeled level's forward kernel (``csrc/recconv_level_bwd.cu:recconv_level_kernel``)
and the up-step's adjoint (``recconv_up_adjoint_kernel``) on the CPU: their planner's
new kinds (``ops/cuda/recconv_level_bwd.py:launch_config`` "level" and "up_adjoint":
every output covered once, each band's ring sees its halo, the adjoint's fed ring holds
every fine row a coarse row reads, the shared regions fit and do not overlap, the copy
chunks follow the rows' alignment), and numpy transcriptions of the three walks (the
down conv, the upsample-add-conv with and without u, the adjoint's band walk with its
fed ring), each following the kernel's bands, rings and tap or fan order, held against
the plain versions (``rec_conv2d_level_plain``, ``rec_conv2d_up_adjoint_plain``; those
stay held against JAX's ``rec_conv2d`` by ``tests/test_torch_ops.py``). Plain Python
and numpy: no kernel runs here."""

import numpy as np
import pytest
import torch

from recnext_tpu_torch.ops.cuda import recconv_bwd as bwd
from recnext_tpu_torch.ops.cuda import recconv_level_bwd as lbwd
from recnext_tpu_torch.ops.cuda.recconv import MAX_SMEM_BYTES, lerp_plan_table, pyramid_sizes
from recnext_tpu_torch.ops.recconv import (
    rec_conv2d_level,
    rec_conv2d_level_plain,
    rec_conv2d_up_adjoint_plain,
)
from tests.test_torch_recconv_peel_bwd import _fma, _ring_row, _windows, _z_row

LANES = np.arange(32)
F32_TOL, BF16_TOL = 2e-5, 1e-2  # x max|ref|: K1's bounds in f32 and in bf16 out

# (h, w): odd sizes, planes narrower than a strip, a tile and a half, COCO's 200x334 and
# its second peeled level's 100x167, planes wider than a block's 8 column tiles
PLANES = [(33, 21), (5, 3), (1, 1), (2, 9), (67, 131), (128, 128), (200, 334), (100, 167),
          (7, 1100), (3, 2100)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _outputs(kind, stride, h, w):
    if kind == "up_adjoint" or stride == 2:
        return pyramid_sizes(h, w, 1)[1]
    return h, w


def _busy(cfg):
    return [p for p in lbwd.warp_places(cfg.geometry, cfg.threads)
            if p[2] < cfg.geometry.tiles and p[3] < p[4]]


# ---- the planner ----------------------------------------------------------------------

@pytest.mark.parametrize("kind,stride,k", [("level", 1, 3), ("level", 1, 5), ("level", 1, 7),
                                           ("level", 2, 3), ("level", 2, 5), ("level", 2, 7),
                                           ("up_adjoint", 1, 0)])
@pytest.mark.parametrize("h,w", PLANES)
def test_every_output_is_covered_exactly_once(kind, stride, k, h, w):
    for up in (False, True) if (kind, stride) == ("level", 1) else (False,):
        cfg = lbwd.launch_config(kind, h, w, k, stride, 6, up=up)
        geo = cfg.geometry
        oh, ow = _outputs(kind, stride, h, w)
        seen = np.zeros((oh, ow), int)
        for _, _, tile, u0, u1 in _busy(cfg):
            seen[u0:u1, tile * lbwd.TILE:(tile + 1) * lbwd.TILE] += 1
        assert (seen == 1).all()
        assert cfg.threads == 32 * geo.tiles_pb * geo.per_block <= 32 * lbwd.MAX_WARPS
        assert geo.stages in lbwd.STAGES and geo.row0 == 0


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w", [(33, 21), (200, 200), (67, 131), (2, 9)])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_each_bands_ring_sees_its_halo(stride, h, w, k):
    """The x (z) rows that pass through a band's ring are every row its outputs read,
    each once, and no more than the halo's beyond them."""
    cfg = lbwd.launch_config("level", h, w, k, stride, 6)
    p = k // 2
    _, _, halo, _ = lbwd.walk("level", h, w, k, stride)
    for _, _, _, u0, u1 in _busy(cfg):
        steps = u1 - u0 + halo
        if stride == 1:  # output row r reads z rows r - p .. r + p
            streamed = [u0 - p + t for t in range(steps)]
        else:  # output row r reads x rows 2r - p .. 2r + p, two a step
            streamed = [2 * u0 - p + 2 * t + e for t in range(steps) for e in (0, 1)]
        read = {stride * r + i - p for r in range(u0, u1) for i in range(k)}
        assert len(streamed) == len(set(streamed)) and read <= set(streamed)
        assert len(set(streamed) - read) <= stride * p


def _fine_rows(h, mode):
    """Per coarse row of the up-step ceil(h/2) -> h, the fine rows that read it with a
    weight (the transposed row plan's entries)."""
    idx, wts = bwd.transposed_axis_plan((h + 1) // 2, h, mode)
    return [sorted(int(i) for i, wt in zip(idx[a], wts[a]) if wt != 0) for a in range(len(idx))]


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("stages", lbwd.STAGES)
@pytest.mark.parametrize("h,w", [(33, 21), (200, 334), (100, 167), (5, 3), (67, 131),
                                 (128, 128), (1, 1), (2, 9)])
def test_fed_ring_holds_every_fine_row_a_coarse_row_reads(h, w, mode, stages):
    """Replays the adjoint's copies: step t takes the column sums of the fine rows up to
    the last that coarse row u0 + t reads from the ring into slots row % MAX_FAN, reads
    its rows' sums, then copies the fine rows up to the last that coarse row u0 + t +
    stages - 1 reads into slots row % gring; every row is in its ring slot when summed,
    every row a coarse row reads (at most MAX_FAN consecutive rows) has its sums in
    their slot when read, and each fine row is copied and summed once a band."""
    cfg = lbwd.launch_config("up_adjoint", h, w, 0, 1, 4, mode=mode, stages=stages)
    geo = cfg.geometry
    assert geo.gring == lbwd.fine_ring_rows(h, stages, mode)
    assert geo.gring & (geo.gring - 1) == 0  # the kernel takes a row's slot by a mask
    reads = _fine_rows(h, mode)
    assert all(r == list(range(r[0], r[0] + len(r))) and len(r) <= bwd.MAX_FAN
               for r in reads)  # every coarse row is read by a run of fine rows
    for _, _, _, u0, u1 in _busy(cfg):
        slots, sums, copied, summed, nxt = [None] * geo.gring, [None] * bwd.MAX_FAN, [], [], \
            [reads[u0][0]]

        def issue(t):
            while nxt[0] <= reads[u0 + t][-1]:
                slots[nxt[0] % geo.gring] = nxt[0]
                copied.append(nxt[0])
                nxt[0] += 1

        steps = u1 - u0
        for t in range(min(stages - 1, steps)):
            issue(t)
        for t in range(steps):
            for r in range(summed[-1] + 1 if summed else reads[u0][0], reads[u0 + t][-1] + 1):
                assert slots[r % geo.gring] == r
                sums[r % bwd.MAX_FAN] = r
                summed.append(r)
            assert all(sums[r % bwd.MAX_FAN] == r for r in reads[u0 + t])
            if t + stages - 1 < steps:
                issue(t + stages - 1)
        assert copied == summed == list(range(reads[u0][0], reads[u1 - 1][-1] + 1))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("w", [1, 9, 21, 167, 334, 1100])
def test_adjoint_reads_only_the_rings_fine_columns(w, mode):
    idx, wts = bwd.transposed_axis_plan((w + 1) // 2, w, mode)
    for b0 in range(0, len(idx), lbwd.TILE):
        used = idx[b0:b0 + lbwd.TILE][wts[b0:b0 + lbwd.TILE] != 0]
        assert 2 * b0 - lbwd.PAD <= used.min() and used.max() < 2 * b0 - lbwd.PAD + lbwd.ROW2
    assert lbwd._adjoint_columns_fit(w, mode)


# (kind, stride, up, k, x bytes, y bytes): the forward at k 3/5/7 and its dtypes (bf16
# x with f32 y: the down conv), the adjoint (fp32)
LAYOUTS = [("level", stride, up, k, a, b) for stride, up in ((1, False), (1, True), (2, False))
           for k in (3, 5, 7) for a, b in ((4, 4), (2, 2), (2, 4))
           if stride == 2 or a == b] + [("up_adjoint", 1, False, 0, 4, 4)]


@pytest.mark.parametrize("kind,stride,up,k,a_bytes,b_bytes", LAYOUTS)
@pytest.mark.parametrize("h,w", [(128, 128), (200, 334), (33, 21), (3, 4000)])
def test_shared_bytes_fit_and_regions_do_not_overlap(kind, stride, up, k, a_bytes, b_bytes, h,
                                                     w):
    cfg = lbwd.launch_config(kind, h, w, k, stride, 64, a_bytes=a_bytes, b_bytes=b_bytes,
                             up=up)
    geo = cfg.geometry
    assert cfg.smem_bytes <= MAX_SMEM_BYTES and cfg.resident_blocks >= 1
    if kind == "up_adjoint":
        regions = [(geo.a_off, geo.gring * lbwd.ROW2),
                   (geo.b_off, bwd.MAX_FAN * lbwd.TILE)]  # the fine rows' column sums
        plan_words = 2 * bwd.MAX_FAN * sum(pyramid_sizes(h, w, 1)[1])
    else:
        slot = lbwd.ROW1 if stride == 1 else 2 * lbwd.ROW2
        regions = [(geo.a_off, geo.stages * slot * a_bytes / 4)]
        if up:
            regions += [(geo.u_off, geo.uring * lbwd.ROWC), (geo.z_off, 2 * lbwd.ROW1)]
            assert geo.stages == lbwd.MAX_STAGES and geo.uring == lbwd.u_ring_rows(
                h, geo.stages, "bilinear")
        plan_words = 2 * (h + w) if up else 0
    end = 0
    for off, words in sorted(regions):  # 16-byte aligned, in order, inside the warp's
        assert off % 4 == 0 and off >= end
        end = off + words
    assert end <= geo.warp_words and geo.warp_words % 4 == 0
    assert geo.plan_off == (cfg.threads // 32) * geo.warp_words
    assert geo.plan_off + plan_words <= geo.sums_off and cfg.smem_bytes == 4 * geo.sums_off


def test_copy_chunks_and_vector_stores_follow_the_rows():
    cfg = lbwd.launch_config("level", 200, 334, 5, 2, 4, a_bytes=2)  # y 100 x 167 f32
    assert (cfg.geometry.chunk_a, cfg.geometry.vec) == (4, 0)
    cfg = lbwd.launch_config("level", 200, 333, 5, 1, 4, a_bytes=2, b_bytes=2, up=True)
    assert (cfg.geometry.chunk_a, cfg.geometry.chunk_u, cfg.geometry.vec) == (0, 4, 0)
    cfg = lbwd.launch_config("level", 160, 160, 5, 1, 4, a_bytes=2, b_bytes=2, up=True)
    assert (cfg.geometry.chunk_a, cfg.geometry.chunk_u, cfg.geometry.vec) == (16, 16, 1)
    assert lbwd.launch_config("level", 128, 128, 5, 2, 4, align=4).geometry[-4:] == (4, 0, 0, 0)
    cfg = lbwd.launch_config("up_adjoint", 100, 167, 0, 1, 4)
    assert (cfg.geometry.chunk_a, cfg.geometry.vec) == (4, 0)
    assert lbwd.launch_config("up_adjoint", 200, 200, 0, 1, 4).geometry.chunk_a == 16
    with pytest.raises(ValueError, match="only in the stride-1"):
        lbwd.launch_config("level", 64, 64, 5, 2, 4, up=True)
    with pytest.raises(ValueError, match="not supported"):
        lbwd.launch_config("up_adjoint", 64, 64, 0, 2, 4)


def test_the_band_fills_the_card():
    # fp32, batch 16, C = 64 (the task planes): a wave or two of warps, long bands
    for h in (128, 200):
        for kind, stride, up, k in (("level", 2, False, 5), ("level", 1, True, 5),
                                    ("up_adjoint", 1, False, 0)):
            cfg = lbwd.launch_config(kind, h, h, k, stride, 1024, regs=80, up=up)
            geo = cfg.geometry
            warps = 1024 * -(-geo.rows // geo.band) * geo.tiles
            assert warps <= 2 * lbwd.SMS * 25 and geo.band >= 10
            bands = -(-geo.rows // geo.band)
            assert cfg.blocks_per_plane * geo.per_block - bands < geo.per_block


# ---- numpy transcriptions (the ring, window and z helpers are KL′1-2's) -----------------

def transcribe_level(x, w, stride, u=None, mode="bilinear"):
    """recconv_level_kernel: each warp walks its band of output rows down its column
    tile; x rows (a pair a step at stride 2) land in a ring of `stages` slots (NaN where
    nothing was copied), z = x + up(u) is built a row ahead into two rows from the x ring
    and a ring of u's coarse rows; a lane's window is read once a row, and a ring of
    output rows of 4 sums (k at stride 1, k/2 + 1 at stride 2) takes the taps in the
    kernel's order, written when whole: each output exactly once. Returns fp32 sums."""
    n, c, h, wd = x.shape
    k = w.shape[-1]
    p = k // 2
    planes = n * c
    up = u is not None
    cfg = lbwd.launch_config("level", h, wd, k, stride, planes, up=up, mode=mode)
    geo = cfg.geometry
    ns, ahead = geo.stages, geo.stages - 1
    xp = x.reshape(planes, h, wd)
    wk = np.tile(w.reshape(c, k * k), (n, 1))[:, :, None, None]
    oh, ow = _outputs("level", stride, h, wd)
    y = np.full((planes, oh, ow), np.nan, np.float32)
    uh, uw = pyramid_sizes(h, wd, 1)[1]
    upl = u.reshape(planes, uh, uw) if up else None
    table = lerp_plan_table(h, wd, 1, mode)[0] if up else None
    s4 = np.arange(lbwd.STRIP)

    def store(r, q, acc):
        for s in range(lbwd.STRIP):
            cols = q[q + s < ow] + s
            assert np.isnan(y[:, r, cols]).all()  # each output written once
            y[:, r, cols] = acc[:, q + s < ow, s]

    for _, _, tile, u0, u1 in _busy(cfg):
        c0 = tile * lbwd.TILE
        q = c0 + lbwd.STRIP * LANES
        if stride == 2:
            x0, steps, rr = 2 * u0 - p, u1 - u0 + p, p + 1
            ng = (14 + p) // 4
            xring = np.full((planes, ns, 2, lbwd.ROW2), np.nan, np.float32)

            def issue(t):
                for e in range(2):
                    rho = x0 + 2 * t + e
                    xring[:, t % ns, e] = _ring_row(xp, rho if 0 <= rho < h else None,
                                                    2 * c0 - lbwd.PAD, lbwd.ROW2, wd)

            for t in range(min(ahead, steps)):
                issue(t)
            acc = np.zeros((rr, planes, 32, lbwd.STRIP), np.float32)
            for t in range(steps):
                v = t % rr
                if t + ahead < steps:
                    issue(t + ahead)
                for e in range(2):
                    win = _windows(xring[:, t % ns, e], 2 * lbwd.STRIP * LANES + lbwd.PAD - 4,
                                   4 * ng)
                    for d in range(p + 1):
                        if 2 * d + e < k:
                            for j in range(k):
                                acc[(v - d) % rr] = _fma(wk[:, (2 * d + e) * k + j],
                                                         win[:, :, 4 + 2 * s4 + j - p],
                                                         acc[(v - d) % rr])
                if u0 + t - p >= u0:
                    store(u0 + t - p, q, acc[(v + 1) % rr])
                acc[(v + 1) % rr] = 0.0
        else:
            z0, steps = u0 - p, u1 - u0 + 2 * p
            xring = np.full((planes, ns, lbwd.ROW1), np.nan, np.float32)
            uring = np.full((planes, max(geo.uring, 1), lbwd.ROWC), np.nan, np.float32)
            zrows = np.full((planes, 2, lbwd.ROW1), np.nan, np.float32)
            nxt = [min(table[max(z0, 0), :2])] if up else [0]

            def issue(t):
                rho = z0 + t
                inside = 0 <= rho < h
                xring[:, t % ns] = _ring_row(xp, rho if inside else None, c0 - lbwd.PAD,
                                             lbwd.ROW1, wd)
                if up and inside:
                    while nxt[0] <= max(table[rho, :2]):
                        uring[:, nxt[0] % geo.uring] = _ring_row(
                            upl, nxt[0], c0 // 2 - lbwd.PAD, lbwd.ROWC, uw)
                        nxt[0] += 1

            def build(t):  # z row z0 + t, a step ahead, into zrows[t % 2]
                zrows[:, t % 2] = _z_row(xring[:, t % ns], uring, table, z0 + t, h, wd, c0,
                                         c0 // 2 - lbwd.PAD, geo.uring, p)

            for t in range(min(ahead, steps)):
                issue(t)
            if up:
                build(0)
            acc = np.zeros((k, planes, 32, lbwd.STRIP), np.float32)
            for t in range(steps):
                v = t % k
                row = zrows[:, t % 2] if up else xring[:, t % ns]
                win = _windows(row, lbwd.STRIP * LANES + lbwd.PAD - 4, 12)
                if t + ahead < steps:
                    issue(t + ahead)
                if up:
                    build(t + 1)
                for i in range(k):
                    for j in range(k):
                        acc[(v - i) % k] = _fma(wk[:, i * k + j], win[:, :, 4 + s4 + j - p],
                                                acc[(v - i) % k])
                if u0 + t - 2 * p >= u0:
                    store(u0 + t - 2 * p, q, acc[(v + 1) % k])
                acc[(v + 1) % k] = 0.0
    return y.reshape(n, c, oh, ow)


def direct_level(x, w, stride, u=None, mode="bilinear"):
    """The simple form's arithmetic: every output sums its k x k taps from zero in the
    order tap row, then tap column (fmaf), on z = x + up(u) built with the same lerps."""
    n, c, h, wd = x.shape
    k = w.shape[-1]
    p = k // 2
    z = x.astype(np.float32)
    if u is not None:
        table = lerp_plan_table(h, wd, 1, mode)[0]
        rp, cp = table[:h], table[h:]
        t0, t1 = u[:, :, rp[:, 0]], u[:, :, rp[:, 1]]
        wr = rp[:, 2].view(np.float32)[:, None]
        wc = cp[:, 2].view(np.float32)
        left = t0[..., cp[:, 0]] + (t1[..., cp[:, 0]] - t0[..., cp[:, 0]]) * wr
        right = t0[..., cp[:, 1]] + (t1[..., cp[:, 1]] - t0[..., cp[:, 1]]) * wr
        z = z + (left + (right - left) * wc)
    zp = np.pad(z, ((0, 0), (0, 0), (p, p), (p, p)))
    oh, ow = _outputs("level", stride, h, wd)
    acc = np.zeros((n, c, oh, ow), np.float32)
    for i in range(k):
        for j in range(k):
            tap = zp[:, :, i:i + stride * oh:stride, j:j + stride * ow:stride]
            acc = _fma(w[:, 0, i, j][None, :, None, None], tap, acc)
    return acc


# (h, w, k, stride, mode of u or None, x dtype): odd sizes, more than one tile a side,
# planes narrower than a tile, COCO's 200x334 and its second peeled level's 100x167, k
# 3/5/7, both modes, f32 and bf16 x
LEVEL_CASES = [(33, 21, 5, 2, None, "f32"), (33, 21, 5, 1, "bilinear", "f32"),
               (67, 45, 3, 2, None, "bf16"), (67, 45, 7, 1, "nearest", "f32"),
               (40, 300, 7, 2, None, "f32"), (40, 300, 3, 1, "bilinear", "bf16"),
               (5, 3, 5, 2, None, "f32"), (5, 3, 5, 1, "nearest", "bf16"),
               (1, 9, 3, 2, None, "f32"), (21, 17, 5, 1, None, "f32"),
               (200, 334, 5, 2, None, "bf16"), (200, 334, 5, 1, "bilinear", "f32"),
               (100, 167, 5, 2, None, "f32"), (100, 167, 5, 1, "nearest", "bf16"),
               (9, 270, 7, 1, None, "bf16")]


@pytest.mark.parametrize("h,w,k,stride,mode,xdt", LEVEL_CASES)
def test_level_transcription_matches_plain(h, w, k, stride, mode, xdt):
    rng = np.random.default_rng(h * w + k + stride)
    planes = 1 if h * w > 20000 else 2
    x = torch.from_numpy(rng.normal(size=(1, planes, h, w)).astype(np.float32))
    if xdt == "bf16":
        x = x.bfloat16()
    wt = rng.normal(size=(planes, 1, k, k)).astype(np.float32) / k
    uh, uw = pyramid_sizes(h, w, 1)[1]
    u = rng.normal(size=(1, planes, uh, uw)).astype(np.float32) if mode else None
    kw = dict(stride=stride, up=None if u is None else torch.from_numpy(u),
              mode=mode or "bilinear")
    xf = x.float().numpy()
    got = transcribe_level(xf, wt, stride, u, mode or "bilinear")
    assert not np.isnan(got).any()
    # the walk keeps every output's order of taps: the simple form's bits
    np.testing.assert_array_equal(got, direct_level(xf, wt, stride, u, mode or "bilinear"))
    want = rec_conv2d_level_plain(x, torch.from_numpy(wt), **kw)
    if want.dtype == torch.float32:
        scale = want.abs().max().item()
        assert np.abs(got - want.numpy()).max() <= F32_TOL * scale
    else:  # rounded once to bf16, as the kernel stores it
        out = torch.from_numpy(got).bfloat16().float()
        scale = want.float().abs().max().item()
        assert (out - want.float()).abs().max().item() <= BF16_TOL * scale
    # the wrapper on a CPU tensor is the plain version
    torch.testing.assert_close(rec_conv2d_level(x, torch.from_numpy(wt), **kw), want,
                               rtol=0, atol=0)


def transcribe_up_adjoint_walk(dz, mode):
    """recconv_up_adjoint_kernel: each warp walks its band of coarse rows down its tile
    of 128 coarse columns, lane l taking columns l + 32 s; the fine rows the band reads
    are copied into a ring of `gring` slots (NaN where nothing was copied) as the row
    plans name them, up to the last that coarse row u0 + t + stages - 1 reads after step
    t; each lane's column entries are its ring offsets and weights; each fine row's
    column sums (its weighted values in the columns' order, fmaf, zero weights skipped)
    are taken once, when a coarse row first reads it, into MAX_FAN rows (NaN where none
    was taken), and each coarse row adds its rows' sums times their weights."""
    n, c, h, wd = dz.shape
    planes = n * c
    uh, uw = pyramid_sizes(h, wd, 1)[1]
    cfg = lbwd.launch_config("up_adjoint", h, wd, 0, 1, planes, mode=mode)
    geo = cfg.geometry
    ahead, rr, fan = geo.stages - 1, geo.gring, bwd.MAX_FAN
    table = bwd.transposed_plan_table(h, wd, 1, mode)[0]
    rows = table[:uh * fan].reshape(uh, fan, 2)
    cols = table[uh * fan:].reshape(uw, fan, 2)
    zp = dz.reshape(planes, h, wd)
    du = np.full((planes, uh, uw), np.nan, np.float32)

    def last(a):
        return max((int(rows[a, e, 0]) for e in range(fan) if rows[a, e, 1] != 0), default=-1)

    for _, _, tile, u0, u1 in _busy(cfg):
        b = tile * lbwd.TILE + LANES[:, None] + 32 * np.arange(lbwd.STRIP)[None, :]
        fcol0 = 2 * tile * lbwd.TILE - lbwd.PAD
        ce = cols[np.minimum(b, uw - 1)]
        wc = ce[..., 1].copy().view(np.float32)
        off = np.where(wc != 0, ce[..., 0] - fcol0, 0)
        assert ((off >= 0) & (off < lbwd.ROW2)).all()
        ring = np.full((planes, rr, lbwd.ROW2), np.nan, np.float32)
        sums = np.full((planes, fan, 32, lbwd.STRIP), np.nan, np.float32)
        nxt, summed = [int(rows[u0, 0, 0])], int(rows[u0, 0, 0])

        def issue(t):
            while nxt[0] <= last(u0 + t):
                ring[:, nxt[0] % rr] = _ring_row(zp, nxt[0], fcol0, lbwd.ROW2, wd)
                nxt[0] += 1

        steps = u1 - u0
        for t in range(min(ahead, steps)):
            issue(t)
        for t in range(steps):
            a = u0 + t
            while summed <= last(a):  # each fine row's column sums once
                fr = ring[:, summed % rr]
                row = np.zeros((planes, 32, lbwd.STRIP), np.float32)
                for f in range(fan):
                    row = np.where(wc[:, :, f] != 0, _fma(wc[:, :, f], fr[:, off[:, :, f]], row),
                                   row)
                sums[:, summed % fan] = row
                summed += 1
            acc = np.zeros((planes, 32, lbwd.STRIP), np.float32)
            for e in range(fan):
                wr = rows[a, e, 1:2].view(np.float32)[0]
                if wr != 0:
                    acc = _fma(wr, sums[:, rows[a, e, 0] % fan], acc)
            if t + ahead < steps:
                issue(t + ahead)
            for s in range(lbwd.STRIP):
                ok = b[:, s] < uw
                assert np.isnan(du[:, a, b[ok, s]]).all()  # each output written once
                du[:, a, b[ok, s]] = acc[:, ok, s]
    return du.reshape(n, c, uh, uw)


def direct_up_adjoint(dz, mode):
    """The simple form's arithmetic, element by element: for each fine row with a
    weight, its columns' weighted values from zero in order (fmaf), then times the row's
    weight, from zero in order of the rows."""
    n, c, h, wd = dz.shape
    uh, uw = pyramid_sizes(h, wd, 1)[1]
    ri, rw = bwd.transposed_axis_plan(uh, h, mode)
    ci, cw = bwd.transposed_axis_plan(uw, wd, mode)
    du = np.zeros((n, c, uh, uw), np.float32)
    for e in range(bwd.MAX_FAN):
        row = np.zeros_like(du)
        for f in range(bwd.MAX_FAN):
            v = dz[:, :, ri[:, e][:, None], ci[:, f][None, :]]
            row = np.where(cw[:, f] != 0, _fma(cw[:, f], v, row), row)
        du = np.where(rw[:, e, None] != 0, _fma(rw[:, e, None], row, du), du)
    return du


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("h,w", [(128, 128), (200, 334), (100, 167), (33, 21), (7, 2),
                                 (1, 1), (2, 9), (5, 1100)])
def test_up_adjoint_walk_transcription_matches_plain(h, w, mode):
    rng = np.random.default_rng(h + 3 * w)
    dz = rng.normal(size=(1, 2, h, w)).astype(np.float32)
    want = rec_conv2d_up_adjoint_plain(torch.from_numpy(dz), mode=mode).numpy()
    got = transcribe_up_adjoint_walk(dz, mode)
    assert not np.isnan(got).any()
    # each fine row's column sums taken once: the simple form's bits
    np.testing.assert_array_equal(got, direct_up_adjoint(dz, mode))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= F32_TOL * scale
