"""The planner of the peeled level's backward kernels KL′1 and KL′2
(``ops/cuda/recconv_level_bwd.py:launch_config``): the warps' bands and column tiles
cover every output once, each band's rings see its halo, the shared layout fits an
H100's 227 KB, the copy chunks follow the rows' alignment, the weight gradient's
partial rows, and its warp reduce-scatter. Plain Python: no kernel runs here."""

import numpy as np
import pytest

from recnext_tpu_torch.ops.cuda import recconv_level_bwd as lbwd
from recnext_tpu_torch.ops.cuda.recconv import MAX_SMEM_BYTES, _axis_plan, pyramid_sizes

# (h, w): odd sizes, planes narrower than a strip, a column tile and a half, the task
# planes, and planes wider than a block's 8 column tiles
PLANES = [(33, 21), (5, 3), (1, 1), (2, 9), (67, 131), (128, 128), (200, 200), (200, 334),
          (7, 1100), (3, 2100)]
KINDS = [("dgrad", 1), ("dgrad", 2), ("wgrad", 1), ("wgrad", 2)]


def _outputs(kind, stride, h, w):
    """The output grid a walk covers: dx's (dgrad) or g's (wgrad)."""
    if kind == "dgrad":
        return h, w
    return (h, w) if stride == 1 else pyramid_sizes(h, w, 1)[1]


@pytest.mark.parametrize("kind,stride", KINDS)
@pytest.mark.parametrize("h,w", PLANES)
@pytest.mark.parametrize("k", [3, 5, 7])
def test_every_output_is_covered_exactly_once(kind, stride, h, w, k):
    cfg = lbwd.launch_config(kind, h, w, k, stride, 6)
    geo = cfg.geometry
    oh, ow = _outputs(kind, stride, h, w)
    p = k // 2
    seen = np.zeros((oh, ow), int)
    for _, _, tile, u0, u1 in lbwd.warp_places(geo, cfg.threads):
        if tile >= geo.tiles or u0 >= u1:
            continue
        cols = np.arange(tile * lbwd.TILE, min((tile + 1) * lbwd.TILE, ow))
        if (kind, stride) == ("dgrad", 2):  # units are pairs of rows 2m - k/2 + {0, 1}
            rows = [r for m in range(u0, u1) for r in (2 * m - p, 2 * m - p + 1)
                    if 0 <= r < oh]
        else:
            rows = range(u0, u1)
        for r in rows:
            seen[r, cols] += 1
    assert (seen == 1).all()
    assert cfg.threads == 32 * geo.tiles_pb * geo.per_block <= 32 * lbwd.MAX_WARPS
    assert geo.tiles_pb * geo.tile_groups >= geo.tiles


@pytest.mark.parametrize("kind,stride", KINDS)
@pytest.mark.parametrize("h,w", [(33, 21), (200, 200), (67, 131), (2, 9)])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_each_bands_ring_sees_its_halo(kind, stride, h, w, k):
    """The rows that pass through a band's ring are every input row its outputs read
    (the band's halo included), each once, and its steps are the kernel's."""
    cfg = lbwd.launch_config(kind, h, w, k, stride, 6)
    geo = cfg.geometry
    p = k // 2
    for _, _, tile, u0, u1 in lbwd.warp_places(geo, cfg.threads):
        if tile >= geo.tiles or u0 >= u1:
            continue
        _, _, halo, _ = lbwd.walk(kind, h, w, k, stride)
        steps = u1 - u0 + halo
        if kind == "dgrad" and stride == 1:  # dz row r reads g rows r - p .. r + p
            streamed = [u0 - p + t for t in range(steps)]
            read = {r + i - p for r in range(u0, u1) for i in range(k)}
        elif kind == "dgrad":  # pair m's rows read coarse rows m - p .. m
            streamed = [u0 - p + t for t in range(steps)]
            read = {(r + p - i) // 2 for m in range(u0, u1) for r in (2 * m - p, 2 * m - p + 1)
                    if 0 <= r < h for i in range(k) if (r + p - i) % 2 == 0}
        elif stride == 1:  # g row r reads z rows r - p .. r + p
            streamed = [u0 - p + t for t in range(steps)]
            read = {r + i - p for r in range(u0, u1) for i in range(k)}
        else:  # g row r reads x rows 2r - p .. 2r + p, two a step
            streamed = [2 * u0 - p + 2 * t + e for t in range(steps) for e in (0, 1)]
            read = {2 * r + i - p for r in range(u0, u1) for i in range(k)}
        assert len(streamed) == len(set(streamed))
        assert read <= set(streamed)
        # no more than the halo's rows beyond what the band reads
        assert len(set(streamed) - read) <= (2 if stride == 2 and kind == "wgrad" else 1) * p
    assert geo.stages in lbwd.STAGES


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("h,w", [(33, 21), (200, 334), (5, 3), (67, 131), (128, 128)])
def test_u_ring_holds_every_coarse_row_a_z_row_reads(h, w, mode):
    """Replays the stride-1 weight gradient's copies of u's coarse rows (the rows up to
    the most that z row r + stages - 1 reads, copied before row r + 1 is built, a step
    ahead) into a ring of ``u_ring_rows`` slots: each built row finds the coarse rows
    it reads. Building a row ahead needs 4 ring rows of x."""
    with pytest.raises(ValueError, match="2 ring rows"):
        lbwd.launch_config("wgrad", h, w, 5, 1, 4, up=True, mode=mode, stages=2)
    cfg = lbwd.launch_config("wgrad", h, w, 5, 1, 4, up=True, mode=mode)
    geo = cfg.geometry
    stages = geo.stages
    assert stages == 4
    assert geo.uring == lbwd.u_ring_rows(h, stages, mode)
    assert geo.uring & (geo.uring - 1) == 0  # the kernel takes a row's slot by a mask
    idx0, idx1, _ = _axis_plan((h + 1) // 2, h, mode)
    for _, _, tile, u0, u1 in lbwd.warp_places(geo, cfg.threads):
        if tile >= geo.tiles or u0 >= u1:
            continue
        z0, steps = u0 - 2, u1 - u0 + 4
        slots = [None] * geo.uring
        nxt = [min(idx0[max(z0, 0)], idx1[max(z0, 0)])]

        def issue(t):
            rho = z0 + t
            if 0 <= rho < h:
                while nxt[0] <= max(idx0[rho], idx1[rho]):
                    slots[nxt[0] % geo.uring] = nxt[0]
                    nxt[0] += 1

        for t in range(min(stages - 1, steps)):
            issue(t)
        for t in range(steps):
            rho = z0 + t
            if 0 <= rho < h:
                for a in (idx0[rho], idx1[rho]):
                    assert slots[a % geo.uring] == a
            if t + stages - 1 < steps:
                issue(t + stages - 1)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("w", [21, 131, 334, 1100])
def test_z_columns_read_only_the_rings_coarse_columns(w, mode):
    idx0, idx1, _ = _axis_plan((w + 1) // 2, w, mode)
    for c0 in range(0, w, lbwd.TILE):
        cols = np.arange(max(c0 - 3, 0), min(c0 + lbwd.TILE + 3, w))
        lo = c0 // 2 - lbwd.PAD
        for idx in (idx0, idx1):
            assert lo <= idx[cols].min() and idx[cols].max() < lo + lbwd.ROWC
    assert lbwd._u_columns_fit(9, w, mode, 7)
    cfg = lbwd.launch_config("wgrad", 9, w, 7, 1, 2, up=True, mode=mode)
    assert cfg.geometry.plan_off + 2 * (9 + w) <= cfg.geometry.sums_off
    with pytest.raises(ValueError, match="16-bit plans"):
        lbwd.launch_config("wgrad", 3, 1 << 17, 5, 1, 1, up=True)


@pytest.mark.parametrize("kind,stride", KINDS)
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("a_bytes,b_bytes", [(4, 4), (2, 2), (2, 4), (4, 2)])
@pytest.mark.parametrize("h,w", [(128, 128), (200, 334), (33, 21), (3, 4000)])
def test_shared_bytes_fit_and_regions_do_not_overlap(kind, stride, k, a_bytes, b_bytes, h, w):
    for up in ((False, True) if (kind, stride) == ("wgrad", 1) else (False,)):
        cfg = lbwd.launch_config(kind, h, w, k, stride, 64, a_bytes=a_bytes, b_bytes=b_bytes,
                                 up=up)
        geo = cfg.geometry
        assert cfg.smem_bytes <= MAX_SMEM_BYTES and cfg.resident_blocks >= 1
        slot = {("dgrad", 1): lbwd.ROW1, ("dgrad", 2): lbwd.ROWC,
                ("wgrad", 1): lbwd.ROW1, ("wgrad", 2): 2 * lbwd.ROW2}[kind, stride]
        regions = [(geo.a_off, geo.stages * slot * a_bytes / 4)]
        if kind == "wgrad":
            g_rows = geo.gring if stride == 1 else geo.stages
            regions.append((geo.b_off, g_rows * lbwd.TILE * b_bytes / 4))
            if stride == 1:  # the row copied ahead never overwrites one the taps read
                assert geo.gring >= k + geo.stages - 2 and geo.gring & (geo.gring - 1) == 0
        if up:
            regions += [(geo.u_off, geo.uring * lbwd.ROWC), (geo.z_off, 2 * lbwd.ROW1)]
        end = 0
        for off, words in sorted(regions):  # 16-byte aligned, in order, inside the warp's
            assert off % 4 == 0 and off >= end
            end = off + words
        assert end <= geo.warp_words and geo.warp_words % 4 == 0
        warps = cfg.threads // 32
        assert geo.plan_off == warps * geo.warp_words
        assert geo.sums_off >= geo.plan_off + (2 * (h + w) if up else 0)
        sums = warps * (32 if k * k <= 32 else 64) if kind == "wgrad" else 0
        assert cfg.smem_bytes == 4 * (geo.sums_off + sums)


def test_the_band_fills_the_card_and_the_ring_keeps_the_blocks_an_sm_holds():
    # fp32, batch 16, C = 64 (the task planes): a wave or two of warps, long bands
    for h in (128, 200):
        for kind, stride in KINDS:
            cfg = lbwd.launch_config(kind, h, h, 5, stride, 1024, regs=80)
            geo = cfg.geometry
            unit = 2 if (kind, stride) == ("dgrad", 2) else 1
            warps = 1024 * -(-geo.rows // geo.band) * geo.tiles
            assert warps <= 2 * lbwd.SMS * 25 and geo.band * unit >= 20
            # the blocks leave no more than a block's warps without a band
            bands = -(-geo.rows // geo.band)
            assert cfg.blocks_per_plane * geo.per_block - bands < geo.per_block
            for ns in (s for s in lbwd.STAGES if s > geo.stages):  # deeper holds fewer
                deeper = lbwd.launch_config(kind, h, h, 5, stride, 1024, regs=80, stages=ns)
                assert deeper.resident_blocks < cfg.resident_blocks
    # a batch-2 plane cannot fill the card: the shortest bands
    cfg = lbwd.launch_config("dgrad", 128, 128, 5, 1, 96)
    assert cfg.geometry.band == lbwd.MIN_BAND
    # the band and ring depth the phase tool sweeps
    cfg = lbwd.launch_config("wgrad", 200, 200, 5, 2, 1024, band=25, stages=2)
    assert (cfg.geometry.band, cfg.geometry.stages) == (25, 2)


@pytest.mark.parametrize("width,elem,align,want", [
    (200, 4, 16, 16), (334, 4, 16, 8), (167, 4, 16, 4), (334, 2, 16, 4), (333, 2, 16, 0),
    (128, 2, 16, 16), (200, 4, 4, 4), (200, 4, 8, 8), (128, 2, 2, 0)])
def test_copy_chunks_follow_the_rows_alignment(width, elem, align, want):
    assert lbwd.chunk_bytes(width, elem, align) == want


def test_geometry_carries_the_chunks_and_the_vector_stores():
    cfg = lbwd.launch_config("wgrad", 200, 333, 5, 1, 4, a_bytes=2, b_bytes=2, up=True)
    assert (cfg.geometry.chunk_a, cfg.geometry.chunk_b, cfg.geometry.chunk_u) == (0, 0, 4)
    cfg = lbwd.launch_config("wgrad", 200, 334, 5, 2, 4, a_bytes=4, b_bytes=2)
    assert (cfg.geometry.chunk_a, cfg.geometry.chunk_b) == (8, 0)  # g 100 x 167 bf16
    assert lbwd.launch_config("dgrad", 128, 128, 5, 2, 4).geometry[-2:] == (0, 1)
    assert lbwd.launch_config("dgrad", 33, 21, 5, 1, 4).geometry.vec == 0
    assert lbwd.launch_config("dgrad", 128, 128, 5, 1, 4, align=8).geometry.vec == 0
    assert len(lbwd.Geometry._fields) == 22


@pytest.mark.parametrize("n,c,h,w,k,stride", [(16, 64, 200, 200, 5, 1), (2, 48, 200, 334, 5, 2),
                                             (2, 3, 33, 21, 7, 1), (1, 2, 3, 2100, 3, 2)])
def test_the_partial_buffer_has_one_row_per_plane_and_block(n, c, h, w, k, stride):
    cfg = lbwd.launch_config("wgrad", h, w, k, stride, n * c)
    shape = lbwd.partial_shape(n, c, k, cfg)
    assert shape == (c, n * cfg.blocks_per_plane, k * k)
    geo = cfg.geometry
    bands = -(-geo.rows // geo.band)
    assert cfg.blocks_per_plane == -(-bands // geo.per_block) * geo.tile_groups
    # every (plane, block) holds a warp with work, so no partial row is left unwritten
    busy = {bp for bp, _, tile, u0, u1 in lbwd.warp_places(geo, cfg.threads)
            if tile < geo.tiles and u0 < u1}
    assert busy == set(range(cfg.blocks_per_plane))


def _reduce_scatter(acc, npad):
    """csrc: scatter_stage over 32 lanes of acc (32, npad)."""
    lanes = np.arange(32)
    v, m = acc.copy(), npad
    for o in (16, 8, 4, 2, 1):
        upper = (lanes & o) != 0
        half = m // 2
        send = np.where(upper[:, None], v[:, :half], v[:, half:m])
        keep = np.where(upper[:, None], v[:, half:m], v[:, :half])
        v[:, :half] = keep + send[lanes ^ o]
        m = half
    return v[:, :npad // 32]


@pytest.mark.parametrize("k", [3, 5, 7])
def test_the_reduce_scatter_gives_each_lane_its_entries(k):
    kk, npad = k * k, (32 if k * k <= 32 else 64)
    acc = np.zeros((32, npad))
    acc[:, :kk] = np.arange(32)[:, None] * 1000.0 + np.arange(kk)[None, :]  # exact sums
    held = _reduce_scatter(acc, npad)
    per = npad // 32
    for lane in range(32):
        for t in range(per):
            e = lane * per + t
            want = acc[:, e].sum() if e < kk else 0.0
            assert held[lane, t] == want
