"""The host side of the RecConv2d backward kernel (K1', ``csrc/recconv_bwd.cu``), on
the CPU: the launch configuration (team size, teams per block, shared-memory layout)
that the kernel reads as its geometry, the order in which a block's teams take the
planes of one channel, the weight-gradient partials and a numpy transcription of the
kernel's fixed-order reduction (a reduce-scatter over each fragment's lanes, one row
per fragment, the rows in order, the groups in order) against the dense sum."""

import numpy as np
import pytest

from recnext_tpu_torch.ops.cuda import recconv_bwd as bwd
from recnext_tpu_torch.ops.cuda.recconv import MAX_LEVEL, STRIP

LEVELS = MAX_LEVEL + 1
# csrc/recconv_bwd.cu:Geometry: level, ten arrays of one entry per level, then these
TAIL = ("team_words", "wts", "slots", "fplan", "bplan", "fplan_words", "bplan_words")
ARRAYS = ("h", "w", "pitch", "f", "hb", "gb", "frows", "fcols", "brows", "bcols")
# recnext_m1's four mixer planes at 224^2: (side, level) -> team size
M1_TEAMS = {(56, 4): 128, (28, 3): 64, (14, 2): 16, (7, 1): 8}


def _fields(cfg):
    g = list(cfg.geometry)
    assert len(g) == 1 + len(ARRAYS) * LEVELS + len(TAIL)
    out = {"level": g[0]}
    for i, name in enumerate(ARRAYS):
        out[name] = g[1 + i * LEVELS:1 + (i + 1) * LEVELS]
    out.update(zip(TAIL, g[1 + len(ARRAYS) * LEVELS:]))
    return out


@pytest.mark.parametrize("side,level", M1_TEAMS)
def test_team_size_and_teams_per_block_at_the_m1_planes(side, level):
    cfg = bwd.launch_config(side, side, level, 5)
    assert cfg.team == M1_TEAMS[side, level]
    assert cfg.planes_per_block * cfg.team == bwd.BLOCK_THREADS


def _resident(smem_bytes):
    """Blocks of ``smem_bytes`` dynamic shared memory and 256 threads that one H100 SM
    holds: its 228 KB, less the 1 KB the runtime keeps for each block; 2048 threads."""
    return min(233472 // (smem_bytes + 1024), 2048 // bwd.BLOCK_THREADS)


@pytest.mark.parametrize("side,level,planes", [(56, 4, 4), (28, 3, 12), (14, 2, 32),
                                               (7, 1, 96)])
def test_planes_an_sm_holds_at_the_m1_planes(side, level, planes):
    cfg = bwd.launch_config(side, side, level, 5)
    assert _resident(cfg.smem_bytes) * cfg.planes_per_block == planes


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("side,level", [*M1_TEAMS, (96, 4), (15, 4)])
def test_the_block_fits_in_shared_memory(side, level, k):
    cfg = bwd.launch_config(side, side, level, k)
    f = _fields(cfg)
    assert cfg.smem_bytes <= bwd.MAX_DYNAMIC_SMEM
    # the teams' regions, then the weights, the fragments' rows, the plan copies
    assert f["team_words"] * cfg.planes_per_block <= f["wts"]
    assert f["slots"] == f["wts"] + (level + 2) * k * k
    end = f["slots"] + bwd.fragments(cfg.team) * (level + 2) * k * k
    assert f["fplan"] % 4 == 0 and end <= f["fplan"] < end + 4  # int4 rows
    assert f["bplan"] == f["fplan"] + f["fplan_words"]
    assert cfg.smem_bytes == 4 * (f["bplan"] + f["bplan_words"])


@pytest.mark.parametrize("k", [3, 5, 7])
def test_a_160_plane_at_level_4_still_raises(k):
    """The kernel's layout still refuses the plane; the backward peels one level first,
    and the kernel takes the 80^2 plane at level 3."""
    with pytest.raises(ValueError, match="levels_to_peel_backward"):
        bwd.launch_config(160, 160, 4, k)
    assert bwd.levels_to_peel_backward(160, 160, 4, k) == 1
    assert bwd.launch_config(80, 80, 3, k).smem_bytes <= bwd.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("side,level", [*M1_TEAMS, (96, 4), (15, 2), (13, 4)])
def test_team_buffers_are_disjoint_and_haloed(side, level, k):
    """F[0..L], H[0..L-1] and G[1..L] of one team: each its level's haloed size, none
    overlapping another, all inside the team's words; odd pitches that cover the
    strips past a row's edge."""
    sizes, pitch, fb, hb, gb, words = bwd._team_layout(side, side, level, k)
    p = k // 2
    spans = []
    for bufs, levels in ((fb, range(level + 1)), (hb, range(level)),
                         (gb, range(1, level + 1))):
        for l in levels:
            spans.append((bufs[l], bufs[l] + (sizes[l][0] + 2 * p) * pitch[l]))
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == words
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for l, (_, w) in enumerate(sizes):
        assert pitch[l] % 2 == 1 and pitch[l] >= bwd._ceil_to(w, STRIP) + 2 * p
        if l < level:  # the stride-2 strips into level l + 1
            assert pitch[l] >= 2 * bwd._ceil_to(sizes[l + 1][1], STRIP) + k - 2


@pytest.mark.parametrize("side,level", M1_TEAMS)
def test_teams_in_one_warp_load_on_distinct_banks(side, level):
    """One tap's loads: lane j of team i reads row j of its own buffer, at i * stride
    + j * pitch words (csrc/recconv_bwd.cu: strips): distinct banks modulo 32."""
    for team in (8, 16, 32):
        stride = bwd._team_stride(bwd._team_layout(side, side, level, 5)[-1], team)
        for pitch in bwd._team_layout(side, side, level, 5)[1]:
            rows = min(team, 32)
            banks = {(i * stride + j * pitch) % 32 for i in range(32 // rows)
                     for j in range(rows)}
            assert len(banks) == 32


def _items(n, c, per_block):
    """csrc/recconv_bwd.cu's item walk: item = c * groups + group; team t of the block
    takes plane (group * per_block + t, c) where that n < N."""
    groups = -(-n // per_block)
    out = []
    for item in range(c * groups):
        ch, grp = divmod(item, groups)
        out.append([(grp * per_block + t, ch) for t in range(per_block)
                    if grp * per_block + t < n])
    return out


@pytest.mark.parametrize("n,c,team", [(128, 48, 256), (128, 96, 64), (3, 192, 32),
                                      (17, 384, 8), (5, 7, 16)])
def test_a_blocks_teams_take_planes_of_one_channel_and_every_plane_once(n, c, team):
    per_block = bwd.BLOCK_THREADS // team
    items = _items(n, c, per_block)
    assert len(items) == bwd.partial_shape(n, c, 2, 5, per_block)[0] * \
        bwd.partial_shape(n, c, 2, 5, per_block)[1]
    seen = [plane for item in items for plane in item]
    assert sorted(seen) == sorted((i, j) for i in range(n) for j in range(c))
    for item in items:
        assert len({ch for _, ch in item}) == 1
        ns = [i for i, _ in item]
        assert ns == list(range(ns[0], ns[0] + len(ns)))  # consecutive n


@pytest.mark.parametrize("n,per_block,shape", [(128, 1, (48, 128, 6, 5, 5)),
                                               (128, 4, (48, 32, 6, 5, 5)),
                                               (3, 8, (48, 1, 6, 5, 5)),
                                               (17, 32, (48, 1, 6, 5, 5))])
def test_partial_buffer_shape(n, per_block, shape):
    assert bwd.partial_shape(n, 48, 4, 5, per_block) == shape


def _team_sum(acc, lanes):
    """csrc/recconv_bwd.cu:team_sum_f on one fragment: acc (lanes, k*k) fp32, padded
    to kPad; each stage, lanes o apart swap halves; lane l ends with the sums of
    entries [l m, (l + 1) m). Returns the k*k sums."""
    kk = acc.shape[1]
    pad = 32 if kk <= 32 else 64
    v = np.zeros((lanes, pad), np.float32)
    v[:, :kk] = acc
    held = pad
    o = lanes // 2
    while o:
        lane = np.arange(lanes)
        upper = (lane & o) != 0
        lo, hi = v[:, :held // 2].copy(), v[:, held // 2:held].copy()
        send = np.where(upper[:, None], lo, hi)
        keep = np.where(upper[:, None], hi, lo)
        v[:, :held // 2] = keep + send[lane ^ o]
        held //= 2
        o //= 2
    m = pad // lanes
    return v[:, :m].reshape(-1)[:kk]


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_reduce_scatter_gives_every_lane_its_entries(lanes, k):
    rng = np.random.default_rng(lanes + k)
    acc = rng.normal(size=(lanes, k * k)).astype(np.float32)
    got = _team_sum(acc, lanes)
    np.testing.assert_allclose(got, acc.astype(np.float64).sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,c,team", [(128, 4, 256), (9, 3, 64), (17, 2, 32), (33, 2, 8)])
def test_the_fixed_order_reduction_equals_the_dense_sum(n, c, team):
    """Each thread's partial sums -> its fragment's row (a team sum per plane, the
    rows' values written for the first plane's sum and added for the next) -> the
    item's rows added in fragment order -> the batch-sum kernel adding the groups of
    a channel in order: against the dense fp64 sum, and the same bits twice."""
    k, level = 5, 2
    lanes = min(team, 32)
    per_block = bwd.BLOCK_THREADS // team
    rng = np.random.default_rng(n)
    acc = rng.normal(size=(n, c, team, k * k)).astype(np.float32)  # per plane, thread

    def reduce():
        partial = np.zeros(bwd.partial_shape(n, c, level, k, per_block)[:2] + (k * k,),
                           np.float32)
        for item, planes in enumerate(_items(n, c, per_block)):
            rows = np.zeros((bwd.fragments(team), k * k), np.float32)
            for t, (i, ch) in enumerate(planes):
                for f in range(team // lanes):
                    rows[t * (team // lanes) + f] = _team_sum(
                        acc[i, ch, f * lanes:(f + 1) * lanes], lanes)
            s = np.zeros(k * k, np.float32)
            for row in rows:
                s = s + row
            partial.reshape(-1, k * k)[item] = s
        dw = np.zeros((c, k * k), np.float32)
        for grp in range(partial.shape[1]):
            dw = dw + partial[:, grp]
        return dw

    first, again = reduce(), reduce()
    assert np.array_equal(first, again)
    dense = acc.astype(np.float64).sum((0, 2))
    np.testing.assert_allclose(first, dense, rtol=1e-4, atol=1e-4 * np.abs(dense).max())
