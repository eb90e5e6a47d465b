"""The launch plan of the linear-attention backward kernel (csrc/linear_attention_bwd.cu).

``launch_config``'s routes (packed heads, a head split over a thread-block cluster,
the tiled walk) and their shared-memory layouts at every shape the kernel takes:
each fits in an H100 block's 227 KB, its regions are disjoint and aligned, every
pass-2 item has a lane, every block of a cluster holds positions, and a1's four
training shapes keep 32 warps an SM within the register budget. The kernel's
chunked loads (``load_slice``, a transcription of ``load_slices``) place every
element of a slice once, at any alignment; the numpy transcription of the kernel
at every route a shape can take (``candidates``) is held against ``jax.vjp`` of
``recnext_tpu/ops/attention.py:linear_attention_kv_first``."""

import numpy as np
import pytest

from recnext_tpu.ops.attention import linear_attention_kv_first as jax_kv_first
from recnext_tpu_torch.ops.cuda import linear_attention_bwd as B
from recnext_tpu_torch.ops.cuda.linear_attention import MAX_SMEM_BYTES
from tests.test_torch_attention_bwd import (
    _close,
    _jax_vjp,
    _qkvg,
    load_slice,
    transcribe_kernel,
)

# (N, D, DV): a1's four heads, test_pallas's shapes, DV != D, the largest widths, a
# slice that leaves the last block of a cluster short (780), N = 1, odd widths
PLAN_SHAPES = [(784, 24, 24), (196, 24, 24), (49, 24, 24), (16, 24, 24), (780, 24, 24),
               (16, 32, 32), (64, 64, 64), (49, 20, 20), (196, 20, 40), (49, 12, 24),
               (1, 24, 40), (1, 1, 1), (5, 7, 128), (127, 128, 1), (784, 128, 128),
               (300, 128, 128), (3136, 24, 24), (100, 3, 5), (64, 128, 128), (2, 128, 128)]
A1 = {784: ("cluster", 256, 1, 8), 196: ("cluster", 256, 1, 2), 49: ("packed", 128, 2, 1),
      16: ("packed", 64, 4, 1)}  # N: (route, team, heads a block, cluster) at D = DV = 24


def _geo(cfg):
    fields = B.TILED_FIELDS if cfg.route == "tiled" else B.RESIDENT_FIELDS
    assert len(cfg.geometry) == 1 + len(fields) and cfg.geometry[0] == B.ROUTE_CODE[cfg.route]
    return dict(zip(fields, cfg.geometry[1:]))


def _check_resident(cfg, n, d, dv, layout):
    geo = _geo(cfg)
    assert cfg.route == ("packed" if cfg.cluster == 1 else "cluster")
    assert (geo["n"], geo["d"], geo["dv"], geo["n_fastest"]) == (n, d, dv, int(layout == "n"))
    assert cfg.team in B.TEAM_SIZES and cfg.threads == cfg.team * cfg.heads_per_block
    assert cfg.threads == B.BLOCK_THREADS
    assert 1 <= cfg.cluster <= B.MAX_CLUSTER and (cfg.cluster == 1 or cfg.heads_per_block == 1)
    # every block of a cluster holds at least one position; the slices cover N
    length = geo["len"]
    assert (cfg.cluster - 1) * length < n <= cfg.cluster * length
    # rows padded to 4-row blocks, positions to quads; the pitch spreads banks
    dr, dvr, pn = geo["dr"], geo["dvr"], geo["pn"]
    assert dr == -(-d // 4) * 4 and dvr == -(-dv // 4) * 4
    l4 = -(-length // B.QUAD) * B.QUAD
    s = max(2, min(geo["splits"], 8))
    assert l4 <= pn < l4 + 4 * s and pn % (4 * s) == 2 * s
    # each pass-2 item (a 4-row block by a quad of positions) has a lane of its own
    assert dr // B.ROWS * (l4 // B.QUAD) <= cfg.team
    # the splits leave a lane for each row sum, or are 1
    blocks = (dr // 4) * (dvr // 4)
    assert geo["splits"] == 1 or blocks * geo["splits"] + dr <= cfg.team
    # the regions: aligned, disjoint, inside the team's floats; the head's sums are
    # the block's own where the head is one block
    mat = dr * dvr + dr
    sizes = {"k": dr * pn, "v": dvr * pn, "q": dr * pn, "g": dvr * pn, "x1": mat, "x2": mat,
             "pm": dr // 4 * pn, "pt": dr // 4 * pn, "bn": pn}
    if cfg.cluster > 1:
        sizes.update(f1=mat, f2=mat)
    else:
        assert (geo["f1"], geo["f2"]) == (geo["x1"], geo["x2"])
    spans = sorted((geo[name], geo[name] + size) for name, size in sizes.items())
    assert all(a % 4 == 0 for a, _ in spans) and spans[-1][1] <= geo["team_floats"]
    assert all(e <= a for (_, e), (a, _) in zip(spans, spans[1:]))
    assert geo["team_floats"] % 4 == 0
    assert cfg.smem_bytes == 4 * geo["team_floats"] * cfg.heads_per_block <= MAX_SMEM_BYTES


@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("n,d,dv", PLAN_SHAPES)
def test_launch_config_fits_at_every_shape_and_route(n, d, dv, layout):
    for elem_bytes in (2, 4):
        cfg = B.launch_config(n, d, dv, elem_bytes, layout)
        assert cfg.route in B.ROUTES and cfg.smem_bytes <= MAX_SMEM_BYTES
        options = B.candidates(n, d, dv, elem_bytes, layout)
        assert options["tiled"].route == "tiled"
        for label, c in options.items():
            if c.route != "tiled":
                _check_resident(c, n, d, dv, layout)
                assert label == (f"packed_t{c.team}" if c.cluster == 1 else f"cluster{c.cluster}")
        resident = [c for c in options.values() if c.route != "tiled"]
        if resident:  # the most warps an SM, then the fewest blocks a head, then the team
            best = max(B.warps_per_sm(c) for c in resident)
            assert B.warps_per_sm(cfg) == best
            assert cfg == min((c for c in resident if B.warps_per_sm(c) == best),
                              key=lambda c: (c.cluster, c.team))
        else:
            assert cfg.route == "tiled"
            geo = _geo(cfg)
            assert cfg.smem_bytes == 4 * geo["floats"]


@pytest.mark.parametrize("n", sorted(A1))
def test_a1_shapes_take_their_routes_with_32_warps_an_sm(n):
    """a1's training heads (D = DV = 24): packed teams at N 16 and 49, a cluster at
    N 196 and 784, each block of 256 threads, 4 blocks (32 warps) an SM with 64
    registers a thread and at most 227 KB of shared memory among them."""
    for elem_bytes in (2, 4):
        cfg = B.launch_config(n, 24, 24, elem_bytes, "n")
        assert (cfg.route, cfg.team, cfg.heads_per_block, cfg.cluster) == A1[n]
        assert B.warps_per_sm(cfg) >= 32
        assert B.REGISTERS * B.BLOCK_THREADS * 4 <= B.SM_REGISTERS
        assert 4 * (cfg.smem_bytes + B.RESERVED_SMEM_BYTES) <= B.SM_SMEM_BYTES


def test_the_largest_widths_at_long_heads_take_the_tiled_route():
    """D = DV = 128 at N 784: no slice of a head is resident even over 8 blocks (a
    slice's pass-2 items outnumber a block's lanes), so the tiled walk runs it."""
    assert B.resident_config(784, 128, 128, "n", 8, 256) is None
    assert B.launch_config(784, 128, 128, 2, "n").route == "tiled"
    assert B.launch_config(300, 128, 128, 4, "d").route == "tiled"


@pytest.mark.parametrize("n,d,dv,elem_bytes,layout,match", [
    (16, 129, 24, 2, "n", "D=129"), (16, 24, 129, 4, "d", "DV=129"), (0, 8, 8, 2, "n", "N=0"),
    (16, 0, 8, 2, "n", "D=0"), (16, 8, 8, 2, "x", "layout"), (16, 8, 8, 8, "n", "8-byte"),
    (16, 8, 8, 1, "d", "1-byte")])
def test_candidates_refuse_what_the_kernel_does_not_take(n, d, dv, elem_bytes, layout, match):
    with pytest.raises(ValueError, match=match):
        B.candidates(n, d, dv, elem_bytes, layout)


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("length", [1, 16, 49, 98, 100, 196])
def test_pitch_spreads_a_float2_phase_over_the_banks(length, splits):
    """The 16 lanes of one float2 phase of an outer product read `splits` consecutive
    pairs of positions in each of 16 / splits block rows, `pn` floats apart (up to 8
    rows: a1's DV = 24 has 6 blocks of rows): no two fall on one pair of banks."""
    pn = B.pitch(length, splits)
    lanes = min(splits, 16)
    rows = min(16 // lanes, 8)
    slots = {(r * pn + 2 * sp) % 32 for r in range(rows) for sp in range(lanes)}
    assert len(slots) == rows * lanes
    assert pn >= -(-length // B.QUAD) * B.QUAD and pn % 4 == 0


@pytest.mark.parametrize("shift", [0, 1, 3, 5])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("n,d,dv", [(49, 24, 24), (784, 24, 24), (780, 24, 24), (196, 20, 40),
                                    (1, 24, 40)])
def test_chunked_loads_place_every_element_once(n, d, dv, layout, elem_bytes, shift):
    """Every (row, position) of every block's slice of a head, loaded as the 16-byte
    chunks that cover its spans at a misalignment of ``shift`` elements, holds the
    element's index in the head's span; nothing else of the region is written."""
    cfg = B.launch_config(n, d, dv, elem_bytes, layout)
    geo = _geo(cfg)
    for rows in (d, dv):
        span = np.arange(rows * n, dtype=np.float32)
        idx = span.reshape(rows, n) if layout == "n" else span.reshape(n, rows).T
        for rank in range(cfg.cluster):
            n0 = rank * geo["len"]
            ln = min(geo["len"], n - n0)
            sm = np.full(rows * geo["pn"], -1.0, np.float32)
            load_slice(sm, 0, span, rows, n0, ln, geo, layout, elem_bytes, shift)
            got = sm.reshape(rows, geo["pn"])
            np.testing.assert_array_equal(got[:, :ln], idx[:, n0:n0 + ln])
            assert (got[:, ln:] == -1).all()


ROUTE_SHAPES = [(3, 49, 24, 24), (5, 16, 24, 24), (2, 196, 20, 40), (2, 100, 24, 24),
                (1, 64, 64, 64), (3, 1, 24, 40), (2, 98, 12, 24)]


@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("bh,n,d,dv", ROUTE_SHAPES)
def test_transcription_at_every_route_matches_jax_vjp(bh, n, d, dv, layout):
    """Every configuration the kernel takes at these heads (each packed team size,
    each cluster size, the tiled walk), with head counts that leave a packed block
    or a cluster's last slice partly filled, against jax.vjp."""
    q, k, v, g = _qkvg(bh, n, d, dv, seed=5)
    want = _jax_vjp(jax_kv_first, q, k, v, g)
    options = B.candidates(n, d, dv, 4, layout)
    assert {c.route for c in options.values()} >= {"packed", "tiled"}
    for label, cfg in options.items():
        got = transcribe_kernel(q, k, v, g, layout, cfg=cfg)
        for name, a, b in zip("qkv", got, want):
            _close(a, b, f"d{name} at {label}")


@pytest.mark.parametrize("shift", [1, 3])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("layout", ["n", "d"])
def test_transcription_of_misaligned_heads_matches_jax_vjp(layout, elem_bytes, shift):
    """Heads off 16-byte alignment (the chunks start before a span and end after it)
    at a1's cluster and packed shapes."""
    for bh, n in ((2, 196), (3, 49)):
        q, k, v, g = _qkvg(bh, n, 24, 24, seed=6)
        got = transcribe_kernel(q, k, v, g, layout, elem_bytes=elem_bytes, shift=shift)
        for name, a, b in zip("qkv", got, _jax_vjp(jax_kv_first, q, k, v, g)):
            _close(a, b, f"d{name}")
