"""RecConv2d's backward for planes larger than the backward kernel's shared memory:
the peel chosen by shape (``levels_to_peel_backward``), the peeled recursion
(``rec_conv2d_peeled_backward``, plain versions on the CPU) against ``jax.vjp`` of
the JAX package's ``rec_conv2d`` at 128^2 and 200x334, level 4, every peel count
against the unpeeled backward, and numpy transcriptions of the backward kernels
KL′1-2 of ``csrc/recconv_level_bwd.cu`` (the warps' bands and column tiles, the rings
of rows, the register strips, stride-2 parities, z = x + up(u) built a row at a time,
the reduce-scatter and the partial rows per block) and of KL′3's arithmetic, element
by element, against their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.ops.recconv import rec_conv2d as jax_rec_conv2d
from recnext_tpu_torch.ops.cuda import recconv_bwd as bwd
from recnext_tpu_torch.ops.cuda import recconv_level_bwd as lbwd
from recnext_tpu_torch.ops.cuda.recconv import lerp_plan_table, pyramid_sizes
from recnext_tpu_torch.ops.recconv import (
    rec_conv2d_backward,
    rec_conv2d_backward_plain,
    rec_conv2d_level_backward,
    rec_conv2d_level_backward_plain,
    rec_conv2d_level_dgrad,
    rec_conv2d_level_dgrad_plain,
    rec_conv2d_level_wgrad,
    rec_conv2d_level_wgrad_plain,
    rec_conv2d_peeled_backward,
    rec_conv2d_up_adjoint,
    rec_conv2d_up_adjoint_plain,
)

DX_TOL, DW_TOL = 2e-5, 1e-4  # x max|ref| per tensor: K1′'s bounds


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, c, h, w, level, k=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, h, w)).astype(np.float32)
    ws = [(rng.normal(size=(c, 1, k, k)) / k).astype(np.float32) for _ in range(level + 2)]
    g = rng.normal(size=(n, c, h, w)).astype(np.float32)
    return x, ws, g


def _within(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert scale > 0 and err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


# (h, w, level, k) -> the fewest peeled levels; the shapes of a 512^2 (128^2 at stage
# 0) and a COCO 1333x800 input (200x334), m1's 224^2 and 384^2 planes
PEELS = [((128, 128, 4, 5), 1), ((128, 128, 3, 5), 1), ((64, 64, 3, 5), 0),
         ((200, 334, 4, 5), 2), ((100, 167, 3, 5), 1), ((50, 84, 2, 5), 0),
         ((160, 160, 4, 5), 1), ((112, 112, 4, 5), 0), ((96, 96, 4, 5), 0),
         ((56, 56, 4, 5), 0), ((160, 160, 4, 3), 1), ((160, 160, 4, 7), 1)]


@pytest.mark.parametrize("shape,peel", PEELS)
def test_levels_to_peel_backward_takes_the_fewest_levels(shape, peel):
    h, w, level, k = shape
    assert bwd.levels_to_peel_backward(h, w, level, k) == peel
    sizes = pyramid_sizes(h, w, level)
    ph, pw = sizes[peel]
    # the kernel takes the inner plane; one level fewer does not fit
    assert bwd.launch_config(ph, pw, level - peel, k).smem_bytes <= bwd.MAX_DYNAMIC_SMEM
    if peel:
        qh, qw = sizes[peel - 1]
        with pytest.raises(ValueError, match="levels_to_peel_backward"):
            bwd.launch_config(qh, qw, level - peel + 1, k)


def test_levels_to_peel_backward_peels_every_level_where_nothing_fits():
    # a plane so wide that even its level-1 pyramid exceeds shared memory
    assert bwd.levels_to_peel_backward(8, 8000, 1, 5) == 1
    with pytest.raises(ValueError, match="kernel size"):
        bwd.levels_to_peel_backward(128, 128, 4, 4)


def _jax_vjp(x, ws, g, level, mode):
    hwio = [jnp.asarray(w.transpose(2, 3, 1, 0)) for w in ws]

    def f(xx, dw, *cws):
        return jax_rec_conv2d(xx, dw, cws, level=level, mode=mode)

    # one compile of the forward and its vjp (op by op, JAX dispatches the pyramid's
    # gathers and lerps one at a time)
    return jax.jit(lambda gg, xx, *ws_: jax.vjp(f, xx, *ws_)[1](gg))(
        jnp.asarray(g.transpose(0, 2, 3, 1)), jnp.asarray(x.transpose(0, 2, 3, 1)), *hwio)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("h,w,c", [(128, 128, 4), (200, 334, 2)])
def test_peeled_backward_matches_jax_vjp(h, w, c, mode):
    level = 4
    x, ws, g = _inputs(1, c, h, w, level, seed=h)
    peel = bwd.levels_to_peel_backward(h, w, level, 5)
    assert peel >= 1
    dx, dd, dcs = rec_conv2d_peeled_backward(
        torch.from_numpy(x), torch.from_numpy(ws[0]), [torch.from_numpy(v) for v in ws[1:]],
        torch.from_numpy(g), level=level, peel=peel, mode=mode)
    want = _jax_vjp(x, ws, g, level, mode)
    _within(dx.numpy().transpose(0, 2, 3, 1), want[0], DX_TOL, "dx")
    for i, d in enumerate([dd, *dcs]):
        _within(d.numpy().transpose(2, 3, 1, 0), want[1 + i], DW_TOL, f"dW[{i}]")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("peel", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("h,w", [(32, 32), (33, 21)])
def test_every_peel_gives_the_unpeeled_gradient(h, w, peel, mode):
    level = 4
    x, ws, g = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                [torch.from_numpy(v) for v in a] for a in _inputs(2, 3, h, w, level, seed=peel))
    want = rec_conv2d_backward_plain(x, ws[0], ws[1:], g, level=level, mode=mode)
    got = rec_conv2d_peeled_backward(x, ws[0], ws[1:], g, level=level, peel=peel, mode=mode)
    _within(got[0], want[0], DX_TOL, "dx")
    for i, (a, b) in enumerate(zip([got[1], *got[2]], [want[1], *want[2]])):
        _within(a, b, DW_TOL, f"dW[{i}]")


def test_peeled_backward_keeps_dtypes_and_refuses_bad_peels():
    x, ws, g = _inputs(1, 2, 33, 21, 3)
    xb = torch.from_numpy(x).bfloat16()
    wb = [torch.from_numpy(v).bfloat16() for v in ws]
    dx, dd, dcs = rec_conv2d_peeled_backward(xb, wb[0], wb[1:], torch.from_numpy(g).bfloat16(),
                                             level=3, peel=2)
    assert dx.dtype == torch.bfloat16 and dd.dtype == torch.float32
    assert all(d.dtype == torch.float32 and d.shape == (2, 1, 5, 5) for d in dcs)
    with pytest.raises(ValueError, match="peel 4"):
        rec_conv2d_peeled_backward(xb, wb[0], wb[1:], xb, level=3, peel=4)
    # on a CPU tensor the wrapper is the plain version, with no route to peel
    got = rec_conv2d_backward(torch.from_numpy(x), torch.from_numpy(ws[0]),
                              [torch.from_numpy(v) for v in ws[1:]], torch.from_numpy(g),
                              level=3)
    want = rec_conv2d_backward_plain(torch.from_numpy(x), torch.from_numpy(ws[0]),
                                     [torch.from_numpy(v) for v in ws[1:]],
                                     torch.from_numpy(g), level=3)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


# ---- numpy transcriptions of csrc/recconv_level_bwd.cu ----------------------------

LANES = np.arange(32)


def _fma(a, b, c):
    """fmaf in float32: the product and sum in float64, rounded once more to float32."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _ring_row(src, r, col0, n, width):
    """One ring row as copy_row fills it: columns [col0, col0 + n) of row r of every
    plane of src (planes, rows, width), zero outside the plane (r None: outside)."""
    out = np.zeros((src.shape[0], n), np.float32)
    if r is not None:
        cols = col0 + np.arange(n)
        inside = (cols >= 0) & (cols < width)
        out[:, inside] = src[:, r, cols[inside]]
    return out


def _windows(row, start, n):
    """Each lane's n consecutive ring elements from start[lane]: (planes, 32, n)."""
    return row[:, start[:, None] + np.arange(n)[None, :]]


def _warps(cfg):
    """The warps of one plane's blocks with work: (bp, warp, tile, u0, u1)."""
    return [p for p in lbwd.warp_places(cfg.geometry, cfg.threads)
            if p[2] < cfg.geometry.tiles and p[3] < p[4]]


def transcribe_dgrad(g, w, h, wd, stride, add=None):
    """recconv_level_dgrad_kernel: each warp walks its band of units down its column
    tile; input rows land in a ring of `stages` slots (NaN where nothing was copied), a
    lane's window of 12 (stride 2: 6) elements is read once a row, and a ring of k rows
    (stride 2: k/2 + 1 pairs) of accumulators takes the taps in the kernel's order,
    written when whole: each output exactly once."""
    n, c, oh, ow = g.shape
    k = w.shape[-1]
    p = k // 2
    planes = n * c
    cfg = lbwd.launch_config("dgrad", h, wd, k, stride, planes)
    geo = cfg.geometry
    ns, d_ahead = geo.stages, geo.stages - 1
    gp = g.reshape(planes, oh, ow)
    wk = np.tile(w.reshape(c, k * k), (n, 1))  # plane n * C + c takes channel c's
    ap = None if add is None else add.reshape(planes, h, wd)
    y = np.full((planes, h, wd), np.nan, np.float32)
    slot_len = lbwd.ROW1 if stride == 1 else lbwd.ROWC

    def store(r, q, acc):
        for s in range(lbwd.STRIP):
            ok = q + s < wd
            cols = q[ok] + s
            assert np.isnan(y[:, r, cols]).all()  # each output written once
            v = acc[:, ok, s]
            y[:, r, cols] = v if ap is None else (v + ap[:, r, cols]).astype(np.float32)

    for _, _, tile, u0, u1 in _warps(cfg):
        c0 = tile * lbwd.TILE
        q = c0 + lbwd.STRIP * LANES
        col0 = (c0 if stride == 1 else c0 // 2) - lbwd.PAD
        in0 = u0 - p
        steps = u1 - u0 + (2 * p if stride == 1 else p)
        ring = np.full((planes, ns, slot_len), np.nan, np.float32)

        def issue(t):
            r = in0 + t
            ring[:, t % ns] = _ring_row(gp, r if 0 <= r < oh else None, col0, slot_len, ow)

        for t in range(min(d_ahead, steps)):
            issue(t)
        if stride == 1:
            acc = np.zeros((k, planes, 32, lbwd.STRIP), np.float32)
            for t in range(steps):
                u = t % k
                win = _windows(ring[:, t % ns], lbwd.STRIP * LANES + lbwd.PAD - 4, 12)
                if t + d_ahead < steps:
                    issue(t + d_ahead)
                for i in range(k):
                    for j in range(k):
                        acc[(u + i) % k] = _fma(wk[:, i * k + j, None, None],
                                                win[:, :, 4 + p - j:8 + p - j], acc[(u + i) % k])
                r = in0 + t - p
                if r >= u0:
                    store(r, q, acc[u])
                acc[u] = 0.0
        else:
            acc = np.zeros((p + 1, 2, planes, 32, lbwd.STRIP), np.float32)
            for t in range(steps):
                u = t % (p + 1)
                win = _windows(ring[:, t % ns], 2 * LANES + lbwd.PAD - 2, 6)
                if t + d_ahead < steps:
                    issue(t + d_ahead)
                for d in range(p + 1):
                    for e in range(2):
                        if 2 * d + e >= k:
                            continue
                        for s in range(lbwd.STRIP):
                            for j in range((s + p) & 1, k, 2):
                                slot = acc[(u + d) % (p + 1), e]
                                slot[..., s] = _fma(wk[:, (2 * d + e) * k + j, None],
                                                    win[:, :, 2 + (s + p - j) // 2],
                                                    slot[..., s])
                m = in0 + t
                if m >= u0:
                    for e in range(2):
                        r = 2 * m - p + e
                        if 0 <= r < h:
                            store(r, q, acc[u, e])
                acc[u] = 0.0
    return y.reshape(n, c, h, wd)


def warp_sum(acc, k):
    """warp_sum: the 5 shuffle stages of the reduce-scatter over a warp's 32 lanes of
    acc (planes, 32, k*k); returns (planes, k*k), entry e written by lane e // m."""
    kk = k * k
    npad = 32 if kk <= 32 else 64
    v = np.zeros(acc.shape[:2] + (npad,), np.float32)
    v[..., :kk] = acc
    m = npad
    for o in (16, 8, 4, 2, 1):
        upper = (LANES & o) != 0
        half = m // 2
        send = np.where(upper[:, None], v[..., :half], v[..., half:m])
        keep = np.where(upper[:, None], v[..., half:m], v[..., :half])
        v[..., :half] = keep + send[:, LANES ^ o]
        m = half
    per = npad // 32
    out = np.full((acc.shape[0], kk), np.nan, np.float32)
    for lane in range(32):
        for t in range(per):
            if lane * per + t < kk:
                out[:, lane * per + t] = v[:, lane, t]
    return out


def _tile_sum(partial):
    """recconv_level_wgrad_sum_kernel on (C, rows, k*k): thread i adds rows i, i + 256,
    ... in order, then the block's 256 sums halve."""
    c, rows, kk = partial.shape
    v = np.zeros((c, 256, kk), np.float32)
    for r in range(rows):
        v[:, r % 256] = v[:, r % 256] + partial[:, r]
    half = 128
    while half:
        v[:, :half] = v[:, :half] + v[:, half:2 * half]
        half //= 2
    return v[:, 0]


def _z_row(xs, ur, table, rho, h, wd, c0, ucol0, uring, p):
    """The z row the stride-1 walk builds: x + up(u) along H, then along W, at columns
    [c0 - k/2, c0 + TILE + k/2) of row rho (zero outside the plane), NaN elsewhere. The
    kernel builds it a step ahead, after the copies of that step are issued."""
    z = np.full((xs.shape[0], lbwd.ROW1), np.nan, np.float32)
    cols = np.arange(c0 - p, c0 + lbwd.TILE + p)
    z[:, cols - c0 + lbwd.PAD] = 0.0
    if not 0 <= rho < h:
        return z
    cols = cols[(cols >= 0) & (cols < wd)]
    rp, cp = table[rho], table[h + cols]
    t0, t1 = ur[:, rp[0] % uring], ur[:, rp[1] % uring]
    wr = rp[2:3].view(np.float32)[0]
    wc = cp[:, 2].view(np.float32)
    a0, a1 = cp[:, 0] - ucol0, cp[:, 1] - ucol0
    left = t0[:, a0] + (t1[:, a0] - t0[:, a0]) * wr
    right = t0[:, a1] + (t1[:, a1] - t0[:, a1]) * wr
    z[:, cols - c0 + lbwd.PAD] = xs[:, cols - c0 + lbwd.PAD] + (left + (right - left) * wc)
    return z


def transcribe_wgrad(x, g, k, stride, u=None, mode="bilinear"):
    """recconv_level_wgrad_kernel and its sum: each warp walks its band of g rows down
    its column tile, x, g (and u's coarse rows, into a ring of their own) landing in
    ring slots (NaN where nothing was copied); z = x + up(u) built a row ahead into two
    rows; at stride 1 the taps' g rows read from g's ring (zero before the band), at
    stride 2 g's last rows shifted down a row a step, as in registers; each lane's k*k
    sums in step order;
    the warp's reduce-scatter, the block's warps in order into one partial row per
    (plane, block), and the fixed tree over a channel's rows."""
    n, c, h, wd = x.shape
    oh, ow = g.shape[2:]
    p, kk = k // 2, k * k
    planes = n * c
    up = u is not None
    cfg = lbwd.launch_config("wgrad", h, wd, k, stride, planes, up=up, mode=mode)
    geo = cfg.geometry
    ns, d_ahead = geo.stages, geo.stages - 1
    xp, gp = x.reshape(planes, h, wd), g.reshape(planes, oh, ow)
    uh, uw = pyramid_sizes(h, wd, 1)[1]
    upl = u.reshape(planes, uh, uw) if up else None
    table = lerp_plan_table(h, wd, 1, mode)[0] if up else None
    rows = {}  # (bp, warp) -> the warp's reduce-scattered sums
    for bp, warp, tile, u0, u1 in _warps(cfg):
        c0 = tile * lbwd.TILE
        acc = np.zeros((planes, 32, kk), np.float32)
        if stride == 1:
            ucol0, z0, steps = c0 // 2 - lbwd.PAD, u0 - p, u1 - u0 + 2 * p
            xring = np.full((planes, ns, lbwd.ROW1), np.nan, np.float32)
            uring = np.full((planes, max(geo.uring, 1), lbwd.ROWC), np.nan, np.float32)
            gring = np.zeros((planes, geo.gring, lbwd.TILE), np.float32)  # zero before the band
            nxt = [min(table[max(z0, 0), :2])] if up else [0]

            def issue(t):
                rho = z0 + t
                inside = 0 <= rho < h
                xring[:, t % ns] = _ring_row(xp, rho if inside else None, c0 - lbwd.PAD,
                                             lbwd.ROW1, wd)
                gring[:, t % geo.gring] = _ring_row(gp, u0 + t if u0 + t < u1 else None, c0,
                                                    lbwd.TILE, ow)
                if up and inside:
                    while nxt[0] <= max(table[rho, :2]):
                        uring[:, nxt[0] % geo.uring] = _ring_row(upl, nxt[0], ucol0,
                                                                 lbwd.ROWC, uw)
                        nxt[0] += 1

            zrows = np.full((planes, 2, lbwd.ROW1), np.nan, np.float32)

            def build(t):  # z row z0 + t, a step ahead, into zrows[t % 2]
                zrows[:, t % 2] = _z_row(xring[:, t % ns], uring, table, z0 + t, h, wd, c0,
                                         ucol0, geo.uring, p)

            for t in range(min(d_ahead, steps)):
                issue(t)
            if up:
                build(0)
            for t in range(steps):
                row = zrows[:, t % 2] if up else xring[:, t % ns]
                win = _windows(row, lbwd.STRIP * LANES + lbwd.PAD - 4, 12)
                if t + d_ahead < steps:
                    issue(t + d_ahead)
                if up and t + 1 < steps:
                    build(t + 1)
                for i in range(k):  # g row u0 + t - i from its ring
                    gv = _windows(gring[:, (t - i) % geo.gring], lbwd.STRIP * LANES, 4)
                    for j in range(k):
                        for s in range(lbwd.STRIP):
                            acc[..., i * k + j] = _fma(win[..., 4 + s + j - p], gv[..., s],
                                                       acc[..., i * k + j])
        else:
            x0, steps, rr = 2 * u0 - p, u1 - u0 + p, p + 1
            ng = (14 + p) // 4
            xring = np.full((planes, ns, 2, lbwd.ROW2), np.nan, np.float32)
            gring = np.full((planes, ns, lbwd.TILE), np.nan, np.float32)

            def issue(t):
                for e in range(2):
                    rho = x0 + 2 * t + e
                    xring[:, t % ns, e] = _ring_row(xp, rho if 0 <= rho < h else None,
                                                    2 * c0 - lbwd.PAD, lbwd.ROW2, wd)
                if u0 + t < u1:
                    gring[:, t % ns] = _ring_row(gp, u0 + t, c0, lbwd.TILE, ow)

            gs = np.zeros((rr, planes, 32, lbwd.STRIP), np.float32)
            for t in range(min(d_ahead, steps)):
                issue(t)
            for t in range(steps):
                gs = np.roll(gs, 1, axis=0)  # g's rows shift down a row
                gs[0] = (_windows(gring[:, t % ns], lbwd.STRIP * LANES, 4)
                         if u0 + t < u1 else 0.0)
                if t + d_ahead < steps:
                    issue(t + d_ahead)
                for e in range(2):
                    win = _windows(xring[:, t % ns, e], 2 * lbwd.STRIP * LANES + lbwd.PAD - 4,
                                   4 * ng)
                    for d in range(p + 1):
                        i = 2 * d + e
                        if i >= k:
                            continue
                        for j in range(k):
                            for s in range(lbwd.STRIP):
                                acc[..., i * k + j] = _fma(win[..., 4 + 2 * s + j - p],
                                                           gs[d][..., s], acc[..., i * k + j])
        assert not np.isnan(acc).any()  # every value a lane multiplied was copied
        rows[bp, warp] = warp_sum(acc, k)
    partial = np.zeros((planes, cfg.blocks_per_plane, kk), np.float32)
    for bp in range(cfg.blocks_per_plane):
        s = np.zeros((planes, kk), np.float32)
        for warp in range(cfg.threads // 32):  # warps without work add zeros
            s = s + rows.get((bp, warp), 0.0)
        partial[:, bp] = s
    partial = partial.reshape(n, c, cfg.blocks_per_plane, kk).transpose(1, 0, 2, 3)
    assert partial.shape[:2] + partial.shape[3:] == (c, n, kk)
    return _tile_sum(partial.reshape(lbwd.partial_shape(n, c, k, cfg)))[:, None].reshape(
        c, 1, k, k)


def transcribe_up_adjoint(dz, mode):
    """recconv_up_adjoint_kernel's arithmetic, element by element: the fine rows and
    columns that read a coarse element from the transposed plan table (columns from
    entry UH * 4), zero weights skipped, the columns summed inside each row, then the
    rows (its band walk with the fed ring: tests/test_torch_recconv_level_plan.py)."""
    n, c, h, wd = dz.shape
    uh, uw = pyramid_sizes(h, wd, 1)[1]
    table = bwd.transposed_plan_table(h, wd, 1, mode)[0]
    fan = bwd.MAX_FAN
    col0 = uh * fan
    rows = table[:uh * fan].reshape(uh, fan, 2)
    cols = table[col0:col0 + uw * fan].reshape(uw, fan, 2)
    wr, wc = rows[..., 1].view(np.float32), cols[..., 1].view(np.float32)
    du = np.zeros((n, c, uh, uw), np.float32)
    for e in range(fan):
        row = np.zeros((n, c, uh, uw), np.float32)
        for f in range(fan):
            zv = dz[:, :, rows[:, e, 0][:, None], cols[:, f, 0][None, :]]
            row = row + np.where(wc[None, :, f] != 0, wc[None, :, f] * zv, 0.0)
        du = du + np.where(wr[:, e, None] != 0, wr[:, e, None] * row, 0.0)
    return du.astype(np.float32)


# odd sizes (ceil(H/2) at stride 2), more than one tile per side, a plane narrower
# than a tile, k 3, 5 and 7
DGRAD_CASES = [(33, 21, 5, 2), (33, 21, 5, 1), (67, 45, 3, 2), (67, 45, 7, 1),
               (40, 70, 7, 2), (5, 3, 5, 2), (64, 64, 5, 2), (1, 9, 3, 2)]


@pytest.mark.parametrize("h,w,k,stride", DGRAD_CASES)
def test_dgrad_transcription_matches_plain(h, w, k, stride):
    rng = np.random.default_rng(h * w + k)
    oh, ow = -(-h // stride), -(-w // stride)
    g = rng.normal(size=(2, 3, oh, ow)).astype(np.float32)
    wt = rng.normal(size=(3, 1, k, k)).astype(np.float32)
    add = rng.normal(size=(2, 3, h, w)).astype(np.float32) if stride == 2 else None
    want = rec_conv2d_level_dgrad_plain(
        torch.from_numpy(g), torch.from_numpy(wt), size=(h, w), stride=stride,
        add=None if add is None else torch.from_numpy(add)).numpy()
    got = transcribe_dgrad(g, wt, h, w, stride, add)
    assert not np.isnan(got).any()
    _within(got, want, DX_TOL, "dgrad")
    # the wrapper on a CPU tensor is the plain version, in the dtype asked for
    out = rec_conv2d_level_dgrad(torch.from_numpy(g), torch.from_numpy(wt), size=(h, w),
                                 stride=stride, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, h, w)


WGRAD_CASES = [(33, 21, 5, 1, "bilinear"), (33, 21, 5, 1, "nearest"), (33, 21, 5, 2, None),
               (67, 45, 3, 1, "bilinear"), (67, 45, 7, 2, None), (40, 70, 7, 1, "nearest"),
               (5, 3, 5, 1, "bilinear"), (64, 64, 5, 2, None), (64, 64, 5, 1, None)]


@pytest.mark.parametrize("h,w,k,stride,mode", WGRAD_CASES)
def test_wgrad_transcription_matches_plain(h, w, k, stride, mode):
    rng = np.random.default_rng(h + w + k)
    x = rng.normal(size=(2, 3, h, w)).astype(np.float32)
    uh, uw = pyramid_sizes(h, w, 1)[1]
    u = rng.normal(size=(2, 3, uh, uw)).astype(np.float32) if mode else None
    oh, ow = (h, w) if stride == 1 else (uh, uw)
    g = rng.normal(size=(2, 3, oh, ow)).astype(np.float32)
    want = rec_conv2d_level_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g), k=k,
                                        stride=stride,
                                        up=None if u is None else torch.from_numpy(u),
                                        mode=mode or "bilinear").numpy()
    got = transcribe_wgrad(x, g, k, stride, u, mode or "bilinear")
    _within(got, want, DW_TOL, "wgrad")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("h,w", [(128, 128), (200, 334), (33, 21), (7, 2), (1, 1)])
def test_up_adjoint_transcription_matches_plain(h, w, mode):
    rng = np.random.default_rng(h + 7 * w)
    dz = rng.normal(size=(2, 3, h, w)).astype(np.float32)
    want = rec_conv2d_up_adjoint_plain(torch.from_numpy(dz), mode=mode).numpy()
    got = transcribe_up_adjoint(dz, mode)
    _within(got, want, DX_TOL, "up adjoint")
    torch.testing.assert_close(rec_conv2d_up_adjoint(torch.from_numpy(dz), mode=mode),
                               torch.from_numpy(want), rtol=0, atol=0)


@pytest.mark.parametrize("stride,up", [(1, True), (1, False), (2, False)])
def test_level_backward_is_its_three_parts(stride, up):
    """The composite the recursion calls: dx by the dgrad, dw by the wgrad, d up by the
    up adjoint of dx, each the plain version on the CPU."""
    rng = np.random.default_rng(stride + up)
    h, w, k = 33, 21, 5
    x = torch.from_numpy(rng.normal(size=(2, 3, h, w)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(3, 1, k, k)).astype(np.float32))
    uh, uw = pyramid_sizes(h, w, 1)[1]
    u = torch.from_numpy(rng.normal(size=(2, 3, uh, uw)).astype(np.float32)) if up else None
    oh, ow = (h, w) if stride == 1 else (uh, uw)
    g = torch.from_numpy(rng.normal(size=(2, 3, oh, ow)).astype(np.float32))
    add = None if stride == 1 else torch.from_numpy(rng.normal(size=(2, 3, h, w)).astype(
        np.float32))
    dx, dw, du = rec_conv2d_level_backward(x, wt, g, stride=stride, up=u, add=add)
    want_dx = rec_conv2d_level_dgrad_plain(g, wt, size=(h, w), stride=stride, add=add)
    want_dw = rec_conv2d_level_wgrad_plain(x, g, k=k, stride=stride, up=u)
    _within(dx, want_dx, DX_TOL, "dx")
    _within(dw, want_dw, DW_TOL, "dw")
    if up:
        _within(du, rec_conv2d_up_adjoint_plain(dx), DX_TOL, "du")
    else:
        assert du is None
    same = rec_conv2d_level_backward_plain(x, wt, g, stride=stride, up=u, add=add)
    torch.testing.assert_close(dx, same[0], rtol=0, atol=0)
