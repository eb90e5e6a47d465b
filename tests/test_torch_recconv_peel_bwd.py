"""RecConv2d's backward for planes larger than the backward kernel's shared memory:
the peel chosen by shape (``levels_to_peel_backward``), the peeled recursion
(``rec_conv2d_peeled_backward``, plain versions on the CPU) against ``jax.vjp`` of
the JAX package's ``rec_conv2d`` at 128^2 and 200x334, level 4, every peel count
against the unpeeled backward, and numpy transcriptions of the three level kernels
of ``csrc/recconv_level_bwd.cu`` (their tiles, windows, stride-2 parities, the wgrad
window built from x + up(u) and the transposed gather) against their plain versions."""

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

    _, vjp = jax.vjp(f, jnp.asarray(x.transpose(0, 2, 3, 1)), *hwio)
    return vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))


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

TILE, THREADS = lbwd.TILE, 256


def _floor_div(a, s):
    return a if s == 1 else a >> 1


def transcribe_dgrad(g, w, h, wd, stride, add=None):
    """recconv_level_dgrad_kernel: per tile of the fine grid, the window of g the tile
    reads (NaN where the kernel writes nothing), each output's taps with the kernel's
    parity test and window offsets, in its tap order."""
    n, c, oh, ow = g.shape
    k = w.shape[-1]
    p = k // 2
    r_win = (TILE - 1 + 2 * p) // stride + 2
    y = np.full((n, c, h, wd), np.nan, np.float32)
    for r0 in range(0, h, TILE):
        for q0 in range(0, wd, TILE):
            or0, oq0 = _floor_div(r0 - p, stride), _floor_div(q0 - p, stride)
            win = np.full((n, c, r_win, r_win | 1), np.nan, np.float32)
            a = np.arange(r_win)
            orow, ocol = or0 + a[:, None], oq0 + a[None, :]
            inside = (orow >= 0) & (orow < oh) & (ocol >= 0) & (ocol < ow)
            vals = g[:, :, np.clip(orow, 0, oh - 1), np.clip(ocol, 0, ow - 1)]
            win[:, :, :, :r_win] = np.where(inside, vals, 0.0)
            rows = np.arange(r0, min(r0 + TILE, h))
            cols = np.arange(q0, min(q0 + TILE, wd))
            acc = np.zeros((n, c, len(rows), len(cols)), np.float32)
            for i in range(k):
                ri = rows + p - i
                rok = (ri & 1) == 0 if stride == 2 else np.ones_like(ri, bool)
                ra = _floor_div(ri, stride) - or0
                assert 0 <= ra.min() and ra.max() < r_win  # inside the window
                for j in range(k):
                    cj = cols + p - j
                    cok = (cj & 1) == 0 if stride == 2 else np.ones_like(cj, bool)
                    cb = _floor_div(cj, stride) - oq0
                    assert 0 <= cb.min() and cb.max() < r_win
                    tap = win[:, :, ra[:, None], cb[None, :]] * w[:, 0, i, j][None, :, None, None]
                    acc = np.where(rok[:, None] & cok[None, :], acc + tap, acc).astype(np.float32)
            if add is not None:
                acc = acc + add[:, :, rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
            y[:, :, rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = acc
    return y


def _z_window(x, u, table, r0, q0, stride, k):
    """recconv_level_wgrad_kernel's window: x (+ up(u) along H, then along W by the
    lerp plans) at rows and columns stride * tile - k/2 + [0, R), zero outside x."""
    n, c, h, wd = x.shape
    p = k // 2
    r_win = stride * (TILE - 1) + k
    gr = r0 * stride - p + np.arange(r_win)
    gq = q0 * stride - p + np.arange(r_win)
    inside = ((gr >= 0) & (gr < h))[:, None] & ((gq >= 0) & (gq < wd))[None, :]
    grc, gqc = np.clip(gr, 0, h - 1), np.clip(gq, 0, wd - 1)
    v = x[:, :, grc[:, None], gqc[None, :]].astype(np.float32)
    if u is not None:
        rp, cp = table[grc], table[h + gqc]
        wr = rp[:, 2].view(np.float32)[:, None]
        wc = cp[:, 2].view(np.float32)[None, :]
        t0, t1 = u[:, :, rp[:, 0]], u[:, :, rp[:, 1]]
        left = t0[..., cp[:, 0]] + (t1[..., cp[:, 0]] - t0[..., cp[:, 0]]) * wr
        right = t0[..., cp[:, 1]] + (t1[..., cp[:, 1]] - t0[..., cp[:, 1]]) * wr
        v = v + (left + (right - left) * wc)
    win = np.full((n, c, r_win, r_win | 1), np.nan, np.float32)
    win[:, :, :, :r_win] = np.where(inside, v, 0.0)
    return win


def transcribe_wgrad(x, g, k, stride, u=None, mode="bilinear"):
    """recconv_level_wgrad_kernel and its sum: per tile of g, each thread's k*k sums
    over its 4 rows in order, the warps' lanes added, the 8 warps in order, one row of
    partial sums per (plane, tile); then a channel's rows added over n and tiles."""
    n, c, h, wd = x.shape
    oh, ow = g.shape[2:]
    table = lerp_plan_table(h, wd, 1, mode)[0] if u is not None else None
    partial = []
    for r0 in range(0, oh, TILE):
        for q0 in range(0, ow, TILE):
            win = _z_window(x, u, table, r0, q0, stride, k)
            warps = np.zeros((n, c, THREADS // TILE, k, k), np.float32)
            for warp in range(THREADS // TILE):  # one warp: one row of 32 columns
                lanes = np.arange(TILE)
                acc = np.zeros((n, c, TILE, k, k), np.float32)
                for r in range(warp, TILE, THREADS // TILE):
                    if r0 + r >= oh:
                        break
                    ok = q0 + lanes < ow
                    gv = np.where(ok, g[:, :, r0 + r, np.clip(q0 + lanes, 0, ow - 1)], 0.0)
                    for i in range(k):
                        for j in range(k):
                            zv = win[:, :, stride * r + i, stride * lanes + j]
                            acc[..., i, j] += np.where(ok, zv * gv, 0.0).astype(np.float32)
                warps[:, :, warp] = acc.sum(axis=2)
            s = np.zeros((n, c, k, k), np.float32)
            for v in range(THREADS // TILE):
                s = s + warps[:, :, v]
            partial.append(s)
    rows = np.stack(partial, axis=1)  # (n, tiles, c, k, k)
    rows = rows.transpose(2, 0, 1, 3, 4).reshape(c, -1, k, k)  # channel-major: n, tile
    assert not np.isnan(rows).any()
    return rows.sum(axis=1, dtype=np.float32)[:, None]


def transcribe_up_adjoint(dz, mode):
    """recconv_up_adjoint_kernel: one coarse element a thread, the fine rows and
    columns that read it from the transposed plan table (columns from entry UH * 4),
    zero weights skipped, the columns summed inside each row."""
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
    assert lbwd.tiles(oh, ow) == -(-oh // 32) * -(-ow // 32)


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
