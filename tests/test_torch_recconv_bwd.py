"""The RecConv2d backward: its plain version against ``jax.vjp`` of the JAX
package's ``rec_conv2d``; the transposed up-step plans the backward kernel reads
against the dense adjoint of the resize; a numpy-indexed transcription of the
kernel's two sweeps (the same halo offsets, parity gathers and plan tables as
``csrc/recconv_bwd.cu``) against the plain version; and the autograd Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.ops.recconv import rec_conv2d as jax_rec_conv2d
from recnext_tpu_torch.ops.cuda import recconv_bwd as bwd
from recnext_tpu_torch.ops.cuda.recconv import lerp_plan_table, pyramid_sizes
from recnext_tpu_torch.ops.recconv import (
    RecConv2dFunction,
    rec_conv2d,
    rec_conv2d_backward,
    rec_conv2d_backward_plain,
)
from recnext_tpu_torch.ops.resize import resize

# tests/test_pallas.py:12's (side, channels, level), then m1's stage-0 plane (56^2 L4)
SHAPES = [(14, 192, 2), (15, 32, 2), (7, 64, 1), (28, 48, 3), (56, 8, 4)]
TOL = 2e-5  # x max|ref| of each tensor: tests/test_pallas.py:25's bound


def _inputs(side, c, level, seed=0, n=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, side, side)).astype(np.float32)
    ws = [(rng.normal(size=(c, 1, 5, 5)) / 5).astype(np.float32) for _ in range(level + 2)]
    g = rng.normal(size=(n, c, side, side)).astype(np.float32)
    return x, ws, g


def _assert_within(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{name}: {err} > {TOL} * {scale}"


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("side,c,level", SHAPES)
def test_plain_backward_matches_jax_vjp(side, c, level, mode):
    x, ws, g = _inputs(side, c, level)
    hwio = [jnp.asarray(w.transpose(2, 3, 1, 0)) for w in ws]

    def f(xx, dw, *cws):
        return jax_rec_conv2d(xx, dw, cws, level=level, mode=mode)

    # one compile of the forward and its vjp: op by op, JAX dispatches the pyramid's
    # gathers and lerps one at a time, most of this test's time
    want = jax.jit(lambda gg, xx, *ws_: jax.vjp(f, xx, *ws_)[1](gg))(
        jnp.asarray(g.transpose(0, 2, 3, 1)), jnp.asarray(x.transpose(0, 2, 3, 1)), *hwio)
    dx, dd, dcs = rec_conv2d_backward_plain(torch.from_numpy(x), torch.from_numpy(ws[0]),
                                            [torch.from_numpy(w) for w in ws[1:]],
                                            torch.from_numpy(g), level=level, mode=mode)
    _assert_within(dx.numpy().transpose(0, 2, 3, 1), want[0], "dx")
    for i, d in enumerate([dd, *dcs]):
        _assert_within(d.numpy().transpose(2, 3, 1, 0), want[1 + i], f"dW[{i}]")
    # on a CPU tensor the wrapper is the plain version
    got = rec_conv2d_backward(torch.from_numpy(x), torch.from_numpy(ws[0]),
                              [torch.from_numpy(w) for w in ws[1:]], torch.from_numpy(g),
                              level=level, mode=mode)
    torch.testing.assert_close(got[0], dx, rtol=0, atol=0)


def _apply_transposed(b, idx, wts, axis):
    """upT along ``axis`` of b, as the kernel gathers it: out[c] = sum_e w[c,e] b[idx[c,e]]."""
    moved = np.moveaxis(b, axis, 0)
    out = np.einsum("ce,ce...->c...", wts.astype(np.float64), moved[idx].astype(np.float64))
    return np.moveaxis(out, 0, axis)


# m1's pyramids (56 -> 28 -> 14 -> 7 -> 4 and 28, 14, 7 at 224^2), odd and even
# widths, and the 96^2 plane of a 384^2 input
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("fine", [56, 28, 14, 7, 4, 2, 1, 96, 15, 13, 9, 3])
def test_transposed_plans_are_the_adjoint_of_the_resize(fine, mode):
    coarse = (fine + 1) // 2
    rng = np.random.default_rng(fine)
    a = rng.normal(size=(1, 1, coarse, coarse))
    b = rng.normal(size=(1, 1, fine, fine))
    up_a = resize(torch.from_numpy(a), (fine, fine), mode=mode).numpy()
    idx, wts = bwd.transposed_axis_plan(coarse, fine, mode)
    assert idx.shape == (coarse, bwd.MAX_FAN) and (idx < fine).all() and (idx >= 0).all()
    upt_b = _apply_transposed(_apply_transposed(b, idx, wts, 3), idx, wts, 2)
    lhs, rhs = float((up_a * b).sum()), float((a * upt_b).sum())
    assert lhs == pytest.approx(rhs, rel=1e-6, abs=1e-9)
    # and on every basis vector of one axis: the dense transposed matrix
    eye = np.eye(coarse)[:, None, None, :]  # (coarse, 1, 1, coarse): row c is e_c
    dense = resize(torch.from_numpy(eye), (1, fine), mode=mode).numpy()[:, 0, 0, :]
    got = _apply_transposed(np.eye(fine), idx, wts, 0)  # (coarse, fine)
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-7)


def test_transposed_plan_table_offsets():
    table, rows, cols = bwd.transposed_plan_table(56, 40, 4)
    sizes = pyramid_sizes(56, 40, 4)
    assert len(rows) == len(cols) == 5 and rows[0] == cols[0] == 0
    for l in range(1, 5):
        idx, wts = bwd.transposed_axis_plan(sizes[l][0], sizes[l - 1][0], "bilinear")
        got = table[rows[l]:rows[l] + idx.size]
        np.testing.assert_array_equal(got[:, 0], idx.reshape(-1))
        np.testing.assert_array_equal(got[:, 1].view(np.float32), wts.reshape(-1))
        assert cols[l] == rows[l] + idx.size


def test_launch_config_at_m1_shapes_and_refusal():
    for side, level, team in ((56, 4, 128), (28, 3, 64), (14, 2, 16), (7, 1, 8)):
        cfg = bwd.launch_config(side, side, level, 5)
        assert cfg.team == team and cfg.planes_per_block * team == 256
        assert cfg.smem_bytes <= bwd.MAX_DYNAMIC_SMEM
        assert len(cfg.geometry) == 58 and cfg.geometry[0] == level
    assert bwd.launch_config(96, 96, 4, 5).smem_bytes <= bwd.MAX_DYNAMIC_SMEM  # 384^2 finetune
    # a plane whose backward does not fit is refused by the layout, which names the
    # route the caller takes first: peeling outer levels
    with pytest.raises(ValueError, match="levels_to_peel_backward"):
        bwd.launch_config(160, 160, 4, 5)
    with pytest.raises(ValueError, match="kernel size"):
        bwd.launch_config(14, 14, 2, 4)


def _emulate(x, ws, g, level, mode, sm=None):
    """csrc/recconv_bwd.cu's arithmetic, vectorised over the (n, c) planes but run in
    one team's shared memory as ``ops/cuda/recconv_bwd.py:_team_layout`` lays it out:
    every buffer is a view of a flat array that starts as NaN (or, passed as ``sm``,
    holds what an earlier plane left), the halo rings are zeroed once, and each step
    reads and writes the buffers the kernel does, in its order, in the interiors only.
    A read of a stale word or of a ring the kernel never zeroes turns the result NaN.
    Returns (dx, dWs, sm)."""
    n, c, h0, w0 = x.shape
    k = ws[0].shape[-1]
    p = k // 2
    sizes, pitch, fb, hb, gb, words = bwd._team_layout(h0, w0, level, k)
    planes = n * c
    if sm is None:
        sm = np.full((planes, words), np.nan, np.float32)
    chan = np.arange(planes) % c
    wd, wc = ws[0][chan, 0], [w[chan, 0] for w in ws[1:]]  # (planes, k, k)

    def pad(off, l):  # the haloed buffer at `off` of level l, a view
        return sm[:, off:off + (sizes[l][0] + 2 * p) * pitch[l]].reshape(planes, -1, pitch[l])

    def inner(off, l, hh=None, ww=None):  # its interior (or an hh x ww corner of it)
        hh, ww = hh or sizes[l][0], ww or sizes[l][1]
        return pad(off, l)[:, p:p + hh, p:p + ww]

    def ring(off, l):  # csrc/recconv_bwd.cu:zero_ring
        b = pad(off, l)
        b[:, :p] = 0
        b[:, p + sizes[l][0]:] = 0
        b[:, :, :p] = 0
        b[:, :, p + sizes[l][1]:] = 0

    def conv(src, w, oh, ow, stride=1):  # src haloed: out = sum w[u, v] src[s r + u, s c + v]
        out = np.zeros((planes, oh, ow), np.float32)
        for u in range(k):
            for v in range(k):
                out += w[:, u, v, None, None] * src[:, u:u + stride * oh:stride,
                                                    v:v + stride * ow:stride]
        return out

    def corr(src, dy, stride=1):  # dW[c, u, v] = sum dy[r, q] src[s r + u, s q + v]
        oh, ow = dy.shape[1:]
        per = np.stack([np.stack([(dy * src[:, u:u + stride * oh:stride,
                                            v:v + stride * ow:stride]).sum((1, 2))
                                  for v in range(k)], -1) for u in range(k)], -2)
        return np.stack([per[chan == i].sum(0) for i in range(c)])[:, None]

    def down_t(df, hh, ww):  # taps with (a + p - u) even, read at (a + p - u) / 2 + p
        out = np.zeros((planes, hh, ww), np.float32)
        a, b = np.arange(hh), np.arange(ww)
        for u in range(k):
            ra = a + p - u
            for v in range(k):
                cb = b + p - v
                blk = df[:, (ra // 2 + p)[:, None], (cb // 2 + p)[None, :]]
                keep = (ra % 2 == 0)[:, None] & (cb % 2 == 0)[None, :]
                out += np.where(keep, wd[:, u, v, None, None] * blk, 0)
        return out

    ftab, frows, fcols = lerp_plan_table(h0, w0, level, mode)
    btab, brows, bcols = bwd.transposed_plan_table(h0, w0, level, mode)
    for l in range(level + 1):
        ring(fb[l], l)
        if l < level:
            ring(hb[l], l)
        if l > 0:
            ring(gb[l], l)
    F = lambda l: fb[l]  # noqa: E731
    H = lambda l: hb[l]  # noqa: E731
    dh = lambda l: fb[l] if l in (0, level) else hb[l]  # noqa: E731
    inner(F(0), 0)[:] = x.reshape(planes, h0, w0)
    for l in range(1, level + 1):
        inner(F(l), l)[:] = conv(pad(F(l - 1), l - 1), wd, *sizes[l], stride=2)
    for j in range(level - 1, -1, -1):
        (hj, wj), (hn, wn) = sizes[j], sizes[j + 1]
        y = inner(gb[j + 1], j + 1)
        y[:] = conv(pad(F(level) if j + 1 == level else H(j + 1), j + 1), wc[level - j - 1],
                    hn, wn)
        r = ftab[frows[j + 1]:frows[j + 1] + hj]
        wr = r[:, 2].view(np.float32)[None, :, None]
        tmp = inner(hb[0] if j == 0 else gb[j], j, hj, wn)
        tmp[:] = y[:, r[:, 0]] + (y[:, r[:, 1]] - y[:, r[:, 0]]) * wr
        cc = ftab[fcols[j + 1]:fcols[j + 1] + wj]
        wcc = cc[:, 2].view(np.float32)[None, None, :]
        hs = inner(F(0) if j == 0 else H(j), j)
        hs[:] = inner(F(j), j) + (tmp[:, :, cc[:, 0]]
                                  + (tmp[:, :, cc[:, 1]] - tmp[:, :, cc[:, 0]]) * wcc)
    inner(hb[0], 0)[:] = g.reshape(planes, h0, w0)
    dws = [None] * (level + 2)
    dws[level + 1] = corr(pad(F(0), 0), inner(hb[0], 0))
    inner(F(0), 0)[:] = conv(pad(hb[0], 0), wc[level][:, ::-1, ::-1], h0, w0)
    fan = bwd.MAX_FAN
    for j in range(1, level + 1):
        (hp, _), (hj, wj) = sizes[j - 1], sizes[j]
        ci = btab[bcols[j]:bcols[j] + wj * fan].reshape(wj, fan, 2)
        tw = inner(hb[0] if j == 1 else gb[j - 1], j - 1, hp, wj)
        tw[:] = _apply_transposed(inner(dh(j - 1), j - 1), ci[..., 0],
                                  ci[..., 1].view(np.float32), 2)
        ri = btab[brows[j]:brows[j] + hj * fan].reshape(hj, fan, 2)
        dy = inner(gb[j], j)
        dy[:] = _apply_transposed(tw, ri[..., 0], ri[..., 1].view(np.float32), 1)
        dws[1 + level - j] = corr(pad(F(level) if j == level else H(j), j), dy)
        inner(dh(j), j)[:] = conv(pad(gb[j], j), wc[level - j][:, ::-1, ::-1], hj, wj)
    inner(hb[0], 0)[:] = x.reshape(planes, h0, w0)
    dws[0] = 0
    for j in range(level, 0, -1):
        dws[0] = dws[0] + corr(pad(hb[0] if j == 1 else F(j - 1), j - 1), inner(dh(j), j),
                               stride=2)
        inner(dh(j - 1), j - 1)[:] += down_t(pad(dh(j), j), *sizes[j - 1])
    return inner(F(0), 0).reshape(x.shape).copy(), dws, sm


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("side,c,level,k", [(14, 6, 2, 5), (15, 4, 2, 5), (7, 4, 1, 5),
                                            (28, 3, 3, 5), (56, 2, 4, 5), (13, 3, 4, 3),
                                            (11, 3, 3, 7)])
def test_kernel_transcription_matches_plain(side, c, level, k, mode):
    rng = np.random.default_rng(side + k)
    x = rng.normal(size=(2, c, side, side + 1)).astype(np.float32)  # odd and even widths
    ws = [(rng.normal(size=(c, 1, k, k)) / k).astype(np.float32) for _ in range(level + 2)]
    g = rng.normal(size=x.shape).astype(np.float32)
    # a plane before this one leaves its values in the buffers' interiors
    _, _, sm = _emulate(rng.normal(size=x.shape).astype(np.float32), ws,
                        rng.normal(size=x.shape).astype(np.float32), level, mode)
    dx, dws, _ = _emulate(x, ws, g, level, mode, sm)
    want = rec_conv2d_backward_plain(torch.from_numpy(x), torch.from_numpy(ws[0]),
                                     [torch.from_numpy(w) for w in ws[1:]],
                                     torch.from_numpy(g), level=level, mode=mode)
    _assert_within(dx, want[0].numpy(), "dx")
    for i, (d, w) in enumerate(zip(dws, [want[1], *want[2]])):
        _assert_within(d, w.numpy(), f"dW[{i}]")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_function_gives_autograd_gradients(dtype):
    """RecConv2dFunction (on the CPU: the plain forward and backward) against
    autograd over the plain rec_conv2d."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 15, 13, generator=gen, dtype=dtype)
    ws = [torch.randn(5, 1, 5, 5, generator=gen, dtype=dtype) / 5 for _ in range(4)]
    a = [t.clone().requires_grad_() for t in (x, *ws)]
    b = [t.clone().requires_grad_() for t in (x, *ws)]
    y1 = RecConv2dFunction.apply(2, "bilinear", *a)
    y2 = rec_conv2d(b[0], b[1], b[2:], level=2)
    torch.testing.assert_close(y1, y2)
    g = torch.randn(y1.shape, generator=gen, dtype=dtype)
    (y1 * g).sum().backward()
    (y2 * g).sum().backward()
    for t1, t2 in zip(a, b):
        assert t1.grad.dtype == t1.dtype
        torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-5, atol=1e-5)
