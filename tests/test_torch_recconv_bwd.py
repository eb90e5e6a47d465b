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

    _, vjp = jax.vjp(f, jnp.asarray(x.transpose(0, 2, 3, 1)), *hwio)
    want = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
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
    for side, level, threads in ((56, 4, 256), (28, 3, 128), (14, 2, 64), (7, 1, 64)):
        cfg = bwd.launch_config(side, side, level, 5)
        assert cfg.threads == threads and cfg.smem_bytes <= 80_000
        assert len(cfg.geometry) == 55 and cfg.geometry[0] == level
    assert bwd.launch_config(96, 96, 4, 5).smem_bytes <= bwd.MAX_DYNAMIC_SMEM  # 384^2 finetune
    with pytest.raises(ValueError, match="ROADMAP.md Queue 2"):
        bwd.check_fits(160, 160, 4, 5)
    with pytest.raises(ValueError, match="kernel size"):
        bwd.check_fits(14, 14, 2, 4)


def _emulate(x, ws, g, level, mode):
    """csrc/recconv_bwd.cu's arithmetic, vectorised over (n, c) and pixels but
    indexed as the kernel indexes its haloed shared buffers: the forward recompute
    with the forward kernel's lerp table, convT and corr by tap offsets into
    halo-padded planes, D^T as the parity gather, up^T from the transposed table."""
    k = ws[0].shape[-1]
    p = k // 2
    h0, w0 = x.shape[2:]
    sizes = pyramid_sizes(h0, w0, level)
    wd, wc = ws[0][:, 0], [w[:, 0] for w in ws[1:]]  # (C, k, k)
    pad = lambda t: np.pad(t, ((0, 0), (0, 0), (p, p), (p, p)))  # noqa: E731

    def conv(src, w, stride=1):  # cross-correlation over a haloed source
        sp = pad(src)
        oh, ow = ((src.shape[2] + 1) // 2, (src.shape[3] + 1) // 2) if stride == 2 \
            else src.shape[2:]
        out = np.zeros(src.shape[:2] + (oh, ow), np.float32)
        for u in range(k):
            for v in range(k):
                win = sp[:, :, u:u + stride * oh:stride, v:v + stride * ow:stride]
                out += w[None, :, u, v, None, None] * win
        return out

    def corr(src, dy, stride=1):  # dW[c, u, v] = sum dy[i, j] src_pad[s*i + u, s*j + v]
        sp = pad(src)
        oh, ow = dy.shape[2:]
        return np.stack([np.stack([(dy * sp[:, :, u:u + stride * oh:stride,
                                            v:v + stride * ow:stride]).sum((0, 2, 3))
                                   for v in range(k)], -1) for u in range(k)], -2)

    def convT(dy, w):  # dh[a, b] = sum w[u, v] dy_pad[a + 2p - u, b + 2p - v]
        dp = pad(dy)
        hh, ww = dy.shape[2:]
        out = np.zeros_like(dy)
        for u in range(k):
            for v in range(k):
                out += w[None, :, u, v, None, None] * dp[:, :, 2 * p - u:2 * p - u + hh,
                                                           2 * p - v:2 * p - v + ww]
        return out

    def down_T(df, w, hh, ww):  # taps with (a + p - u) even, read at (a + p - u)/2 + p
        dp = pad(df)
        out = np.zeros(df.shape[:2] + (hh, ww), np.float32)
        a, b = np.arange(hh), np.arange(ww)
        for u in range(k):
            ra = a + p - u
            rok = ra % 2 == 0
            for v in range(k):
                cb = b + p - v
                cok = cb % 2 == 0
                blk = dp[:, :, (ra // 2 + p)[:, None], (cb // 2 + p)[None, :]]
                out += w[None, :, u, v, None, None] * blk * (rok[:, None] & cok[None, :])
        return out

    ftab, frows, fcols = lerp_plan_table(h0, w0, level, mode)
    btab, brows, bcols = bwd.transposed_plan_table(h0, w0, level, mode)
    f = [x]
    for _ in range(level):
        f.append(conv(f[-1], wd, 2))
    hs = [None] * level + [f[level]]
    for j in range(level - 1, -1, -1):
        y = conv(hs[j + 1], wc[level - j - 1])
        r = ftab[frows[j + 1]:frows[j + 1] + sizes[j][0]]
        wr = r[:, 2].view(np.float32)[None, None, :, None]
        t = y[:, :, r[:, 0]] + (y[:, :, r[:, 1]] - y[:, :, r[:, 0]]) * wr
        cc = ftab[fcols[j + 1]:fcols[j + 1] + sizes[j][1]]
        wcc = cc[:, 2].view(np.float32)[None, None, None, :]
        hs[j] = f[j] + (t[:, :, :, cc[:, 0]] + (t[:, :, :, cc[:, 1]] - t[:, :, :, cc[:, 0]]) * wcc)

    def up_T(src, l):  # fine level l-1 -> coarse level l: columns, then rows
        (ch, cw), fan = sizes[l], bwd.MAX_FAN
        ci = btab[bcols[l]:bcols[l] + cw * fan].reshape(cw, fan, 2)
        t = _apply_transposed(src, ci[..., 0], ci[..., 1].view(np.float32), 3)
        ri = btab[brows[l]:brows[l] + ch * fan].reshape(ch, fan, 2)
        return _apply_transposed(t, ri[..., 0], ri[..., 1].view(np.float32), 2).astype(
            np.float32)

    dws = [None] * (level + 2)
    dws[level + 1] = corr(hs[0], g)
    dh = [convT(g, wc[level])] + [None] * level
    for j in range(1, level + 1):
        dy = up_T(dh[j - 1], j)
        dws[1 + level - j] = corr(hs[j], dy)
        dh[j] = convT(dy, wc[level - j])
    dws[0] = np.zeros_like(dws[1])
    for j in range(level, 0, -1):
        dws[0] += corr(f[j - 1], dh[j], stride=2)
        dh[j - 1] = dh[j - 1] + down_T(dh[j], wd, *sizes[j - 1])
    return dh[0], [d[:, None] for d in dws]


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("side,c,level,k", [(14, 6, 2, 5), (15, 4, 2, 5), (7, 4, 1, 5),
                                            (28, 3, 3, 5), (56, 2, 4, 5), (13, 3, 4, 3),
                                            (11, 3, 3, 7)])
def test_kernel_transcription_matches_plain(side, c, level, k, mode):
    rng = np.random.default_rng(side + k)
    x = rng.normal(size=(2, c, side, side + 1)).astype(np.float32)  # odd and even widths
    ws = [(rng.normal(size=(c, 1, k, k)) / k).astype(np.float32) for _ in range(level + 2)]
    g = rng.normal(size=x.shape).astype(np.float32)
    dx, dws = _emulate(x, ws, g, level, mode)
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
