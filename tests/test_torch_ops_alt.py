"""The port's RecConv alternates, the taps depthwise conv and Winograd against the JAX
package's functions (``recnext_tpu/ops/{recconv,conv,winograd}.py``), on the same
seeded inputs, f32 on the CPU: the alternates and the taps forward within
2e-5·max|ref|, the taps gradients within 2e-5 (input) and 1e-4 (filter: a sum over
batch and plane) of ``jax.vjp``'s, Winograd F(2,5) within 2e-5 and F(4,5) within
2e-3·max|ref| of the direct conv (the F(4,5) transform's points reach ±3: its fp32
error is 2.6e-4 to 1.1e-3 of max|ref| at m1's shapes, JAX's the same algorithm).
JAX's weights are HWIO and its activations NHWC; every weight of these ops crosses
to PyTorch's layout by the same transpose (3, 2, 0, 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from recnext_tpu.ops import conv as jconv
from recnext_tpu.ops import recconv as jrc
from recnext_tpu.ops import winograd as jwino
from recnext_tpu_torch.ops import conv as tconv
from recnext_tpu_torch.ops import recconv as trc
from recnext_tpu_torch.ops import winograd as twino


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _w(rng, shape, scale=0.3):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _t(w):
    """An HWIO (or a transposed conv's (kh, kw, out/groups, in)) weight in PyTorch's
    layout."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _x(rng, n, c, h, w=None):
    return rng.normal(size=(n, h, w or h, c)).astype(np.float32)


def _close(got: torch.Tensor, want, tol=2e-5):
    want = np.asarray(want)
    got = got.detach().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jit(fn, *args, **static):
    """``fn(*args, **static)`` of the JAX package in one compile (op by op, JAX
    dispatches each of the alternate's ops on its own)."""
    return jax.jit(lambda *a: fn(*a, **static))(*args)


@pytest.mark.parametrize("level,c,side,mode", [(2, 16, 16, "bilinear"), (3, 16, 32, "bilinear"),
                                               (3, 16, 24, "nearest")])
def test_channel_split_matches_jax(level, c, side, mode):
    rng = np.random.default_rng(level)
    x = _x(rng, 2, c, side)
    down = [_w(rng, (5, 5, 1, c >> (i + 1))) for i in range(level)]
    convs = [_w(rng, (5, 5, 1, c >> (level - i))) for i in range(level + 1)]
    want = _jit(jrc.rec_conv2d_channel_split, jnp.asarray(x), tuple(map(jnp.asarray, down)),
                tuple(map(jnp.asarray, convs)), level=level, mode=mode)
    got = trc.rec_conv2d_channel_split(_nchw(x), [_t(w) for w in down],
                                       [_t(w) for w in convs], level=level, mode=mode)
    _close(got, want)


@pytest.mark.parametrize("level,c,side", [(2, 8, 16), (3, 16, 32)])
def test_transpose_up_matches_jax(level, c, side):
    rng = np.random.default_rng(10 + level)
    x = _x(rng, 2, c, side)
    down, up = _w(rng, (5, 5, 1, c)), _w(rng, (6, 6, 1, c))
    convs = [_w(rng, (5, 5, 1, c)) for _ in range(level + 1)]
    want = _jit(jrc.rec_conv2d_transpose_up, jnp.asarray(x), jnp.asarray(down),
                tuple(map(jnp.asarray, convs)), jnp.asarray(up), level=level)
    got = trc.rec_conv2d_transpose_up(_nchw(x), _t(down), [_t(w) for w in convs], _t(up),
                                      level=level)
    _close(got, want)


@pytest.mark.parametrize("level,c,side", [(2, 8, 16), (3, 16, 32)])
def test_maxpool_matches_jax(level, c, side):
    """Random inputs: no ties in a window, so JAX's argmax and max_pool2d's index pick
    the same element."""
    rng = np.random.default_rng(20 + level)
    x = _x(rng, 2, c, side)
    convs = [_w(rng, (5, 5, 1, c)) for _ in range(level + 1)]
    want = _jit(jrc.rec_conv2d_maxpool, jnp.asarray(x), tuple(map(jnp.asarray, convs)),
                level=level)
    got = trc.rec_conv2d_maxpool(_nchw(x), [_t(w) for w in convs], level=level)
    _close(got, want)


@pytest.mark.parametrize("level,c,side", [(2, 8, 16), (3, 16, 32)])
def test_group_down_matches_jax(level, c, side):
    rng = np.random.default_rng(30 + level)
    x = _x(rng, 2, c, side)
    down = [_w(rng, (5, 5, 2, c >> (i + 1))) for i in range(level)]
    convs = [_w(rng, (5, 5, 1, c >> (level - i))) for i in range(level)] + [_w(rng, (5, 5, 1, c))]
    up = [_w(rng, (6, 6, 2, c >> (level - i))) for i in range(level)]
    want = _jit(jrc.rec_conv2d_group_down, jnp.asarray(x), tuple(map(jnp.asarray, down)),
                tuple(map(jnp.asarray, convs)), tuple(map(jnp.asarray, up)), level=level)
    got = trc.rec_conv2d_group_down(_nchw(x), [_t(w) for w in down], [_t(w) for w in convs],
                                    [_t(w) for w in up], level=level)
    _close(got, want)


@pytest.mark.parametrize("level,c,side", [(2, 8, 16), (3, 16, 32)])
def test_split_transpose_up_matches_jax(level, c, side):
    rng = np.random.default_rng(40 + level)
    x = _x(rng, 2, c, side)
    down = [_w(rng, (5, 5, 1, c >> (i + 1))) for i in range(level)]
    convs = [_w(rng, (5, 5, 1, c >> (level - i))) for i in range(level)] + [_w(rng, (5, 5, 1, c))]
    up = [_w(rng, (6, 6, 1, c >> (level - i))) for i in range(level)]
    want = _jit(jrc.rec_conv2d_split_transpose_up, jnp.asarray(x),
                tuple(map(jnp.asarray, down)), tuple(map(jnp.asarray, convs)),
                tuple(map(jnp.asarray, up)), level=level)
    got = trc.rec_conv2d_split_transpose_up(_nchw(x), [_t(w) for w in down],
                                            [_t(w) for w in convs], [_t(w) for w in up],
                                            level=level)
    _close(got, want)


@pytest.mark.parametrize("level,mode,side", [(1, "nearest", 16), (2, "nearest", 20),
                                             (3, "bilinear", 32)])
def test_recurrent_matches_jax(level, mode, side):
    rng = np.random.default_rng(50 + level)
    c = 8
    x = _x(rng, 2, c, side)
    n, b, cc, d, a = (_w(rng, (5, 5, 1, c)) for _ in range(5))
    want = _jit(jrc.rec_conv2d_recurrent, jnp.asarray(x), *map(jnp.asarray, (n, b, cc, d, a)),
                level=level, mode=mode)
    got = trc.rec_conv2d_recurrent(_nchw(x), *map(_t, (n, b, cc, d, a)), level=level, mode=mode)
    _close(got, want)


def test_recurrent_needs_the_aggregate_kernel_above_level_1():
    w = torch.zeros(4, 1, 5, 5)
    with pytest.raises(ValueError, match="a_w"):
        trc.rec_conv2d_recurrent(torch.zeros(1, 4, 8, 8), w, w, w, w, level=2)


@pytest.mark.parametrize("stride,side,c", [(1, 14, 8), (2, 15, 16), (1, 9, 12)])
def test_taps_forward_and_gradients_match_jax(stride, side, c):
    rng = np.random.default_rng(60 + stride)
    x = _x(rng, 3, c, side)
    w = _w(rng, (5, 5, 1, c))
    b = _w(rng, (c,))

    def f(xx, ww):
        return jconv.depthwise_conv2d_taps(xx, ww, jnp.asarray(b), stride=stride, padding=2)

    o = (side + 4 - 5) // stride + 1
    g = rng.normal(size=(3, o, o, c)).astype(np.float32)
    # one compile of the forward and its vjp (op by op, JAX dispatches 25 taps each way)
    want, gx, gw = jax.jit(lambda xx, ww, gg: (f(xx, ww), *jax.vjp(f, xx, ww)[1](gg)))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    xt, wt = _nchw(x).requires_grad_(), _t(w).requires_grad_()
    got = tconv.depthwise_conv2d_taps(xt, wt, torch.from_numpy(b), stride=stride, padding=2)
    _close(got, want)
    got.backward(_nchw(g))
    _close(xt.grad, gx, 2e-5)
    want_w = np.asarray(gw).transpose(3, 2, 0, 1)
    assert np.abs(wt.grad.numpy() - want_w).max() <= 1e-4 * np.abs(want_w).max()
    # the same function as the direct conv
    ref = F.conv2d(_nchw(x), _t(w), torch.from_numpy(b), stride=stride, padding=2, groups=c)
    assert (got - ref).abs().max() <= 2e-5 * ref.abs().max()


@pytest.mark.parametrize("m,r", [(2, 3), (4, 3), (2, 5), (4, 5), (2, 7)])
def test_winograd_matrices_equal_jax(m, r):
    for got, want in zip(twino.winograd_matrices(m, r), jwino.winograd_matrices(m, r)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(twino._axis_matrices(13, m, r), jwino._axis_matrices(13, m, r)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("m,tol", [(2, 2e-5), (4, 2e-3)])
@pytest.mark.parametrize("shape", [(2, 14, 14, 8), (1, 7, 9, 4), (2, 28, 28, 16)])
def test_dw_conv_winograd_matches_jax_and_the_direct_conv(m, tol, shape):
    rng = np.random.default_rng(sum(shape) + m)
    x = rng.normal(size=shape).astype(np.float32)
    w = _w(rng, (5, 5, 1, shape[-1]), 0.28)
    b = _w(rng, (shape[-1],))
    want = _jit(jwino.dw_conv_winograd, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), m=m)
    got = twino.dw_conv_winograd(_nchw(x), _t(w), torch.from_numpy(b), m=m)
    _close(got, want, tol)
    ref = F.conv2d(_nchw(x), _t(w), torch.from_numpy(b), padding=2, groups=shape[-1])
    assert (got - ref).abs().max() <= tol * ref.abs().max()
