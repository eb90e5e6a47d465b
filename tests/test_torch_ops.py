"""The port's operators against the JAX package's: resize, depthwise conv and the
RecConv2d pyramid (plain version, the peeled composition that large planes take on
the GPU, and the CPU path of the fused entry point).
Inputs are made with numpy and handed to both; NHWC <-> NCHW is explicit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.ops.conv import depthwise_conv2d as jax_depthwise_conv2d
from recnext_tpu.ops.pallas.recconv import pallas_rec_conv2d
from recnext_tpu.ops.recconv import rec_conv2d as jax_rec_conv2d
from recnext_tpu.ops.resize import resize as jax_resize
from recnext_tpu_torch.ops.conv import depthwise_conv2d
from recnext_tpu_torch.ops.recconv import (
    rec_conv2d,
    rec_conv2d_fused,
    rec_conv2d_level,
    rec_conv2d_peeled,
)
from recnext_tpu_torch.ops.resize import resize


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("src,dst", [((4, 4), (7, 7)), ((8, 5), (15, 9)),
                                     ((7, 7), (14, 13)), ((6, 6), (6, 6))])
def test_resize_matches_jax(mode, src, dst):
    x = np.random.default_rng(0).normal(size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), dst, mode=mode))
    got = _nhwc(resize(_nchw(x), dst, mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride,k,h", [(1, 5, 14), (2, 5, 15), (2, 7, 14), (1, 3, 7)])
def test_depthwise_conv2d_matches_jax(stride, k, h):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, h, h, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 1, 8)).astype(np.float32)
    want = np.asarray(jax_depthwise_conv2d(jnp.asarray(x), jnp.asarray(w),
                                           stride=stride, padding=k // 2))
    got = _nhwc(depthwise_conv2d(_nchw(x), _oihw(w), stride=stride, padding=k // 2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _recconv_inputs(h, c, level, seed=0):
    """tests/test_pallas.py's inputs: x (4,h,h,c), k=5 kernels, all NHWC/HWIO."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, h, h, c)).astype(np.float32)
    dw = rng.normal(size=(5, 5, 1, c)).astype(np.float32)
    cws = [rng.normal(size=(5, 5, 1, c)).astype(np.float32) for _ in range(level + 1)]
    return x, dw, cws


# the shapes of tests/test_pallas.py:12, its tolerance (rtol 2e-5, atol 2e-5 max|want|)
RECCONV_SHAPES = [(14, 192, 2), (15, 32, 2), (7, 64, 1), (28, 48, 3)]


@pytest.mark.parametrize("h,c,level", RECCONV_SHAPES)
def test_rec_conv2d_matches_jax_and_pallas(h, c, level):
    x, dw, cws = _recconv_inputs(h, c, level)
    got = _nhwc(rec_conv2d(_nchw(x), _oihw(dw), [_oihw(w) for w in cws], level=level))
    jx, jdw, jcws = jnp.asarray(x), jnp.asarray(dw), tuple(jnp.asarray(w) for w in cws)
    # each JAX function in one compile (op by op, JAX dispatches the pyramid's ops, and
    # the interpreted kernel's, one at a time)
    want = np.asarray(jax.jit(lambda *a: jax_rec_conv2d(*a, level=level, mode="bilinear"))(
        jx, jdw, jcws))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
    pallas = np.asarray(jax.jit(lambda *a: pallas_rec_conv2d(*a, level=level, interpret=True))(
        jx, jdw, jcws))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5 * np.abs(pallas).max())


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_rec_conv2d_with_bias_and_mode_matches_jax(mode):
    rng = np.random.default_rng(2)
    x, dw, cws = _recconv_inputs(11, 8, 2, seed=3)
    db = rng.normal(size=(8,)).astype(np.float32)
    cbs = [rng.normal(size=(8,)).astype(np.float32) for _ in cws]
    got = _nhwc(rec_conv2d(_nchw(x), _oihw(dw), [_oihw(w) for w in cws],
                           torch.from_numpy(db), [torch.from_numpy(b) for b in cbs],
                           level=2, mode=mode))
    want = np.asarray(jax_rec_conv2d(
        jnp.asarray(x), jnp.asarray(dw), tuple(jnp.asarray(w) for w in cws),
        jnp.asarray(db), tuple(jnp.asarray(b) for b in cbs), level=2, mode=mode))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


# (level, k, levels peeled, mode) on an odd 37x29 plane: levels 1-4, k 3, 5 and 7,
# one and two levels peeled and the peel that reaches the coarsest conv
PEELED = [(1, 5, 1, "bilinear"), (1, 3, 1, "nearest"), (2, 7, 1, "bilinear"),
          (2, 5, 2, "nearest"), (3, 3, 1, "nearest"), (3, 5, 2, "bilinear"),
          (3, 7, 2, "nearest"), (4, 5, 1, "bilinear"), (4, 3, 2, "bilinear"),
          (4, 7, 1, "nearest"), (4, 5, 2, "nearest"), (4, 5, 4, "bilinear")]


@pytest.mark.parametrize("level,k,peel,mode", PEELED)
def test_rec_conv2d_peeled_matches_jax(level, k, peel, mode):
    rng = np.random.default_rng(level * 10 + k)
    x = rng.normal(size=(2, 37, 29, 6)).astype(np.float32)
    dw = rng.normal(size=(k, k, 1, 6)).astype(np.float32)
    cws = [rng.normal(size=(k, k, 1, 6)).astype(np.float32) for _ in range(level + 1)]
    inner_levels = []

    def inner(xi, down_w, conv_ws, *, level, mode):  # the kernel's place on the GPU
        inner_levels.append((tuple(xi.shape[2:]), level))
        return rec_conv2d(xi, down_w, conv_ws, level=level, mode=mode)

    got = _nhwc(rec_conv2d_peeled(_nchw(x), _oihw(dw), [_oihw(w) for w in cws],
                                  level=level, peel=peel, mode=mode, inner=inner))
    want = np.asarray(jax_rec_conv2d(jnp.asarray(x), jnp.asarray(dw),
                                     tuple(jnp.asarray(w) for w in cws), level=level,
                                     mode=mode))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
    # the inner step runs once on the plane left after the peel, unless none is left
    size = (37, 29)
    for _ in range(peel):
        size = ((size[0] + 1) // 2, (size[1] + 1) // 2)
    assert inner_levels == ([(size, level - peel)] if peel < level else [])


# (stride, k, mode of the upsampled inner plane or None, plane): one level of a
# peeled pyramid, the down conv and the upsample-add-conv, on odd and even planes
LEVELS = [(2, 5, None, (37, 29)), (2, 3, None, (16, 16)), (2, 7, None, (9, 40)),
          (1, 5, "bilinear", (37, 29)), (1, 3, "nearest", (37, 29)),
          (1, 7, "bilinear", (16, 16)), (1, 5, "nearest", (9, 40)), (1, 5, None, (19, 19))]


@pytest.mark.parametrize("stride,k,mode,plane", LEVELS)
def test_rec_conv2d_level_matches_jax(stride, k, mode, plane):
    rng = np.random.default_rng(stride * 100 + k)
    h, w = plane
    x = rng.normal(size=(2, h, w, 6)).astype(np.float32)
    wt = rng.normal(size=(k, k, 1, 6)).astype(np.float32)
    jx = jnp.asarray(x)
    up = None
    if mode:  # the inner plane, ceil(h/2) x ceil(w/2), upsampled and added to x
        up = rng.normal(size=(2, (h + 1) // 2, (w + 1) // 2, 6)).astype(np.float32)
        jx = jx + jax_resize(jnp.asarray(up), (h, w), mode=mode)
    want = np.asarray(jax_depthwise_conv2d(jx, jnp.asarray(wt), stride=stride,
                                           padding=k // 2))
    got = _nhwc(rec_conv2d_level(_nchw(x), _oihw(wt), stride=stride,
                                 up=None if up is None else _nchw(up), mode=mode or "bilinear"))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("level,peel,mode", [(4, 1, "bilinear"), (4, 2, "nearest"),
                                             (2, 2, "bilinear")])
def test_rec_conv2d_peeled_bf16_rounds_once(level, peel, mode):
    # bf16 x with the fp32 weights the GPU route passes: every level in fp32, the
    # output rounded once, so it equals the fp32 pyramid of the same values rounded
    g = torch.Generator().manual_seed(level + peel)
    x = torch.randn(2, 5, 37, 29, generator=g).bfloat16()
    ws = [torch.randn(5, 1, 5, 5, generator=g) / 5 for _ in range(level + 2)]
    got = rec_conv2d_peeled(x, ws[0], ws[1:], level=level, peel=peel, mode=mode)
    assert got.dtype == torch.bfloat16
    want = rec_conv2d(x.float(), ws[0], ws[1:], level=level, mode=mode)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("h,c,level", RECCONV_SHAPES[:2])
def test_rec_conv2d_fused_on_cpu_is_the_plain_version(h, c, level):
    x, dw, cws = _recconv_inputs(h, c, level)
    args = (_nchw(x), _oihw(dw), [_oihw(w) for w in cws])
    before = rec_conv2d_fused.launches
    got = rec_conv2d_fused(*args, level=level)
    assert rec_conv2d_fused.launches == before  # no kernel ran
    torch.testing.assert_close(got, rec_conv2d(*args, level=level), rtol=0, atol=0)


@pytest.mark.parametrize("src,dst", [((7, 7), (14, 13)), ((4, 5), (7, 9))])
def test_resize_device_plans_are_cached_and_exact(src, dst):
    """The cached device plans give exactly what a plan built anew from numpy gives,
    and a second call reuses them (no new host-to-device copy)."""
    from recnext_tpu_torch.ops import resize as rs

    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, *src)).astype(np.float32))
    (h, w), (oh, ow) = src, dst
    # nearest, with index tensors made from the numpy plans on every call
    want = x.index_select(2, torch.from_numpy(rs._nearest_axis_plan(h, oh).astype(np.int64)))
    want = want.index_select(3, torch.from_numpy(rs._nearest_axis_plan(w, ow).astype(np.int64)))
    rs._nearest_device_index.cache_clear()
    with torch.inference_mode():  # the serving path fills the cache here
        got = resize(x, dst, mode="nearest")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # bilinear likewise, one axis at a time
    want = x
    for dim, (i, o) in ((2, (h, oh)), (3, (w, ow))):
        idx0, idx1, w1 = rs._bilinear_axis_plan(i, o)
        x0 = want.index_select(dim, torch.from_numpy(idx0.astype(np.int64)))
        x1 = want.index_select(dim, torch.from_numpy(idx1.astype(np.int64)))
        shape = [1, 1, 1, 1]
        shape[dim] = -1
        want = x0 + (x1 - x0) * torch.from_numpy(w1).reshape(shape)
    torch.testing.assert_close(resize(x, dst, mode="bilinear"), want, rtol=0, atol=0)
    idx = rs._nearest_device_index(h, oh, x.device)
    assert rs._nearest_device_index(h, oh, x.device) is idx
    assert rs._bilinear_device_plan(h, oh, x.device, x.dtype)[0] is \
        rs._bilinear_device_plan(h, oh, x.device, x.dtype)[0]
    # made under inference_mode, the cached index is still a normal tensor, so a
    # resize that autograd records may save it for the backward pass
    assert not idx.is_inference()
    xg = x.clone().requires_grad_(True)
    resize(xg, dst, mode="nearest").sum().backward()
    assert xg.grad.shape == x.shape
