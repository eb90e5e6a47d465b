"""The gradient of the port's linear attention against the JAX package's.

The plain backward (autograd over the kv-first form in fp32) against ``jax.vjp`` of
``recnext_tpu.ops.attention.linear_attention_kv_first`` and ``_qk_first``; a numpy
transcription of the backward kernel's three passes (its tiles, its formulas and
their order) against the same ``jax.vjp``; the kernel's launch layout; the entries
under grad on CPU tensors (the plain version under autograd; the Function that carries
both kernels takes CUDA tensors only); and the LinearAttention and RecAttn2d mixers'
parameter and input gradients against ``jax.grad`` of the flax modules on the same
weights. Inputs are made with numpy and handed to both; NHWC <-> NCHW is explicit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.models.mixers import LinearAttention as JaxLinearAttention
from recnext_tpu.models.mixers import RecAttn2d as JaxRecAttn2d
from recnext_tpu.ops.attention import linear_attention_kv_first as jax_kv_first
from recnext_tpu.ops.attention import linear_attention_qk_first as jax_qk_first
from recnext_tpu_torch.convert import jax_to_torch
from recnext_tpu_torch.models.mixers import LinearAttention, RecAttn2d
from recnext_tpu_torch.ops import attention as A
from recnext_tpu_torch.ops.cuda import linear_attention_bwd as B
from recnext_tpu_torch.ops.cuda.linear_attention import MAX_SMEM_BYTES

EPS = 1e-6
# tests/test_pallas.py:29-34's (BH, N, D, DV); recnext_a1's four head shapes (N 784,
# 196, 49, 16; D = DV = 24) at BH <= 8; DV != D (the L family's LA3: D 12, DV 24);
# N = 1
SHAPES = [(2, 16, 32, 32), (4, 64, 64, 64), (2, 49, 20, 20), (2, 196, 20, 40),
          (2, 784, 24, 24), (4, 196, 24, 24), (8, 49, 24, 24), (8, 16, 24, 24),
          (3, 49, 12, 24), (3, 1, 24, 40)]
IDS = [f"bh{bh}_n{n}_d{d}_dv{dv}" for bh, n, d, dv in SHAPES]


def _qkvg(bh, n, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    # elu(x)+1 features are positive: so are q and k here, as in tests/test_pallas.py
    q = np.abs(rng.normal(size=(bh, n, d))).astype(np.float32) + 0.1
    k = np.abs(rng.normal(size=(bh, n, d))).astype(np.float32) + 0.1
    v = rng.normal(size=(bh, n, dv)).astype(np.float32)
    g = rng.normal(size=(bh, n, dv)).astype(np.float32)
    return q, k, v, g


def _jax_vjp(fn, q, k, v, g):
    _, pull = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in pull(jnp.asarray(g))]


def _close(got, want, name):
    """Within 2e-5 max|ref| of each tensor: fp32 sums in another order. A gradient
    that is 0 in exact arithmetic (dq and dk at N = 1, where out = v whatever q and
    k are) holds rounding noise on both sides, with no scale: under 1e-5 each."""
    scale = np.abs(want).max()
    if scale < 1e-5:
        assert np.abs(got).max() < 1e-5, (name, np.abs(got).max(), scale)
        return
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= 2e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("bh,n,d,dv", SHAPES, ids=IDS)
def test_plain_backward_matches_jax_vjp(bh, n, d, dv):
    q, k, v, g = _qkvg(bh, n, d, dv)
    got = A.linear_attention_backward_plain(*(torch.from_numpy(a) for a in (q, k, v, g)))
    for fn in (jax_kv_first, jax_qk_first):
        for name, a, b in zip("qkv", got, _jax_vjp(fn, q, k, v, g)):
            assert a.dtype == torch.float32 and a.shape == b.shape
            _close(a.numpy(), b, f"d{name} vs {fn.__name__}")


def transcribe_kernel(q, k, v, g, layout="n", eps=EPS, elem_bytes=4):
    """csrc/linear_attention_bwd.cu, one head at a time, in numpy fp32: the launch
    configuration's tiles, the outer products split over ``splits`` lanes (each
    lane's positions in order, then the butterfly), the row sums one lane a row, the
    three passes with the kernel's formulas in the kernel's order."""
    bh, n, d = q.shape
    dv = v.shape[-1]
    cfg = B.launch_config(n, d, dv, elem_bytes, layout)
    f32 = np.float32
    inv_n = f32(1.0) / f32(n)

    def outer(a_tile, b_tile):  # (D, len) x (DV, len) -> (D, DV), as the lanes sum
        parts = [np.zeros((a_tile.shape[0], b_tile.shape[0]), f32)
                 for _ in range(cfg.splits)]
        for sp in range(cfg.splits):
            for i in range(sp, a_tile.shape[1], cfg.splits):
                parts[sp] = parts[sp] + np.outer(a_tile[:, i], b_tile[:, i]).astype(f32)
        off = cfg.splits // 2
        while off:  # the butterfly: lane l adds lane l ^ off's partial
            parts = [parts[l] + parts[l ^ off] for l in range(cfg.splits)]
            off //= 2
        return parts[0]

    out = [np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)]
    for h in range(bh):
        qh, kh, vh, gh = (x[h].T.astype(f32) for x in (q, k, v, g))  # (rows, N) tiles
        tiles = [(t * cfg.tile, min(cfg.tile, n - t * cfg.tile)) for t in range(cfg.tiles)]
        kv = np.zeros((d, dv), f32)
        ksum = np.zeros(d, f32)
        for n0, ln in tiles:  # pass 1
            sl = slice(n0, n0 + ln)
            kv += outer(kh[:, sl], vh[:, sl])
            ksum += kh[:, sl].sum(axis=1, dtype=f32)
        kv *= inv_n
        m = ksum * inv_n
        dkv = np.zeros((d, dv), f32)
        dm = np.zeros(d, f32)
        for n0, ln in tiles:  # pass 2
            sl = slice(n0, n0 + ln)
            qt, gt = qh[:, sl], gh[:, sl]
            t = kv @ gt                                  # (D, len): t_n = kv g_n
            r = f32(1.0) / ((qt * m[:, None]).sum(axis=0, dtype=f32) + f32(eps))
            b = -r * r * (qt * t).sum(axis=0, dtype=f32)  # -r (g_n . o_n)
            out[0][h, sl] = (r * t + b * m[:, None]).T    # dq_n = r t_n + b m
            dkv += outer(qt, r * gt)                      # a_n = r g_n
            dm += (qt * b).sum(axis=1, dtype=f32)
        dkv *= inv_n
        dm *= inv_n
        for n0, ln in tiles:  # pass 3
            sl = slice(n0, n0 + ln)
            out[1][h, sl] = (dkv @ vh[:, sl] + dm[:, None]).T  # s2 dKV v_n + dm / N
            out[2][h, sl] = (dkv.T @ kh[:, sl]).T              # s2 dKV^T k_n
    return out


@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("bh,n,d,dv", SHAPES, ids=IDS)
def test_kernel_transcription_matches_jax_vjp(bh, n, d, dv, layout):
    q, k, v, g = _qkvg(bh, n, d, dv, seed=1)
    got = transcribe_kernel(q, k, v, g, layout)
    for name, a, b in zip("qkv", got, _jax_vjp(jax_kv_first, q, k, v, g)):
        _close(a, b, f"d{name}")


def test_kernel_transcription_tiles_a_long_head():
    """A head of more positions than one tile (N = 300 at D = DV = 128: 13 tiles of
    24) walks every pass tile by tile."""
    q, k, v, g = _qkvg(1, 300, 128, 128, seed=2)
    assert B.launch_config(300, 128, 128, 4, "n").tiles > 2
    got = transcribe_kernel(q, k, v, g)
    for name, a, b in zip("qkv", got, _jax_vjp(jax_kv_first, q, k, v, g)):
        _close(a, b, f"d{name}")


LAYOUT_SHAPES = [(n, d, dv) for _, n, d, dv in SHAPES] + [
    (784, 128, 128), (3136, 24, 24), (5, 7, 128), (127, 128, 1), (1, 1, 1)]


@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n,d,dv", LAYOUT_SHAPES)
def test_launch_config_fits_and_divides_its_block(n, d, dv, elem_bytes, layout):
    cfg = B.launch_config(n, d, dv, elem_bytes, layout)
    geo = dict(zip(B.GEOMETRY_FIELDS, cfg.geometry))
    assert cfg.smem_bytes == 4 * geo["floats"] <= MAX_SMEM_BYTES
    assert cfg.team in (32, 64, 128, 256) and cfg.team == B.team_size(n)
    # the lanes of an outer-product block are consecutive lanes of one warp, and the
    # block items fill whole groups of them
    assert cfg.splits in (1, 2, 4, 8, 16, 32) and cfg.team % cfg.splits == 0
    blocks = -(-d // B.BLOCK) * -(-dv // B.BLOCK)
    assert cfg.splits == 1 or cfg.splits * blocks <= cfg.team
    # the tiles cover N, the last one not empty, each of at most MAX_TILE positions
    assert (cfg.tiles - 1) * cfg.tile < n <= cfg.tiles * cfg.tile
    assert cfg.tile <= B.MAX_TILE and geo["tp"] % 2 == 1 and geo["tp"] >= cfg.tile
    assert geo["n_fastest"] == (layout == "n")
    # the regions: in order, 16-byte aligned, disjoint, each its size
    dp, dvp, tp = geo["dp"], geo["dvp"], geo["tp"]
    assert dp % B.BLOCK == dvp % B.BLOCK == 0 and dp >= d and dvp >= dv
    sizes = {"mt": dv * dp, "mk": d * dvp, "vm": dp, "vdm": dp, "ta": dp * tp,
             "tb": dvp * tp, "tt": dp * tp, "tr": tp, "tbn": tp}
    names = list(sizes)
    for a, b in zip(names, names[1:] + ["floats"]):
        assert geo[a] % 4 == 0 and geo[a] + sizes[a] <= geo[b], (a, b)


def test_launch_config_takes_the_fewest_tiles_that_fit():
    assert B.launch_config(784, 24, 24, 2, "n")[:4] == (256, 112, 7, 16)
    assert B.launch_config(196, 24, 24, 2, "n")[:4] == (128, 98, 2, 8)
    assert B.launch_config(49, 24, 24, 2, "n")[:4] == (64, 49, 1, 4)
    assert B.launch_config(16, 24, 24, 2, "n")[:4] == (32, 16, 1, 2)
    # the largest D and DV: the two matrices take 128 KB, the tiles what is left
    big = B.launch_config(784, 128, 128, 4, "d")
    assert big.tiles > -(-784 // B.MAX_TILE)
    assert 4 * B._layout(784, 128, 128, -(-784 // (big.tiles - 1)))["floats"] > MAX_SMEM_BYTES


@pytest.mark.parametrize("n,d,dv,elem_bytes,layout,match", [
    (16, 129, 24, 2, "n", "D=129"), (16, 24, 129, 4, "d", "DV=129"), (0, 8, 8, 2, "n", "N=0"),
    (16, 0, 8, 2, "n", "D=0"), (16, 8, 8, 2, "x", "layout"), (16, 8, 8, 8, "n", "8-byte")])
def test_launch_config_refuses_what_the_kernel_does_not_take(n, d, dv, elem_bytes, layout,
                                                             match):
    with pytest.raises(ValueError, match=match):
        B.launch_config(n, d, dv, elem_bytes, layout)


def test_backward_entries_on_cpu_are_the_plain_version():
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(3, 20, 8, 12, seed=3))
    before = A.linear_attention_backward.launches
    got = A.linear_attention_backward(q, k, v, g)
    want = A.linear_attention_backward_plain(q, k, v, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert A.linear_attention_backward.launches == before  # no kernel ran


@pytest.mark.parametrize("variant", [1, 2])
def test_cpu_entries_differentiate_the_plain_version_and_the_function_takes_cuda_only(
        variant):
    """On CPU tensors under grad, the NCHW entry is the plain version of ``variant``
    under autograd (the Function is not in the graph); the Function and the NCHW
    backward refuse CPU tensors before any launch. The Function's gradients are held
    against autograd over the plain version on the card (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(4)
    qk = torch.from_numpy(np.abs(rng.normal(size=(2, 2 * 3 * 8, 5, 6))).astype(np.float32) + .1)
    v = torch.from_numpy(rng.normal(size=(2, 3 * 10, 5, 6)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 3 * 10, 5, 6)).astype(np.float32))
    qk.requires_grad_()
    v.requires_grad_()
    out = A.linear_attention_nchw(qk, v, 3, variant=variant)
    assert "LinearAttentionFunction" not in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (qk, v), g)
    want = torch.autograd.grad(A.linear_attention_nchw_plain(qk, v, 3, variant=variant),
                               (qk, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    before = (A.linear_attention_fused.launches, A.linear_attention_backward.launches)
    with pytest.raises(ValueError, match="CUDA"):
        A.LinearAttentionFunction.apply(3, EPS, qk, v)
    with pytest.raises(ValueError, match="CUDA"):
        A.linear_attention_nchw_backward(qk.detach(), v.detach(), g, 3)
    assert (A.linear_attention_fused.launches, A.linear_attention_backward.launches) == before


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _perturbed(variables, seed=4):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(a.dtype),
                        variables)


def _compare_gradients(jax_module, port_module, x):
    """Train mode (batch statistics), f32: the gradient of sum(out * r) with respect
    to every parameter and the input, through the flax module under ``jax.grad`` and
    through the port's module under autograd, from the same weights."""
    variables = _perturbed(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    stats = variables["batch_stats"]
    port_module.load_state_dict(jax_to_torch(variables, port_module), strict=True)
    port_module.train()
    out_shape = jax.eval_shape(lambda: jax_module.apply(variables, jnp.asarray(x))).shape
    r = np.random.default_rng(7).normal(size=out_shape).astype(np.float32)

    def loss(params, xj):
        out, _ = jax_module.apply({"params": params, "batch_stats": stats}, xj,
                                  training=True, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(r))

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    want = jax_to_torch({"params": gp, "batch_stats": stats}, port_module)
    xt = _nchw(x).requires_grad_()
    (port_module(xt) * _nchw(r)).sum().backward()
    _close(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(gx), "input")
    names = [name for name, _ in port_module.named_parameters()]
    assert names
    for name, p in port_module.named_parameters():
        w = want[name].numpy()
        if np.abs(w).max() < 1e-6:  # a shift that a train-mode BatchNorm follows
            assert np.abs(p.grad.numpy()).max() < 1e-5, name
            continue
        _close(p.grad.numpy(), w, name)


@pytest.mark.parametrize("variant", [1, 2])
def test_linear_attention_module_gradients_match_flax(variant):
    x = np.random.default_rng(8).normal(size=(2, 7, 7, 16)).astype(np.float32)
    _compare_gradients(JaxLinearAttention(num_heads=2, variant=variant),
                       LinearAttention(16, 2, variant), x)


@pytest.mark.parametrize("variant,side", [(1, 8), (2, 7)])
def test_rec_attn2d_gradients_match_flax(variant, side):
    x = np.random.default_rng(9).normal(size=(2, side, side, 16)).astype(np.float32)
    _compare_gradients(JaxRecAttn2d(num_heads=4, la_variant=variant),
                       RecAttn2d(16, 4, la_variant=variant), x)
