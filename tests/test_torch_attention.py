"""The port's linear attention against the JAX package's: the plain kv-first and
qk-first versions, the Pallas kernel (interpret mode), the feature maps, the NCHW
head entry against ``linear_attention_blockdiag``, and the LinearAttention and
RecAttn2d mixers against the flax modules on the same weights. Inputs are made
with numpy and handed to both; NHWC <-> NCHW is explicit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.models.mixers import LinearAttention as JaxLinearAttention
from recnext_tpu.models.mixers import RecAttn2d as JaxRecAttn2d
from recnext_tpu.ops.attention import feature_map as jax_feature_map
from recnext_tpu.ops.attention import linear_attention_blockdiag
from recnext_tpu.ops.attention import linear_attention_kv_first as jax_kv_first
from recnext_tpu.ops.attention import linear_attention_qk_first as jax_qk_first
from recnext_tpu.ops.pallas.linear_attention import pallas_linear_attention
from recnext_tpu_torch.convert import jax_to_torch
from recnext_tpu_torch.models.mixers import LinearAttention, RecAttn2d
from recnext_tpu_torch.ops.attention import (
    feature_map,
    linear_attention_fused,
    linear_attention_kv_first,
    linear_attention_nchw,
    linear_attention_nchw_plain,
    linear_attention_qk_first,
)

# tests/test_pallas.py:29-34's shapes (odd n, odd d, dv != d) and its tolerance
ATTN_SHAPES = [(2, 16, 32, 32), (4, 64, 64, 64), (2, 49, 20, 20), (2, 196, 20, 40)]
TOL = 1e-3


def _qkv(bh, n, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    # elu(x)+1 features are positive: so are q and k here, as in tests/test_pallas.py
    q = np.abs(rng.normal(size=(bh, n, d))).astype(np.float32) + 0.1
    k = np.abs(rng.normal(size=(bh, n, d))).astype(np.float32) + 0.1
    v = rng.normal(size=(bh, n, dv)).astype(np.float32)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a: np.ndarray) -> torch.Tensor:
    return _t(a.transpose(0, 3, 1, 2))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("bh,n,d,dv", ATTN_SHAPES)
def test_plain_attention_matches_jax_and_pallas(bh, n, d, dv):
    q, k, v = _qkv(bh, n, d, dv)
    kv = linear_attention_kv_first(_t(q), _t(k), _t(v)).numpy()
    qk = linear_attention_qk_first(_t(q), _t(k), _t(v)).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = np.asarray(pallas_linear_attention(jq, jk, jv, interpret=True))
    for got in (kv, qk):
        assert got.shape == (bh, n, dv)
        np.testing.assert_allclose(got, np.asarray(jax_kv_first(jq, jk, jv)), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, np.asarray(jax_qk_first(jq, jk, jv)), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("form", ["kv_first", "qk_first"])
def test_plain_attention_bf16_rounds_as_jax_does(form):
    """In bf16 both packages round the scaled operands (and kv) to bf16 at the same
    places and accumulate in fp32; they differ by the sums' order only."""
    q, k, v = _qkv(4, 49, 24, 24, seed=1)
    port = {"kv_first": linear_attention_kv_first, "qk_first": linear_attention_qk_first}[form]
    ref = {"kv_first": jax_kv_first, "qk_first": jax_qk_first}[form]
    got = port(*(_t(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    # bf16 keeps 8 bits: one rounding of the output apart at most (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["elu", "softplus", "relu"])
def test_feature_map_matches_jax(kind):
    x = np.random.default_rng(2).normal(scale=3.0, size=(2, 8, 5, 5)).astype(np.float32)
    want = np.asarray(jax_feature_map(jnp.asarray(x), kind))
    np.testing.assert_allclose(feature_map(_t(x), kind).numpy(), want, rtol=1e-6, atol=1e-6)


# (batch, heads, head width, side, variant): the small A config's stages and an
# a1 stage-0 head width (24)
NCHW_CASES = [(2, 2, 8, 7, 1), (2, 4, 8, 14, 1), (2, 16, 8, 4, 2), (1, 2, 24, 28, 1),
              (2, 8, 24, 7, 2)]


@pytest.mark.parametrize("b,nh,hd,side,variant", NCHW_CASES)
def test_nchw_entry_matches_blockdiag(b, nh, hd, side, variant):
    rng = np.random.default_rng(3)
    c = nh * hd
    qk = np.abs(rng.normal(size=(b, side, side, 2 * c))).astype(np.float32) + 0.1
    v = rng.normal(size=(b, side, side, c)).astype(np.float32)
    want = np.asarray(linear_attention_blockdiag(jnp.asarray(qk), jnp.asarray(v), nh))
    got = linear_attention_nchw(_nchw(qk), _nchw(v), nh, variant=variant)
    assert got.shape == (b, c, side, side)
    np.testing.assert_allclose(_nhwc(got), want, rtol=TOL, atol=TOL)


def test_fused_entries_on_cpu_are_the_plain_versions():
    q, k, v = (_t(a) for a in _qkv(4, 49, 8, 8))
    qk = _t(np.abs(np.random.default_rng(7).normal(size=(2, 32, 7, 7))).astype(np.float32))
    vv = _t(np.random.default_rng(8).normal(size=(2, 16, 7, 7)).astype(np.float32))
    before = linear_attention_fused.launches
    got = linear_attention_fused(q, k, v)
    torch.testing.assert_close(got, linear_attention_kv_first(q, k, v), rtol=0, atol=0)
    for variant in (1, 2):
        torch.testing.assert_close(
            linear_attention_nchw(qk, vv, 2, variant=variant),
            linear_attention_nchw_plain(qk, vv, 2, variant=variant), rtol=0, atol=0)
    assert linear_attention_fused.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="variant 3"):
        linear_attention_nchw(qk, vv, 2, variant=3)


def _perturbed(variables, seed=4):
    """Non-trivial BN statistics (and params), so the mapping and the BN are exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(a.dtype),
                        variables)


def _compare_module(jax_module, port_module, x):
    variables = _perturbed(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port_module.load_state_dict(jax_to_torch(variables, port_module), strict=True)
    port_module.eval()
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(port_module(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4 * max(1.0, np.abs(want).max()))
    return port_module


@pytest.mark.parametrize("variant", [1, 2])
def test_linear_attention_module_matches_flax(variant):
    x = np.random.default_rng(5).normal(size=(2, 7, 7, 16)).astype(np.float32)
    module = _compare_module(JaxLinearAttention(num_heads=2, variant=variant),
                             LinearAttention(16, 2, variant), x)
    with torch.no_grad():  # on the CPU the plain path is the same computation
        torch.testing.assert_close(module(_nchw(x)), module.forward_plain(_nchw(x)),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("variant,side,kernel", [(1, 8, "elu"), (2, 7, "elu"),
                                                 (1, 9, "softplus")])
def test_rec_attn2d_matches_flax(variant, side, kernel):
    x = np.random.default_rng(6).normal(size=(2, side, side, 16)).astype(np.float32)
    _compare_module(JaxRecAttn2d(num_heads=4, la_variant=variant, kernel=kernel),
                    RecAttn2d(16, 4, la_variant=variant, kernel=kernel), x)
