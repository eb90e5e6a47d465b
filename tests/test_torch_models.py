"""The port's M-family model against the JAX package's, on the same weights:
a JAX init (BN statistics perturbed) carried across with jax_to_torch, logits and
the four feature maps compared; BN fusion and the fused model likewise. The
``check_*`` helpers take the model's name; tests/test_torch_models_a.py runs them
on the A family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.convert import flax_fused_to_torch, flax_to_torch
from recnext_tpu.fusion import fuse_params as jax_fuse_params
from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu_torch.convert import jax_fused_to_torch, jax_to_torch
from recnext_tpu_torch.fusion import fuse_params
from recnext_tpu_torch.models.registry import create_model

# a small M config (tests/test_serve.py's); tolerance of tests/test_models.py:73
OVR = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)
ATOL, RTOL = 2e-4, 1e-4


def init_jax_variables(name):
    model = jax_create_model(name, **OVR)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x)
    # non-trivial BN statistics (and params) so the mapping and the fold are exercised
    return jax.tree.map(
        lambda v: v + 0.05 * np.random.default_rng(3).normal(size=v.shape).astype(v.dtype),
        variables)


@pytest.fixture(scope="module")
def jax_variables():
    return init_jax_variables("recnext_m0")


def _port_model(fused=False, name="recnext_m0"):
    return create_model(name, fused=fused, device="cpu", **OVR)


def _image(size, seed=0):
    return np.random.default_rng(seed).normal(size=(2, size, size, 3)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def check_logits_and_features(jax_variables, name, size, scale_logit_atol=False, jit=False):
    """``jit``: the JAX logits and maps from one jitted call (op by op otherwise: a
    jitted m0 rounds one logit at 60^2 beyond ATOL)."""
    model = _port_model(name=name)
    model.load_state_dict(jax_to_torch(jax_variables, model), strict=True)
    x = _image(size)
    jm = jax_create_model(name, **OVR)

    def reference(v, x):
        return jm.apply(v, x), jm.apply(v, x, method=jm.features)

    want, want_feats = (jax.jit(reference) if jit else reference)(jax_variables, jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
        feats = model.features(_nchw(x))
    # with scale_logit_atol the logits' atol scales with the largest, as the maps' does
    atol = ATOL * max(1.0, np.abs(want).max()) if scale_logit_atol else ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL)
    assert len(feats) == len(want_feats) == 4
    for f, wf in zip(feats, want_feats):
        # the maps reach ~1e3: fp32 sums in another order differ in proportion to
        # the map's largest value, so atol scales with it
        wf = np.asarray(wf)
        np.testing.assert_allclose(_nhwc(f), wf, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(wf).max()))


@pytest.mark.parametrize("size", [64, 60])
def test_logits_and_features_match_jax(jax_variables, size):
    check_logits_and_features(jax_variables, "recnext_m0", size)


def check_jax_to_torch(jax_variables):
    got = jax_to_torch(jax_variables)
    want = flax_to_torch(jax_variables)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_jax_to_torch_equals_flax_to_torch(jax_variables):
    check_jax_to_torch(jax_variables)


def test_jax_to_torch_rejects_a_mismatched_model(jax_variables):
    other = create_model("recnext_m0", device="cpu", **{**OVR, "depth": (1, 1, 1, 1)})
    with pytest.raises(ValueError, match="does not match"):
        jax_to_torch(jax_variables, other)


def check_fuse_params(jax_variables, name):
    got = fuse_params(jax_to_torch(jax_variables))
    want = flax_fused_to_torch(jax_fuse_params(jax_variables))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6, atol=1e-6, err_msg=k)
    # the port's fused layout is exactly what its fused model holds
    fused = _port_model(fused=True, name=name)
    fused.load_state_dict(got, strict=True)
    assert fused.state_dict().keys() == got.keys()


def test_fuse_params_equals_jax_fusion(jax_variables):
    check_fuse_params(jax_variables, "recnext_m0")


def check_fused_model(jax_variables, name, jit=False):
    """``jit``: the JAX fused logits from a jitted call (op by op otherwise)."""
    jfused = jax_fuse_params(jax_variables)
    model = _port_model(fused=True, name=name)
    model.load_state_dict(fuse_params(jax_to_torch(jax_variables)), strict=True)
    x = _image(64, seed=1)
    apply = jax_create_model(name, fused=True, **OVR).apply
    want = np.asarray((jax.jit(apply) if jit else apply)(jfused, jnp.asarray(x)))
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # and the JAX fused tree carried across directly gives the same model
    direct = _port_model(fused=True, name=name)
    direct.load_state_dict(jax_fused_to_torch(jfused, direct), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(direct(_nchw(x)).numpy(), want, atol=ATOL, rtol=RTOL)


def test_fused_model_matches_jax_fused_apply(jax_variables):
    check_fused_model(jax_variables, "recnext_m0")
