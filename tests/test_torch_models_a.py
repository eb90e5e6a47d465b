"""The port's A-family model against the JAX package's, on the same weights: the
checks of tests/test_torch_models.py (logits and feature maps, converters, BN
fusion, the fused model) on a small A config, and recnext_a1's structure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu_torch.models.mixers import LinearAttention
from recnext_tpu_torch.models.registry import create_model
from tests.test_torch_models import (
    check_fuse_params,
    check_fused_model,
    check_jax_to_torch,
    check_logits_and_features,
    init_jax_variables,
)

NAME = "recnext_a0"  # with the small widths and depths of tests/test_torch_models.py


@pytest.fixture(scope="module")
def jax_variables():
    return init_jax_variables(NAME)


@pytest.mark.parametrize("size", [64, 60])
def test_a_logits_and_features_match_jax(jax_variables, size):
    # the A logits reach ~1.5e3 and some cancel to ~1: fp32 sums in another order
    # (the JAX package's block-diagonal attention, other conv orders) differ there by
    # ~4e-7 of the largest logit, so atol scales with it
    check_logits_and_features(jax_variables, NAME, size, scale_logit_atol=True)


def test_a_jax_to_torch_equals_flax_to_torch(jax_variables):
    check_jax_to_torch(jax_variables)


def test_a_fuse_params_equals_jax_fusion(jax_variables):
    check_fuse_params(jax_variables, NAME)


def test_a_fused_model_matches_jax_fused_apply(jax_variables):
    check_fused_model(jax_variables, NAME)


def test_a1_builds_as_the_jax_package_defines_it():
    model = create_model("recnext_a1", device="cpu")
    attns = [m for m in model.modules() if isinstance(m, LinearAttention)]
    # one RecAttn2d per block: heads 2**(stage+1), the qk-first variant at stage 3
    assert [(a.num_heads, a.variant) for a in attns] == (
        [(2, 1)] * 3 + [(4, 1)] * 3 + [(8, 1)] * 15 + [(16, 2)] * 2)
    jm = jax_create_model("recnext_a1")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want
