"""The port's torch -> JAX converters (``convert.py:torch_to_jax``,
``mlla_torch_to_jax``) against the JAX package: JAX -> torch -> JAX is the identity
on keys and values for recnext_m0, recnext_a0, a small recnext_t and mlla_nano (each
variant), unfused and fused; the forward direction agrees with the JAX package's own
``torch_to_flax`` / ``torch_fused_to_flax`` / ``mlla_torch_to_flax``; and the JAX
models applied to the round-tripped variables give the original logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recnext_tpu.convert import mlla_torch_to_flax, torch_fused_to_flax, torch_to_flax
from recnext_tpu.fusion import fuse_params as jax_fuse_params
from recnext_tpu.models import mlla as jmlla
from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu_torch.convert import (jax_fused_to_torch, jax_mlla_to_torch, jax_to_torch,
                                       mlla_torch_to_jax, torch_to_jax)

SMALL = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)
RECNEXT = {"recnext_m0": SMALL, "recnext_a0": SMALL,
           "recnext_t": dict(SMALL, depth=(0, 1, 2, 1), drop_path=0.0)}
MLLA = ["recconv", "recattn", "recattn_simple"]


def _drawn(model, side):
    """Variables of the model's shapes drawn from numpy (no init to compile), none at
    a default value: kernels at a fan-in scale, scales near 1, positive variances."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)))
    rng = np.random.default_rng(3)

    def draw(path, a):
        name, n = path[-1].key, rng.normal(size=a.shape)
        if name.endswith("kernel"):
            n = n / np.sqrt(np.prod(a.shape[:-1]))
        elif name in ("scale", "var"):
            n = 1 + 0.1 * (np.abs(n) if name == "var" else n)
        else:
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _same_tree(got, want, what=""):
    assert isinstance(got, dict) and set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        if isinstance(w, dict):
            _same_tree(got[k], w, f"{what}/{k}")
        else:
            g = got[k]
            assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w)), f"{what}/{k}"


def _image(side):
    return jnp.asarray(np.random.default_rng(5).normal(size=(2, side, side, 3)), jnp.float32)


@pytest.fixture(scope="module", params=sorted(RECNEXT))
def recnext(request):
    """(name, variables, fused params, the jitted unfused and fused applies, their
    logits on the variables)."""
    name = request.param
    jm = jax_create_model(name, **RECNEXT[name])
    v = _drawn(jm, 32)
    fused = jax_fuse_params(v)
    jf = jax_create_model(name, fused=True, **RECNEXT[name])
    apply, apply_fused = jax.jit(jm.apply), jax.jit(jf.apply)
    x = _image(32)
    return name, v, fused, (apply, apply_fused), (np.asarray(apply(v, x)),
                                                  np.asarray(apply_fused(fused, x)))


def test_unfused_round_trip_is_the_identity(recnext):
    name, v, _, (apply, _), (want, _) = recnext
    back = torch_to_jax(jax_to_torch(v))
    _same_tree(back, jax.tree.map(np.asarray, v), name)
    # the JAX package's own torch -> flax reading of the port's state dict agrees
    _same_tree(back, torch_to_flax({k: t.numpy() for k, t in jax_to_torch(v).items()}), name)
    assert np.array_equal(np.asarray(apply(back, _image(32))), want)


def test_fused_round_trip_is_the_identity(recnext):
    name, _, fused, (_, apply_fused), (_, want_fused) = recnext
    family = name[len("recnext_")][0]
    state = jax_fused_to_torch(fused)
    back = torch_to_jax(state, fused=True, family=family)
    _same_tree(back, jax.tree.map(np.asarray, fused), name)
    _same_tree(back, torch_fused_to_flax({k: t.numpy() for k, t in state.items()},
                                         family=family), name)
    assert np.array_equal(np.asarray(apply_fused(back, _image(32))), want_fused)


@pytest.mark.parametrize("variant", MLLA)
def test_mlla_round_trip_is_the_identity(variant):
    cfg = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 16),
               expansion_ratio=2.5 if variant == "recconv" else 2.0, num_classes=10,
               img_size=64)  # tests/test_torch_mlla.py:small_cfg
    jm = jmlla.MLLA(cfg=jmlla.MLLAConfig(name=f"small_{variant}", variant=variant, **cfg))
    v = _drawn(jm, 64)
    state = jax_mlla_to_torch(v)
    back = mlla_torch_to_jax(state)
    _same_tree(back, jax.tree.map(np.asarray, v), variant)
    _same_tree(back, mlla_torch_to_flax({k: t.numpy() for k, t in state.items()}), variant)
    apply = jax.jit(jm.apply)
    x = _image(64)
    assert np.array_equal(np.asarray(apply(back, x)), np.asarray(apply(v, x)))


def test_an_unknown_key_is_refused():
    with pytest.raises(KeyError, match="unmapped"):
        torch_to_jax({"stem.stem.0.foo.weight": np.zeros(3, np.float32)})
