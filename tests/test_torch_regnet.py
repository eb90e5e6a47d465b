"""The port's RegNetY teacher against the JAX package's: the width rule and stage
derivation, regnety_160's parameter count, the logits in eval mode on the same
weights (JAX -> port through ``jax_regnet_to_torch``, port -> JAX through the JAX
package's ``regnety_torch_to_flax``), and every state-dict key against the JAX
package's timm key map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.convert import _map_key_regnety, regnety_torch_to_flax
from recnext_tpu.models import regnet as jregnet
from recnext_tpu_torch.convert import jax_regnet_to_torch
from recnext_tpu_torch.models import regnet as tregnet
from recnext_tpu_torch.models.recnext import init_weights
from recnext_tpu_torch.train.step import make_teacher_apply

TINY = dict(name="tiny", w0=24, wa=24.0, wm=2.0, depth=4, group_width=8, stem_width=16,
            num_classes=11)  # tests/test_regnet.py:116's config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["regnety_016", "regnety_040", "regnety_160"])
def test_stage_derivation_matches_jax(name):
    assert tregnet.REGNET_CONFIGS[name].stages() == jregnet.REGNET_CONFIGS[name].stages()
    for field in ("w0", "wa", "wm", "depth", "group_width", "stem_width", "bottle_ratio",
                  "se_ratio", "num_classes"):
        assert getattr(tregnet.REGNET_CONFIGS[name], field) == getattr(
            jregnet.REGNET_CONFIGS[name], field), field


def test_regnety_160_has_83_59m_parameters():
    model = tregnet.RegNetY(tregnet.REGNET_CONFIGS["regnety_160"])
    n = sum(p.numel() for p in model.parameters())
    assert n / 1e6 == pytest.approx(83.59, abs=0.005)  # timm regnety_160: 83.6M
    assert tregnet.REGNET_CONFIGS["regnety_160"].stages()[0] == [224, 448, 1232, 3024]


def _jax_tiny():
    model = jregnet.RegNetY(cfg=jregnet.RegNetConfig(**TINY))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(3)
    # non-trivial eval-mode BN: statistics and affine moved off (0, 1)
    stats = jax.tree.map(lambda a: a + 0.3 * np.abs(rng.normal(size=a.shape)).astype(a.dtype),
                         variables["batch_stats"])
    params = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(a.dtype),
                          variables["params"])
    return model, {"params": params, "batch_stats": stats}


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(2, 32, 32, 3)).astype(np.float32)


def test_logits_match_jax_on_carried_weights():
    jmodel, variables = _jax_tiny()
    port = tregnet.RegNetY(tregnet.RegNetConfig(**TINY)).eval()
    port.load_state_dict(jax_regnet_to_torch(variables, port), strict=True)
    x = _x()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), training=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (2, 11)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_teacher_in_bf16_matches_jax_in_bf16_with_an_fp32_classifier():
    """The train step's teacher (``make_teacher_apply`` at bf16) against the JAX
    package's RegNetY(dtype=bfloat16) on the same weights: within 1e-2 max|ref| (bf16
    convs on both sides, rounded in other orders; 5e-3 seen, where JAX's bf16 and f32
    models differ by 1.7e-2). As JAX's ``head_fc``, the classifier takes the fp32 mean
    of the body's bf16 output and its fp32 weights: the logits are that product to
    the bit."""
    _, variables = _jax_tiny()
    jmodel = jregnet.RegNetY(cfg=jregnet.RegNetConfig(**TINY), dtype=jnp.bfloat16)
    port = tregnet.RegNetY(tregnet.RegNetConfig(**TINY)).eval()
    port.load_state_dict(jax_regnet_to_torch(variables, port), strict=True)
    feats = []
    port.head.register_forward_hook(lambda mod, args, out: feats.append(args[0]))
    for seed in range(3):
        x = _x(seed)
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x), training=False))
        got = make_teacher_apply(port, torch.bfloat16)(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        assert got.dtype == torch.float32 and feats[-1].dtype == torch.bfloat16
        assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()
        head = torch.nn.functional.linear(feats[-1].float().mean(dim=(2, 3)),
                                          port.head.fc.weight, port.head.fc.bias)
        assert torch.equal(got, head)
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_port_state_dict_maps_onto_every_jax_leaf():
    """Each key of the port's state dict goes through the JAX package's timm key map
    onto a JAX leaf of the same shape, and together they cover every leaf."""
    jmodel, variables = _jax_tiny()
    port = tregnet.RegNetY(tregnet.RegNetConfig(**TINY))
    leaves = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[col])[0]:
            leaves[(col, tuple(p.key for p in path))] = leaf.shape
    seen = set()
    for key, t in port.state_dict().items():
        mapped = _map_key_regnety(key)
        if mapped is None:
            assert key.endswith("num_batches_tracked")
            continue
        path, col, tr = mapped
        shape = tuple(t.shape)
        if tr == "conv":
            shape = (shape[2], shape[3], shape[1], shape[0])  # OIHW -> HWIO
        elif tr == "linear":
            shape = shape[::-1]
        assert leaves[(col, path)] == shape, key
        seen.add((col, path))
    assert seen == set(leaves)


def test_port_weights_give_the_same_logits_in_jax():
    """The port's own weights (its seeded initialisation, BN statistics moved off
    (0, 1)), through the JAX package's converter for the published timm checkpoint:
    the JAX model gives the port's logits."""
    model = init_weights(tregnet.RegNetY(tregnet.RegNetConfig(**TINY)),
                         torch.Generator().manual_seed(2)).eval()
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=g))
    x = _x(seed=4)
    with torch.no_grad():
        want = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    fvars = regnety_torch_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    jmodel = jregnet.RegNetY(cfg=jregnet.RegNetConfig(**TINY))
    got = np.asarray(jmodel.apply(fvars, jnp.asarray(x), training=False))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_create_regnet_builds_a_seeded_eval_model_and_refuses_an_unknown_name():
    a = tregnet.create_regnet("regnety_016", device="cpu", num_classes=7,
                              generator=torch.Generator().manual_seed(5))
    b = tregnet.create_regnet("regnety_016", device="cpu", num_classes=7,
                              generator=torch.Generator().manual_seed(5))
    assert not a.training and a.head.fc.out_features == 7
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    with pytest.raises(KeyError, match="regnety_999"):
        tregnet.create_regnet("regnety_999", device="cpu")


def test_create_regnet_runs_on_the_gpu_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tregnet.create_regnet("regnety_016")
