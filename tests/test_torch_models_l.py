"""The port's L family (recnext_t/s/b and their share-channel variants) against the
JAX package's, on the same weights: a JAX init with its BatchNorms calibrated on a
batch, carried across with jax_to_torch. Logits and the four feature maps at 128^2,
BN fusion leaf by leaf and the fused model, the fused -> unfused round trip, the
converters' keys at full width for all six names, the drop-path rates, the
variant-3 attention (LA3) on its own and on a channel slice of its input, and the
share-channel blocks under remat."""

import functools
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.convert import flax_fused_to_torch, flax_to_torch
from recnext_tpu.fusion import defuse_params as jax_defuse_params
from recnext_tpu.fusion import fuse_params as jax_fuse_params
from recnext_tpu.models.mixers import LinearAttention as JaxLinearAttention
from recnext_tpu.models.recnext import _drop_path_rates as jax_drop_path_rates
from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu.models.registry import get_config as jax_get_config
from recnext_tpu_torch.convert import jax_fused_to_torch, jax_to_torch
from recnext_tpu_torch.fusion import defuse_params, fuse_params
from recnext_tpu_torch.models.layers import DropPath
from recnext_tpu_torch.models.mixers import LinearAttention
from recnext_tpu_torch.models.recnext import DownsampleL, MetaNeXtBlockL, _drop_path_rates
from recnext_tpu_torch.models.registry import create_model, get_config
from recnext_tpu_torch.ops import attention as attn_ops
from recnext_tpu_torch.ops.cuda import linear_attention as attention_cuda

L_NAMES = ["recnext_t", "recnext_s", "recnext_b", "recnext_t_share_channel",
           "recnext_s_share_channel", "recnext_b_share_channel"]
WIDTHS = (16, 32, 64, 128)
# small configs: a recnext_t-like depth (the stem's trailing GELU, LA2, LA3), a
# recnext_b-like one (LA1 at stage 0), and the latter with share_channel (LA3 from
# stage 2; stage 3's fifth block shares)
CONFIGS = {
    "t": ("recnext_t", dict(embed_dim=WIDTHS, depth=(0, 1, 2, 1), num_classes=11)),
    "b": ("recnext_b", dict(embed_dim=WIDTHS, depth=(1, 1, 2, 5), num_classes=11)),
    "b_share": ("recnext_b_share_channel",
                dict(embed_dim=WIDTHS, depth=(1, 1, 2, 5), num_classes=11)),
}
SIDE = 128
ATOL, RTOL = 2e-4, 1e-4  # tests/test_torch_models.py:22


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _image(n, side, seed):
    return np.random.default_rng(seed).normal(size=(n, side, side, 3)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def calibrated_jax_variables(name, overrides, side=SIDE):
    """The JAX init, every parameter moved off its init, and each BatchNorm's running
    statistics those of a batch of 8 (one train-mode apply from mean 0, var 1 at
    momentum 0.1, inverted): trained-like statistics, so the L family's residual
    branches keep the logits near 1 and the tolerance means what it says."""
    model = jax_create_model(name, **{**overrides, "drop_path": 0.0})  # no mask to draw
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda v: v + 0.05 * rng.normal(size=v.shape).astype(v.dtype),
                          variables["params"])
    _, upd = jax.jit(lambda v, x: model.apply(v, x, training=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": variables["batch_stats"]},
        jnp.asarray(_image(8, side, 7)))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) - (0.9 if path[-1].key == "var" else 0.0)) / 0.1,
        upd["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _jax_side(key):
    """The JAX side of a config, in a process of its own: the calibrated variables,
    the logits and features on ``_image(2, SIDE, 0)`` and the fused model's logits
    on ``_image(2, SIDE, 1)``, as numpy."""
    name, ovr = CONFIGS[key]
    variables = calibrated_jax_variables(name, ovr)
    jm = jax_create_model(name, **ovr)
    want, want_feats = jax.jit(lambda v, x: (jm.apply(v, x), jm.apply(v, x, method=jm.features)))(
        variables, jnp.asarray(_image(2, SIDE, 0)))
    fused = jax.jit(jax_create_model(name, fused=True, **ovr).apply)(
        jax_fuse_params(variables), jnp.asarray(_image(2, SIDE, 1)))
    return jax.device_get(dict(variables=variables, logits=want, features=want_feats,
                               fused_logits=fused))


@functools.lru_cache(maxsize=None)
def _jax_refs():
    """Every config's JAX side at once, each in a spawned process (their inits, train
    applies and jitted applies compile; in threads they would share one interpreter's
    lock), by model name."""
    keys = sorted(CONFIGS)
    with ProcessPoolExecutor(len(keys), mp_context=multiprocessing.get_context("spawn")) as pool:
        return {CONFIGS[k][0]: out for k, out in zip(keys, pool.map(_jax_side, keys))}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def config(request):
    name, ovr = CONFIGS[request.param]
    return name, ovr, _jax_refs()[name]["variables"]


def _port(name, ovr, variables=None, fused=False):
    model = create_model(name, fused=fused, device="cpu", **ovr)
    if variables is not None:
        convert = jax_fused_to_torch if fused else jax_to_torch
        model.load_state_dict(convert(variables, model), strict=True)
    return model


def test_l_logits_and_features_match_jax(config):
    name, ovr, variables = config
    x = _image(2, SIDE, 0)
    want, want_feats = _jax_refs()[name]["logits"], _jax_refs()[name]["features"]
    model = _port(name, ovr, variables)
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
        feats = model.features(_nchw(x))
    assert np.abs(want).max() < 1e2  # the calibration keeps the logits near 1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert len(feats) == len(want_feats) == 4
    for f, wf in zip(feats, want_feats):
        np.testing.assert_allclose(_nhwc(f), np.asarray(wf), atol=ATOL, rtol=RTOL)


def test_l_jax_to_torch_equals_flax_to_torch(config):
    _, _, variables = config
    got = jax_to_torch(variables)
    want = flax_to_torch(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_l_fuse_params_equals_jax_fusion(config):
    name, ovr, variables = config
    got = fuse_params(jax_to_torch(variables))
    want = flax_fused_to_torch(jax_fuse_params(variables), family="l")
    assert set(got) == set(want)
    assert any(k.endswith("rep_mixer.weight") for k in got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6, atol=1e-6, err_msg=k)
    fused = _port(name, ovr, fused=True)
    fused.load_state_dict(got, strict=True)
    assert fused.state_dict().keys() == got.keys()


def test_l_fused_model_matches_jax_fused_apply(config):
    name, ovr, variables = config
    jfused = jax_fuse_params(variables)
    x = _image(2, SIDE, 1)
    want = _jax_refs()[name]["fused_logits"]
    model = _port(name, ovr, fused=True)
    model.load_state_dict(fuse_params(jax_to_torch(variables)), strict=True)
    direct = _port(name, ovr, jfused, fused=True)  # the JAX fused tree carried across
    with torch.no_grad():
        for m in (model, direct):
            np.testing.assert_allclose(m(_nchw(x)).numpy(), want, atol=ATOL, rtol=RTOL)
        # and the fused model computes the unfused one's function
        np.testing.assert_allclose(model(_nchw(x)).numpy(),
                                   _port(name, ovr, variables)(_nchw(x)).numpy(),
                                   atol=ATOL, rtol=RTOL)


def test_l_defuse_round_trip(config):
    name, ovr, variables = config
    unfused = jax_to_torch(variables)
    fused = fuse_params(unfused)
    defused = defuse_params(fused, unfused)
    assert defused.keys() == unfused.keys()
    refused = fuse_params(defused)
    assert refused.keys() == fused.keys()
    for k, v in fused.items():
        np.testing.assert_allclose(refused[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # the JAX package's inverse embedding of its own fused tree, carried across
    jfused = jax_fuse_params(variables)
    want = jax_to_torch(jax_defuse_params(jfused["params"], variables))
    got = defuse_params(jax_fused_to_torch(jfused), unfused)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), v.float().numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    x = _nchw(_image(2, SIDE, 2))
    model = _port(name, ovr)
    model.load_state_dict(defused, strict=True)
    fused_model = _port(name, ovr, fused=True)
    fused_model.load_state_dict(fused, strict=True)
    with torch.no_grad():
        a, b = model(x), fused_model(x)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("name", L_NAMES)
def test_full_width_l_variables_load_strictly(name):
    """All six at full width and depth: the JAX init's variables (zeros of their
    shapes; keys and shapes are what is checked) converted load strictly into the
    unfused and the fused model, with exactly the JAX converters' keys."""
    jm = jax_create_model(name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables["batch_stats"] = jax.tree.map(np.ones_like, variables["batch_stats"])
    model = create_model(name, device="cpu")
    unfused = jax_to_torch(variables, model)
    model.load_state_dict(unfused, strict=True)
    assert unfused.keys() == flax_to_torch(variables, verify=False).keys()
    jfused = jax_fuse_params(variables)
    fused_model = create_model(name, fused=True, device="cpu")
    fused = jax_fused_to_torch(jfused, fused_model)
    fused_model.load_state_dict(fused, strict=True)
    assert fused.keys() == flax_fused_to_torch(jfused, family="l", verify=False).keys()
    assert fuse_params(unfused).keys() == fused.keys()
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("name", L_NAMES)
def test_drop_path_rates_match_jax(name):
    cfg = get_config(name)
    want = jax_drop_path_rates(jax_get_config(name))
    assert _drop_path_rates(cfg) == want
    assert want[-1][-1] == cfg.drop_path  # the ramp ends at the config's rate
    model = create_model(name, device="cpu")
    for i, stage in enumerate(model.stages):
        assert [b.drop_path.rate for b in stage.blocks] == want[i]
        if i:  # a downsample takes its stage's first rate, or 0 for an empty stage
            assert isinstance(stage.downsample, DownsampleL)
            assert stage.downsample.drop_path.rate == (want[i][0] if want[i] else 0.0)
    assert all(isinstance(m.rate, float) for m in model.modules() if isinstance(m, DropPath))


@pytest.mark.parametrize("name,launches", [("recnext_t", 20), ("recnext_b", 30),
                                           ("recnext_t_share_channel", 18)])
def test_l_structure(name, launches):
    """One linear attention (one K2 launch) per non-share block: recnext_t's heads
    and forms (1 head; qk-first LA2 at stages 1-2, LA3 at stage 3, D 64 and DV 128),
    the share stage's blocks, feature_info as the JAX config gives it."""
    model = create_model(name, device="cpu")
    attns = [m for m in model.modules() if isinstance(m, LinearAttention)]
    assert len(attns) == launches
    if name == "recnext_t":
        assert [(a.num_heads, a.variant) for a in attns] == [(1, 2)] * 10 + [(1, 3)] * 10
        assert attns[-1].qk.conv.weight.shape == (128, 128, 1, 1)
    if name == "recnext_t_share_channel":
        shares = [b.share for b in model.stages[3].blocks]
        assert shares == ["collect"] * 4 + ["share"] + ["collect"] * 4 + ["share"]
        assert [a.variant for a in attns] == [2] * 2 + [3] * 16
    assert get_config(name).feature_info() == jax_get_config(name).feature_info()
    assert get_config(name).feature_info()[0]["reduction"] == 8
    assert get_config("recnext_m1").feature_info() == jax_get_config("recnext_m1").feature_info()


@pytest.mark.parametrize("bias", [False, True])
def test_la3_module_matches_flax(bias):
    """LinearAttention variant 3 (1 head of D 8, DV 16) against the flax module."""
    x = np.random.default_rng(5).normal(size=(2, 4, 4, 16)).astype(np.float32)
    jm = JaxLinearAttention(num_heads=2, variant=3, use_bias=bias)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(4)
    variables = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(a.dtype),
                             variables)
    module = LinearAttention(16, 2, 3, bias=bias)
    module.load_state_dict(jax_to_torch(variables, module), strict=True)
    module.eval()
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = module(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got, module.forward_plain(_nchw(x)), rtol=0, atol=0)


def test_la3_reads_a_channel_slice_in_place():
    """LA3's v is x[:, :split], a channel slice whose batch stride is C*H*W: the NCHW
    entry's views of it (and of q, k and out) are views of the same memory, one span
    per head, and the kernel's strides carry the slice's batch stride. On the CPU the
    entry's plain version equals the JAX qk-first form on the same values."""
    rng = np.random.default_rng(6)
    b, c, side, split = 2, 64, 4, 16
    x = torch.from_numpy(rng.normal(size=(b, c, side, side)).astype(np.float32))
    v = x[:, :split]
    qk = torch.from_numpy(np.abs(rng.normal(size=(b, split, side, side))).astype(np.float32))
    q4, k4, v4, view = attn_ops._nchw_views(qk, v, 1)
    assert v4.data_ptr() == x.data_ptr() and v4._base is not None
    assert v4.stride()[:2] == (c * side * side, split * side * side)
    out = torch.empty(b, split, side, side)
    ts = (q4, k4, v4, view(out))
    assert attention_cuda.head_layout(*ts) == "n"
    _, strides, _ = attention_cuda._launch_args(
        tuple((tuple(t.shape), t.stride()) for t in ts), 4)
    assert list(strides)[4:6] == [c * side * side, split * side * side]
    g = torch.randn(b, split, side, side)
    assert attn_ops._one_span_per_head(lambda: (q4, k4, v4, view(g)))  # no copy for K2'
    got = attn_ops.linear_attention_nchw(qk, v, 1, variant=2)
    from recnext_tpu.ops.attention import linear_attention_qk_first

    d = split // 2
    qn, vn = _nhwc(qk).reshape(b, -1, split), _nhwc(v).reshape(b, -1, split)
    want = np.asarray(linear_attention_qk_first(jnp.asarray(qn[..., :d]),
                                                jnp.asarray(qn[..., d:]), jnp.asarray(vn)))
    np.testing.assert_allclose(_nhwc(got).reshape(b, -1, split), want, rtol=RTOL, atol=ATOL)
    # and through a block: the mixer's input is that slice, not a copy
    block = MetaNeXtBlockL(c, 1.5, stage=3, num_heads=2).eval()
    seen = []
    block.token_mixer.attn.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        block(x)
    assert seen[0].stride(0) == c * side * side and not seen[0].is_contiguous()


def test_share_channel_remat_matches_plain_backward():
    """Remat (torch.utils.checkpoint per block) over a share-channel stage, whose
    blocks carry their mixers' outputs across: the same loss and gradients."""
    name, ovr = CONFIGS["b_share"]
    model = create_model(name, device="cpu", **ovr).train()
    x = _nchw(_image(2, 64, 3))
    grads = []
    for remat in (False, True):
        model.zero_grad()
        torch.manual_seed(0)
        model(x, remat=remat).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-5, atol=1e-6, msg=n)


def test_l_trains_validates_fused_and_warm_starts_from_a_fused_archive(tmp_path, capsys):
    """The trainer on a small recnext_t (one epoch, the fused eval of the model and
    its EMA), validate.py --fused on its checkpoint and on a fused archive of its EMA
    weights (the same scores), and --finetune from that archive (defused) onto 7
    classes: no L-specific code in any of them."""
    from recnext_tpu_torch import validate as tvalidate
    from recnext_tpu_torch.export import publish_fused
    from recnext_tpu_torch.train import main as tmain

    small = "embed_dim=16:32:64:128,depth=0:1:2:1"

    def train(out, *extra, classes=11):
        return tmain.main(["--device", "cpu", "--model", "recnext_t", "--model-kwargs", small,
                           "--data-set", "FAKE", "--simple-aug", "--input-size", "64",
                           "--batch-size", "4", "--epochs", "1", "--steps-per-epoch", "2",
                           "--fake-classes", str(classes), "--dtype", "float32",
                           "--warmup-epochs", "0", "--output-dir", str(out), *extra])

    res = train(tmp_path / "run")
    stats = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(stats) == 1 and np.isfinite(stats[0]["train_loss"])
    assert np.isfinite(stats[0]["ema_test_acc1"])
    ckpt = tmp_path / "run" / "ckpt" / "epoch_0000.pt"
    model = create_model("recnext_t", device="cpu", embed_dim=WIDTHS, depth=(0, 1, 2, 1),
                         num_classes=11)
    model.load_state_dict(res["state"].variables(ema=True), strict=True)
    archive = tmp_path / "pub"
    publish_fused("recnext_t", model.state_dict(), str(archive))

    def validate(*args):
        return tvalidate.main(["--device", "cpu", "--model", "recnext_t", "--model-kwargs",
                               small, "--data-set", "FAKE", "--fake-classes", "11",
                               "--input-size", "64", "--batch-size", "8", "--max-batches",
                               "2", "--fused", *args])

    ema, pub = validate("--checkpoint", str(ckpt), "--ema"), validate("--checkpoint",
                                                                     str(archive))
    assert ema["count"] == pub["count"] == 16
    assert (ema["top1"], ema["top5"]) == (pub["top1"], pub["top5"])
    res = train(tmp_path / "ft", "--finetune", str(archive / "recnext_t_fused.pt"),
                classes=7)
    out = capsys.readouterr().out
    assert "BN-fused" in out and out.count("Removing key") == 4
    assert res["state"].step == 2
