"""The port's MLLA graft family against the JAX package's, on the same weights (a JAX
init moved off its values, carried across with jax_mlla_to_torch) and the same
inputs, in f32: flax's LayerNorm and the stem's ConvLayer, the RoPE tables and
rotation, the attention (simple and RoPE, against the head-batched form and
linear_attention_blockdiag_rope), both aggregators, the block (every variant, with and
without downsampling), the stem and the whole model (all three variants, train and
eval mode) at tests/test_mlla.py:_small_cfg's size; the six full-size configs' keys,
shapes and parameter counts; mlla_mini's drop-path rates; the converter against
recnext_tpu.convert.mlla_flax_to_torch, exactly."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from recnext_tpu.convert import mlla_flax_to_torch
from recnext_tpu.models import mlla as jmlla
from recnext_tpu.ops.attention import linear_attention_blockdiag_rope
from recnext_tpu_torch.convert import jax_mlla_to_torch
from recnext_tpu_torch.models import mlla as tmlla
from recnext_tpu_torch.models.layers import ConvLayer, LayerNorm
from recnext_tpu_torch.models.mixers import RecConv2dMixer
from recnext_tpu_torch.ops import attention as tattn

ATOL, RTOL = 2e-4, 1e-4  # tests/test_torch_models.py:22
VARIANTS = ["recconv", "recattn", "recattn_simple"]
NAMES = [f"mlla_{s}_{v}" for s in ("nano", "mini") for v in VARIANTS]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def small_cfg(variant):
    """tests/test_mlla.py:_small_cfg: embed 16, depths 1/1/1/1, 64^2."""
    return dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 16),
                expansion_ratio=2.5 if variant == "recconv" else 2.0, num_classes=10,
                img_size=64)


def _nhwc(shape, seed, positive=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _moved(variables, seed=3, scale=0.05):
    """Every leaf moved off its init (BN statistics stay positive)."""
    rng = np.random.default_rng(seed)

    def move(path, v):
        v = np.asarray(v)
        if path[-1].key == "var":
            return v + scale * np.abs(rng.normal(size=v.shape)).astype(v.dtype)
        return v + scale * rng.normal(size=v.shape).astype(v.dtype)

    return jax.tree_util.tree_map_with_path(move, jax.tree.map(np.asarray, variables))


def _port_weights(variables, prefix_path, prefix_key):
    """A JAX submodule's variables as the port's state dict for the same module: the
    converter's keys under ``prefix_path`` (a flax path), with ``prefix_key`` cut."""
    def wrap(tree):
        for name in reversed(prefix_path):
            tree = {name: tree}
        return tree

    wrapped = {col: wrap(tree) for col, tree in variables.items()}
    sd = jax_mlla_to_torch(wrapped)
    return {k[len(prefix_key):]: v for k, v in sd.items()}


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=what)


# ---------------------------------------------------------------- item 1: layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_is_flax_layer_norm(dtype):
    x = _nhwc((2, 5, 6, 24), 0) * 3 + 1
    ln = fnn.LayerNorm(dtype=jnp.dtype(dtype))
    v = _moved(ln.init(jax.random.PRNGKey(0), jnp.zeros((1, 24))), scale=0.3)
    want = np.asarray(ln.apply(v, jnp.asarray(x, dtype)).astype(jnp.float32))
    port = LayerNorm(24)
    port.load_state_dict({"weight": torch.from_numpy(np.asarray(v["params"]["scale"])),
                          "bias": torch.from_numpy(np.asarray(v["params"]["bias"]))})
    got = port(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and port.eps == 1e-6
    if dtype == "float32":
        _close(got.detach().numpy(), want)
    else:  # both round the fp32 result to bf16 once: at most one bf16 ulp apart
        np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_conv_layer_matches_jax(train):
    jl = jmlla.ConvLayer(12, kernel_size=3, stride=2, padding=1, use_bias=False)
    x = _nhwc((3, 9, 10, 5), 1)
    v = _moved(jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if train:
        want, upd = jl.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
    else:
        want = jl.apply(v, jnp.asarray(x))
    port = ConvLayer(5, 12, 3, 2)
    port.load_state_dict(_port_weights(v, ("stem", "conv1"), "patch_embed.conv1."),
                         strict=True)
    port.train(train)
    with torch.no_grad():
        got = port(_nchw(x))
    _close(_to_nhwc(got), np.asarray(want))
    if train:  # the running statistics' update too
        _close(port.norm.running_var.numpy(), np.asarray(upd["batch_stats"]["bn"]["var"]))


@pytest.mark.parametrize("train", [False, True])
def test_stem_matches_jax(train):
    stem = jmlla.MLLAStem(16)
    x = _nhwc((2, 32, 32, 3), 2)
    v = _moved(stem.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = stem.apply(v, jnp.asarray(x), training=train,
                      **({"mutable": ["batch_stats"]} if train else {}))
    want = np.asarray(want[0] if train else want)
    port = tmlla.MLLAStem(3, 16)
    port.load_state_dict(_port_weights(v, ("stem",), "patch_embed."), strict=True)
    port.train(train)
    with torch.no_grad():
        _close(_to_nhwc(port(_nchw(x))), want)


# ------------------------------------------------------------- item 2: attention


def test_rope_tables_and_rotation_match_jax():
    cos, sin = tattn.rope_rotations(6, 10, 24)
    jcos, jsin = jmlla.rope_rotations(6, 10, 24)
    assert cos.dtype == np.float32 and cos.shape == (12, 6, 10)
    np.testing.assert_array_equal(cos, jcos.transpose(2, 0, 1))
    np.testing.assert_array_equal(sin, jsin.transpose(2, 0, 1))
    x = _nhwc((2, 6, 10, 24), 3)
    want = np.asarray(jmlla.apply_rope(jnp.asarray(x), jcos, jsin))
    got = tattn.apply_rope(_nchw(x), torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(_to_nhwc(got), want, atol=1e-6, rtol=1e-6)


def _rope_inputs(b=2, side=8, c=32, heads=4):
    q, k = _nhwc((b, side, side, c), 4, True), _nhwc((b, side, side, c), 5, True)
    v = _nhwc((b, side, side, c), 6)
    return q, k, v, heads


def test_rope_attention_matches_jax_head_batched_form():
    """linear_attention_rope_plain against mlla.py:160-170's head-batched einsums."""
    q, k, v, nh = _rope_inputs()
    b, h, w, c = q.shape
    n, hd = h * w, c // nh
    cos, sin = jmlla.rope_rotations(h, w, c)

    def heads(t):
        return jnp.transpose(jnp.asarray(t).reshape(b, n, nh, hd), (0, 2, 1, 3)).reshape(
            b * nh, n, hd)

    qr, kr = jmlla.apply_rope(jnp.asarray(q), cos, sin), jmlla.apply_rope(jnp.asarray(k), cos, sin)
    s = float(n) ** -0.5
    kv = jnp.einsum("bnd,bne->bde", heads(kr) * s, heads(v) * s)
    num = jnp.einsum("bnd,bde->bne", heads(qr), kv)
    denom = jnp.einsum("bnd,bd->bn", heads(q), jnp.mean(heads(k), axis=-2)) + 1e-6
    o = num / denom[..., None]
    want = np.asarray(jnp.transpose(o.reshape(b, nh, n, hd), (0, 2, 1, 3)).reshape(b, h, w, c))
    tc, ts = (torch.from_numpy(t) for t in tattn.rope_rotations(h, w, c))
    got = tattn.linear_attention_rope_plain(torch.cat([_nchw(q), _nchw(k)], 1), _nchw(v),
                                            nh, tc, ts)
    _close(_to_nhwc(got), want)


def test_rope_attention_matches_jax_blockdiag_rope():
    """The TPU layout of the same function (not ported) agrees with the port's."""
    q, k, v, nh = _rope_inputs(b=1, side=6, c=16, heads=2)
    b, h, w, c = q.shape
    cos, sin = jmlla.rope_rotations(h, w, c)
    rot = [np.asarray(jmlla.apply_rope(jnp.asarray(t), cos, sin)).reshape(b, h * w, c)
           for t in (q, k)]
    want = np.asarray(linear_attention_blockdiag_rope(
        jnp.asarray(q.reshape(b, h * w, c)), jnp.asarray(k.reshape(b, h * w, c)),
        jnp.asarray(rot[0]), jnp.asarray(rot[1]), jnp.asarray(v.reshape(b, h * w, c)),
        nh)).reshape(b, h, w, c)
    tc, ts = (torch.from_numpy(t) for t in tattn.rope_rotations(h, w, c))
    got = tattn.linear_attention_rope_plain(torch.cat([_nchw(q), _nchw(k)], 1), _nchw(v),
                                            nh, tc, ts)
    _close(_to_nhwc(got), want)


@pytest.mark.parametrize("rope", [False, True])
def test_linear_attention_module_matches_jax(rope):
    ja = jmlla.MLLALinearAttention(4, rope=rope)
    x = _nhwc((2, 8, 8, 32), 7)
    v = _moved(ja.init(jax.random.PRNGKey(0), jnp.asarray(x)), scale=0.2)
    want = np.asarray(ja.apply(v, jnp.asarray(x)))
    port = tmlla.MLLALinearAttention(32, 4, rope=rope, side=8)
    port.load_state_dict(_port_weights(v, ("layer0_block0", "agg", "attn"),
                                       "layers.0.blocks.0.agg.down.1."), strict=True)
    with torch.no_grad():
        got, plain = port(_nchw(x)), port.forward_plain(_nchw(x))
    _close(_to_nhwc(got), want)
    assert torch.equal(got, plain)  # on the CPU the entry runs the plain version
    assert [n for n, _ in port.named_buffers()] == (["rope.cos", "rope.sin"] if rope else [])
    assert not any("rope" in k for k in port.state_dict())  # non-persistent


def test_rope_tables_stay_fp32_when_the_model_is_cast():
    port = tmlla.MLLALinearAttention(16, 2, rope=True, side=4).to(torch.bfloat16)
    want = tattn.rope_rotations(4, 4, 16)[0]
    assert port.rope.cos.dtype == torch.float32
    np.testing.assert_array_equal(port.rope.cos.numpy(), want)
    cos, _ = port.rope.tables(6, 2)  # another map size: computed
    np.testing.assert_array_equal(cos.numpy(), tattn.rope_rotations(6, 2, 16)[0])


# ----------------------------------------------------------- item 3: the model


def test_recconv_aggregator_matches_jax():
    ja = jmlla.MLLARecConvAgg(level=3)
    x = _nhwc((2, 16, 16, 20), 8)
    v = _moved(ja.init(jax.random.PRNGKey(0), jnp.asarray(x)), scale=0.1)
    port = RecConv2dMixer(20, 3, 5, mode="nearest")
    port.load_state_dict(_port_weights(v, ("layer0_block0", "agg"), "layers.0.blocks.0.agg."),
                         strict=True)
    with torch.no_grad():
        _close(_to_nhwc(port(_nchw(x))), np.asarray(ja.apply(v, jnp.asarray(x))))


@pytest.mark.parametrize("rope", [False, True])
def test_attention_aggregator_matches_jax(rope):
    ja = jmlla.MLLARecAttnAgg(2, rope=rope)
    x = _nhwc((2, 16, 16, 16), 9)
    v = _moved(ja.init(jax.random.PRNGKey(0), jnp.asarray(x)), scale=0.1)
    port = tmlla.MLLARecAttnAgg(16, 2, rope=rope, side=16)
    port.load_state_dict(_port_weights(v, ("layer0_block0", "agg"), "layers.0.blocks.0.agg."),
                         strict=True)
    with torch.no_grad():
        _close(_to_nhwc(port(_nchw(x))), np.asarray(ja.apply(v, jnp.asarray(x))))


@pytest.mark.parametrize("downsample", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_block_matches_jax(variant, downsample):
    ratio = 2.5 if variant == "recconv" else 2.0
    jb = jmlla.MLLABlock(variant, level=2, num_heads=2, expansion_ratio=ratio,
                         downsample=downsample)
    x = _nhwc((2, 16, 16, 16), 10)
    v = _moved(jb.init(jax.random.PRNGKey(0), jnp.asarray(x)), scale=0.1)
    port = tmlla.MLLABlock(variant, 16, 2, 2, side=16, expansion_ratio=ratio,
                           downsample=downsample)
    name = "layer0_down" if downsample else "layer0_block0"
    key = "layers.0.downsample." if downsample else "layers.0.blocks.0."
    port.load_state_dict(_port_weights(v, (name,), key), strict=True)
    want = np.asarray(jb.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        for train in (False, True):  # drop path 0: the same function in train mode
            port.train(train)
            _close(_to_nhwc(port(_nchw(x))), want, f"train={train}")


def _drawn(shapes, seed=3):
    """Variables of the JAX model's shapes drawn from numpy (no init to compile):
    kernels at a fan-in scale, LayerNorm and BatchNorm scales near 1, positive
    variances, biases and means near 0."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name, n = path[-1].key, rng.normal(size=s.shape).astype(np.float32)
        if name.endswith("kernel"):
            return n / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1 + 0.1 * n
        if name == "var":
            return 1 + 0.1 * np.abs(n)
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_model(variant):
    """The JAX model at small_cfg's size and variables of its shapes; each variant's
    are drawn once, however many tests ask for them."""
    cfg = small_cfg(variant)
    jm = jmlla.MLLA(cfg=jmlla.MLLAConfig(name=f"small_{variant}", variant=variant, **cfg))
    return jm, _drawn(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3))))


def _model_pair(variant):
    """(JAX model, its variables, the port's model on the same weights)."""
    jm, v = _jax_model(variant)
    port = tmlla.create_mlla(f"mlla_nano_{variant}", device="cpu", **small_cfg(variant))
    port.load_state_dict(jax_mlla_to_torch(v, port), strict=True)
    return jm, v, port


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_logits_match_jax_in_eval_and_train_mode(variant):
    jm, v, port = _model_pair(variant)
    x = _nhwc((2, 64, 64, 3), 11)
    # one compile for both modes (faster than flax's op-by-op apply)
    want_eval, (want_train, upd) = jax.jit(lambda v, x: (
        jm.apply(v, x), jm.apply(v, x, training=True, mutable=["batch_stats"])))(
            v, jnp.asarray(x))
    with torch.no_grad():
        got_eval = port.eval()(_nchw(x))
        got_train = port.train()(_nchw(x))
    assert got_eval.shape == (2, 10)
    _close(got_eval.numpy(), np.asarray(want_eval), "eval")
    _close(got_train.numpy(), np.asarray(want_train), "train")
    # the stem's BatchNorm statistics after the train-mode forward
    ref = jax_mlla_to_torch({"params": v["params"], "batch_stats": upd["batch_stats"]})
    for k, t in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(t.numpy(), ref[k].numpy(), k)


def test_remat_forward_and_gradients_equal_the_plain_ones():
    _, _, port = _model_pair("recconv")
    x = _nchw(_nhwc((2, 64, 64, 3), 12))
    grads = []
    for remat in (False, True):
        port.zero_grad()
        port.eval()(x, remat=remat).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in port.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-5, atol=1e-6, msg=n)


# ------------------------------------------------- full-size configs, converter


def _zeros_variables(name):
    model = jmlla.create_mlla(name)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("name", NAMES)
def test_full_size_keys_shapes_and_counts_match_the_jax_converter(name):
    variables = _zeros_variables(name)
    ref = mlla_flax_to_torch(variables, verify=False)
    port = tmlla.create_mlla(name, device="cpu")
    sd = port.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(np.shape(v)) for k, v in ref.items()}
    n_jax = sum(int(np.size(p)) for p in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax


def test_mini_drop_path_rates_match_the_jax_module_tree():
    seen = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, jmlla.MLLABlock) and context.method_name == "__call__":
            seen[mod.name] = mod.drop_path
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        jax.eval_shape(jmlla.create_mlla("mlla_mini_recconv").init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 256, 256, 3)))
    port = tmlla.create_mlla("mlla_mini_recconv", device="cpu")
    got = {}
    for i, layer in enumerate(port.layers):
        for j, blk in enumerate(layer.blocks):
            got[f"layer{i}_block{j}"] = (blk.dp1.rate, blk.dp2.rate)
        if layer.downsample is not None:
            got[f"layer{i}_down"] = (layer.downsample.dp1.rate, layer.downsample.dp2.rate)
    assert len(seen) == 18 + 3 and set(got) == set(seen)
    for k, rate in seen.items():
        assert got[k] == (pytest.approx(rate, abs=1e-12),) * 2, k
    assert max(seen.values()) == pytest.approx(0.2)


@pytest.mark.parametrize("variant", VARIANTS)
def test_converter_equals_mlla_flax_to_torch(variant):
    _, v, port = _model_pair(variant)
    ref = mlla_flax_to_torch(v)
    got = jax_mlla_to_torch(v, port)
    assert list(ref) and set(got) == set(ref)
    for k, want in ref.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(want)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)


def test_blockdiag_attention_raises_and_says_why():
    with pytest.raises(NotImplementedError, match="TPU layout"):
        tmlla.create_mlla("mlla_nano_recattn", device="cpu", attn_impl="blockdiag")
    with pytest.raises(KeyError, match="unknown MLLA model"):
        tmlla.create_mlla("mlla_tiny_recconv", device="cpu")


def test_config_table_matches_jax():
    assert set(tmlla.MLLA_CONFIGS) == set(jmlla.MLLA_CONFIGS)
    for name, cfg in jmlla.MLLA_CONFIGS.items():
        assert dataclasses.asdict(tmlla.MLLA_CONFIGS[name]) == dataclasses.asdict(cfg)
