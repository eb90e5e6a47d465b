"""The port's packed executor (recnext_tpu_torch/models/packed_infer.py) against the JAX
package's (recnext_tpu/models/packed_infer.py), on the CPU, at tests/test_packed_infer.py's
tiny configs (embed 24/48/96/192, depth 1/1/2/1, 32^2, f32; heads 2/4/8/16 of width 12, so
that q and k of one image paired with another's would show at g >= 2): the same fused
weights (every leaf of JAX's unfused tree drawn from a normal, folded by JAX, carried
across with ``jax_fused_to_torch``) and the same input through both. Tolerance: atol 2e-4,
rtol 2e-5 (tests/test_packed_infer.py:38); JAX's references are jitted, once a module.
Then the paths that run the executor: ``validate.py --packed``,
``ServingModel(packed=None)``, ``make_fused_eval_step(packed=True)``, ``bench.py``, and
the two tools."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.fusion import fuse_params as jax_fuse_params
from recnext_tpu.models import packed_infer as jpacked
from recnext_tpu.models.recnext import RecNext as JaxRecNext
from recnext_tpu.models.recnext import RecNextConfig as JaxConfig
from recnext_tpu_torch.convert import jax_fused_to_torch
from recnext_tpu_torch.models import packed_infer as tpacked
from recnext_tpu_torch.models.recnext import RecNext, RecNextConfig

ATOL, RTOL = 2e-4, 2e-5
TINY = dict(embed_dim=(24, 48, 96, 192), depth=(1, 1, 2, 1), mlp_ratio=(2, 2, 2, 2),
            num_classes=13)
CONFIGS = {"m": dict(TINY, name="tiny_m", family="m"),
           "a": dict(TINY, name="tiny_a", family="a"),
           # the softplus feature map, an empty stage 1 (tests/test_packed_infer.py:87-90)
           "a_softplus": dict(TINY, name="tiny_a_sp", family="a", depth=(1, 0, 1, 1),
                              num_classes=7, attn_kernel="softplus")}
GROUPS = (1, 2, 4)
# (family, group, JAX's attn_impl, mlp_mode): the JAX outputs each test compares with
CASES = ([("m", g, "blockdiag", "grouped") for g in GROUPS]
         + [("a", g, impl, "grouped") for g in GROUPS for impl in ("blockdiag", "headbatch")]
         + [("a_softplus", 2, "blockdiag", "grouped")]
         + [(f, g, "blockdiag", "blockdiag") for f in ("m", "a") for g in (2, 4)])


def _jax_fused(cfg: JaxConfig, batch: int):
    """Fused weights of ``cfg``: every leaf of the unfused tree drawn from a normal,
    BN variances positive (tests/test_packed_infer.py:158-170), folded by JAX."""
    model = JaxRecNext(cfg=cfg)
    x = np.random.default_rng(0).normal(size=(batch, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    gen = np.random.default_rng(3)

    def fill(path, s):
        arr = gen.normal(scale=0.2, size=s.shape)
        if path[-1].key == "var":
            arr = np.abs(arr) + 0.5
        return jnp.asarray(arr, s.dtype)

    return jax_fuse_params(jax.tree_util.tree_map_with_path(fill, shapes)), x


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side in one thread: its ops are small, and under the parallel test
    run every worker's thread pool would contend for the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref():
    """Per config: the fused JAX weights, the input (batch 8) and JAX's packed_apply for
    every case of ``CASES``; "fused" is JAX's g = 1 "blockdiag" output, which is
    ``RecNext(fused=True).apply``'s function (tests/test_packed_infer.py)."""
    out = {}
    for key, kw in CONFIGS.items():
        fused_vars, x = _jax_fused(JaxConfig(**kw), 8)
        out[key] = {"vars": fused_vars, "x": x, "packed": {}}
    apply = jax.jit(jpacked.packed_apply, static_argnames=("cfg", "group", "attn_impl",
                                                           "mlp_mode"))
    for key, g, impl, mlp in CASES:
        r = out[key]
        r["packed"][g, impl, mlp] = np.asarray(apply(
            r["vars"], JaxConfig(**CONFIGS[key]), jnp.asarray(r["x"]), group=g,
            attn_impl=impl, mlp_mode=mlp))
    for r in out.values():
        r["fused"] = r["packed"].get((1, "blockdiag", "grouped"))
    return out


def _port_fused(ref, key):
    model = RecNext(RecNextConfig(**CONFIGS[key]), fused=True)
    model.load_state_dict(jax_fused_to_torch(ref[key]["vars"], model), strict=True)
    return model.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_pack_and_unpack_are_jax_order_as_free_views():
    x = np.random.default_rng(0).normal(size=(8, 6, 5, 24)).astype(np.float32)
    xt = _nchw(x)
    for g in (1, 2, 4, 8):
        z = tpacked.pack(xt, g)
        assert z.shape == (8 // g, 24 * g, 6, 5) and z.data_ptr() == xt.data_ptr()
        want = np.asarray(jpacked.pack(jnp.asarray(x), g)).transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(z.numpy(), want)
        back = tpacked.unpack(z, g)
        assert back.data_ptr() == xt.data_ptr()
        np.testing.assert_array_equal(back.numpy(), xt.numpy())
    with pytest.raises(ValueError, match="does not pack"):
        tpacked.pack(xt[:6], 4)


@pytest.mark.parametrize("family,g,impl,mlp", CASES,
                         ids=[f"{f}-g{g}-{i}-{m}" for f, g, i, m in CASES])
def test_packed_apply_matches_jax(ref, family, g, impl, mlp):
    """The port runs 'headbatch' (K2 over the batch's heads); JAX's 'blockdiag' and
    'headbatch' are two layouts of the same function, and the port matches both."""
    model = _port_fused(ref, family)
    x = _nchw(ref[family]["x"])
    with torch.no_grad():
        got = tpacked.packed_apply(model, x, group=g, mlp_mode=mlp).numpy()
        unpacked = model(x).numpy()
    np.testing.assert_allclose(got, ref[family]["packed"][g, impl, mlp], atol=ATOL, rtol=RTOL)
    if ref[family]["fused"] is not None:
        np.testing.assert_allclose(got, ref[family]["fused"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, unpacked, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("family", ["m", "a"])
def test_per_stage_groups_and_the_default_policy(ref, family):
    model = _port_fused(ref, family)
    x = _nchw(ref[family]["x"])
    with torch.no_grad():
        for groups in ((1, 2, 4, 2), (4, 1, 1, 8)):
            got = tpacked.packed_apply(model, x, groups=groups).numpy()
            np.testing.assert_allclose(got, ref[family]["fused"], atol=ATOL, rtol=RTOL)
        got = tpacked.packed_apply(model, x).numpy()  # default_groups
    np.testing.assert_allclose(got, ref[family]["fused"], atol=ATOL, rtol=RTOL)


def test_packed_attention_views_pair_each_images_q_with_its_k(ref):
    """At g = 2 the packed qk holds (g, 2, heads, D) a position; the attention reads
    the free (B, 2c, H, W) view. Pairing the halves of all packed channels instead
    (the NCHW entry on the packed tensor as it is) gives other outputs."""
    from recnext_tpu_torch.ops.attention import linear_attention_nchw

    model = _port_fused(ref, "a")
    blk = tpacked.packed_block(model.stages[1].blocks[0], 2)
    attn = blk.token_mixer.down[1]
    assert isinstance(attn, tpacked._PackedAttention) and attn.qk.groups == 4
    x = torch.randn(4, 96, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        qk = attn.qk(x) + 1.5
        right = attn.attention(qk, x)
        wrong = linear_attention_nchw(qk, x, 2 * attn.num_heads)
        # each image alone through the unpacked module
        single = model.stages[1].blocks[0].token_mixer.down[1]
        per_image = torch.cat([single.qk(x.view(8, 48, 8, 8)[i:i + 1]) for i in range(8)])
        want = linear_attention_nchw(per_image + 1.5, x.view(8, 48, 8, 8), attn.num_heads)
    torch.testing.assert_close(right.view(8, 48, 8, 8), want, atol=ATOL, rtol=RTOL)
    assert (right - wrong).abs().max() > 1e-2


def test_default_groups_halves_to_divide_the_batch(monkeypatch):
    from recnext_tpu_torch.models.registry import get_config

    cfg = get_config("recnext_m1")
    # the table holds the H100 sweep's winners only; an unlisted variant runs unpacked
    assert all(len(v) == 4 and max(v) > 1 for v in tpacked.MEASURED_GROUPS.values())
    monkeypatch.setitem(tpacked.MEASURED_GROUPS, "recnext_m1", (1, 1, 4, 2))
    assert tpacked.default_groups(cfg, 256) == (1, 1, 4, 2)
    assert tpacked.default_groups(cfg, 2) == (1, 1, 2, 2)
    assert tpacked.default_groups(cfg, 6) == (1, 1, 2, 2)
    assert tpacked.default_groups(cfg, 3) == (1, 1, 1, 1)
    assert tpacked.default_groups(get_config("recnext_a5"), 256) == \
        tpacked.MEASURED_GROUPS.get("recnext_a5", (1, 1, 1, 1))
    monkeypatch.delitem(tpacked.MEASURED_GROUPS, "recnext_m1")
    assert tpacked.default_groups(cfg, 256) == (1, 1, 1, 1)


def test_bad_modes_groups_and_families_raise(ref):
    model = _port_fused(ref, "m")
    x = _nchw(ref["m"]["x"])
    with pytest.raises(ValueError, match="mlp_mode"):
        tpacked.packed_apply(model, x, mlp_mode="nope")
    with pytest.raises(ValueError, match="one factor"):
        tpacked.packed_apply(model, x, groups=(1, 2))
    with pytest.raises(ValueError, match="does not pack"):
        tpacked.packed_apply(model, x[:6], group=4)
    from recnext_tpu_torch.models.registry import create_model

    small = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 1, 1), num_classes=5)
    with pytest.raises(ValueError, match="m and a families"):
        tpacked.PackedRecNext(create_model("recnext_t", fused=True, device="cpu"), (1,) * 4)
    with pytest.raises(ValueError, match="BN-fused"):
        tpacked.PackedRecNext(create_model("recnext_m0", device="cpu", **small), (1,) * 4)


# --- the paths that run the executor -------------------------------------------------

SMALL = "embed_dim=16:32:64:128,depth=1:1:2:1"
OVR = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)


def test_validate_packed_scores_as_the_fused_model(monkeypatch):
    from recnext_tpu_torch import validate as tvalidate

    def run(*args):
        return tvalidate.main(["--device", "cpu", "--model", "recnext_a0", "--model-kwargs",
                               SMALL, "--data-set", "FAKE", "--fake-classes", "11",
                               "--batch-size", "8", "--max-batches", "2", "--input-size",
                               "32", *args])

    fused = run("--fused")
    monkeypatch.setitem(tpacked.MEASURED_GROUPS, "recnext_a0", (2, 4, 2, 2))
    packed = run("--fused", "--packed")
    assert packed["packed"] is True and fused["packed"] is False
    assert packed["groups"] == [2, 4, 2, 2] and fused["groups"] is None
    for k in ("top1", "top5", "count"):
        assert packed[k] == fused[k], k
    with pytest.raises(SystemExit, match="requires --fused"):
        run("--packed")
    with pytest.raises(SystemExit, match="incompatible with --packed"):
        run("--fused", "--packed", "--test-pool")


def test_serving_packs_the_m_and_a_families(monkeypatch, tmp_path):
    from recnext_tpu_torch.export import publish_fused
    from recnext_tpu_torch.models.registry import create_model
    from recnext_tpu_torch.serve import ServingModel

    batch = np.random.default_rng(0).normal(size=(3, 3, 32, 32)).astype(np.float32)
    for name in ("recnext_m0", "recnext_a0"):
        state = create_model(name, device="cpu", **OVR).state_dict()
        publish_fused(name, state, str(tmp_path / name))
        kw = dict(max_batch=4, input_size=32, dtype=torch.float32, device="cpu",
                  cfg_overrides=OVR)
        plain = ServingModel(str(tmp_path / name), name, packed=False, **kw)
        monkeypatch.setitem(tpacked.MEASURED_GROUPS, name, (2, 4, 2, 8))
        served = ServingModel(str(tmp_path / name), name, **kw)
        assert served.packed and not plain.packed
        assert served.groups == (2, 4, 2, 4)  # halved to divide max_batch 4
        np.testing.assert_allclose(served.predict(batch), plain.predict(batch), atol=1e-5)


def test_fused_eval_step_packed_matches_the_unpacked(monkeypatch):
    from recnext_tpu_torch.models.registry import create_model, get_config
    from recnext_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import make_fused_eval_step

    for name in ("recnext_m0", "recnext_a0"):
        model = create_model(name, device="cpu", **OVR)
        state = TrainState.create(model, make_optimizer(model.named_parameters(),
                                                        cosine_schedule(1e-3, 10)))
        batch = {"image": torch.randn(8, 3, 32, 32, generator=torch.Generator().manual_seed(1)),
                 "label": torch.arange(8) % 11}
        cfg = get_config(name, **OVR)
        want = make_fused_eval_step(cfg, packed=False, dtype=torch.float32)(state, batch)
        monkeypatch.setitem(tpacked.MEASURED_GROUPS, name, (2, 2, 4, 8))
        got = make_fused_eval_step(cfg, dtype=torch.float32)(state, batch)  # packed
        for k in ("correct1", "correct5", "count"):
            assert int(got[k]) == int(want[k]), k
        assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]), rel=1e-5)


def test_bench_runs_the_packed_executor_unless_told_not_to():
    from recnext_tpu_torch import bench

    argv = ["--device", "cpu", "--model", "recnext_a0", "--model-kwargs", SMALL, "--batch",
            "2", "--image-size", "32", "--timed", "0.05", "--warmup", "0"]
    rec = bench.main(argv)
    assert rec["packed"] is True and rec["groups"] == [1, 1, 1, 1]
    assert rec["value"] > 0
    rec = bench.main(argv + ["--no-packed"])
    assert rec["packed"] is False and rec["groups"] is None


def test_the_packing_tools_on_the_cpu():
    from recnext_tpu_torch.tools import attn_breakdown, sweep_packing

    out = sweep_packing.sweep("recnext_a0", [(1, 1, 1, 1), (2, 1, 2, 1)], batch=4,
                              image_size=32, iters=1, device="cpu", **OVR)
    assert [r["groups"] for r in out["rows"]] == [[1, 1, 1, 1], [2, 1, 2, 1]]
    assert all(r["images_per_sec"] > 0 for r in out["rows"])
    assert out["summary"]["best_groups"] in ([1, 1, 1, 1], [2, 1, 2, 1])
    for g in (2, 1):
        row = attn_breakdown.breakdown_stage("recnext_a0", 1, batch=4, groups=(g,) * 4,
                                             image_size=32, iters=1, device="cpu")
        assert (row["g"], row["batch_packed"], row["side"], row["heads"]) == (g, 4 // g, 4, 4)
        assert row["c_packed"] == g * 80  # recnext_a0's stage 1, g images
        assert all(v > 0 for k, v in row["ms"].items() if k not in attn_breakdown.NOT_PORTED)
        assert all(row["ms"][k] is None for k in attn_breakdown.NOT_PORTED)
