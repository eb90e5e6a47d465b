"""The port's segmentation recipe against the JAX package's (``recnext_tpu/tasks/``)
on the CPU, at small sizes: the FPN, Semantic FPN's logits in eval and in train mode
(frozen backbone BN, the head's BN moving) and one train step (loss, parameters, running
statistics), for a tiny M and a tiny A backbone, from JAX-initialised variables through
``jax_task_to_torch`` (``strict=True``) and the same numpy inputs; frozen BN in
``RecNext`` and through the classifier trainer's ``--set-bn-eval``; the loss and mIoU;
the poly schedule, the synthetic batch, the train and eval samples, AlignResize and
``SegFolder``. The dropout of the head draws one mask per (image, channel): both sides
are given the same mask."""

import copy
import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from recnext_tpu.data.datasets import SegFolder as JSegFolder
from recnext_tpu.models.recnext import RecNextConfig as JConfig
from recnext_tpu.tasks import segmentation as jseg
from recnext_tpu.tasks import train_seg as jtrain
from recnext_tpu.tasks.fpn import FPN as JFPN
from recnext_tpu_torch.convert import jax_task_to_torch
from recnext_tpu_torch.data.datasets import SegFolder
from recnext_tpu_torch.models.recnext import RecNext, RecNextConfig
from recnext_tpu_torch.tasks import segmentation as tseg
from recnext_tpu_torch.tasks import train_seg as ttrain
from recnext_tpu_torch.tasks.fpn import FPN
from recnext_tpu_torch.train.optim import make_optimizer
from recnext_tpu_torch.train.state import TrainState

TINY = {"m": dict(name="tiny_m", family="m", embed_dim=(8, 16, 32, 64), depth=(1, 1, 1, 1),
                  mlp_ratio=(2, 2, 2, 2), num_classes=0),
        "a": dict(name="tiny_a", family="a", embed_dim=(16, 32, 64, 128), depth=(1, 1, 1, 1),
                  mlp_ratio=(2, 2, 2, 2), num_classes=0)}
CLASSES, FPN_CH, LR = 7, 16, 1e-4
# the input side: the A model's at 128^2, where its last two stages attend over 4x4 and
# 2x2 maps (at 64^2, 2x2 and 1x1: a q/k gradient of rounding noise)
SIDE = {"m": 64, "a": 128}


def fast_jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with the XLA backend's optimisations off, which
    cuts these one-shot references' compile time by a third on the CPU (the same
    operations)."""
    fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=fast)(*args)


def jax_init(module, *args):
    """``module.init`` of the JAX package under ``fast_jit``, its key XLA's RNG-bit
    generator, whose init compiles in 2/3 of threefry's time (made here, so that
    importing this file starts no JAX backend)."""
    return fast_jit(module.init, jax.random.key(0, impl="rbg"), *args)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _shift_stats(variables, seed=3):
    """BN running statistics moved off (0, 1), so that using them shows."""
    rng = np.random.default_rng(seed)
    return {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.2 * np.abs(rng.normal(size=v.shape)).astype(v.dtype),
        variables["batch_stats"])}


def _mask(b, c, seed=5):
    return np.random.default_rng(seed).uniform(size=(b, c)) < 0.9


def _jax_mask(key, p, shape):
    return jnp.asarray(_mask(shape[0], shape[-1]).reshape(shape))


def _port_mask(shape, keep, device, generator):
    return torch.from_numpy(_mask(shape[0], shape[1]).reshape(shape))


def _jax_reference_numpy(family):
    """``_jax_reference`` as numpy, in a process of its own (``jax_reference``)."""
    return jax.device_get(_jax_reference(family))


@functools.lru_cache(maxsize=None)
def _references():
    """Both families' references at once, each in a spawned process: their jitted
    functions' tracing and compiling are most of the file's time."""
    families = ("m", "a")
    with ProcessPoolExecutor(len(families), mp_context=multiprocessing.get_context("spawn")) as pool:
        return dict(zip(families, pool.map(_jax_reference_numpy, families)))


def jax_reference(family):
    return _references()[family]


def _jax_reference(family):
    """The JAX SemanticFPN on the tiny ``family`` backbone, from one jitted function:
    its variables (statistics moved off (0, 1)), the input and labels, the eval logits,
    and one train step's train-mode logits and statistics, loss, gradients and
    parameters (the dropout's mask ``_mask``)."""
    jm = jseg.SemanticFPN(backbone_cfg=JConfig(**TINY[family]), num_classes=CLASSES,
                          fpn_channels=FPN_CH)
    side = SIDE[family]
    x = np.random.default_rng(0).normal(size=(2, side, side, 3)).astype(np.float32)
    y = np.random.default_rng(4).integers(0, CLASSES, size=(2, side, side)).astype(np.int32)
    y[:, :5] = 255
    variables = _shift_stats(jax_init(jm, jnp.asarray(x)))
    tx = optax.adamw(jtrain.poly_schedule(LR, 100), weight_decay=0.05)
    rngs = {"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(1)}

    def train_logits(params, stats, xb):
        return jm.apply({"params": params, "batch_stats": stats}, xb, training=True,
                        mutable=["batch_stats"], rngs=rngs)

    def run(v, xb, yb):
        eval_logits = jm.apply(v, xb, training=False)

        def loss_fn(p):  # the train-mode logits and statistics are the step's forward's
            out, m = train_logits(p, v["batch_stats"], xb)
            return jseg.segmentation_loss(out, yb), (out, m["batch_stats"])

        (loss, (logits, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        return (eval_logits, logits, new_stats, loss, grads,
                optax.apply_updates(v["params"], updates))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jseg.jax.random, "bernoulli", _jax_mask)
        out = fast_jit(run, variables, jnp.asarray(x), jnp.asarray(y))
    keys = ("eval_logits", "train_logits", "stats", "loss", "grads", "params")
    return dict(zip(keys, out), variables=variables, x=x, y=y)


@pytest.fixture
def same_dropout(monkeypatch):
    """The port's head draws the dropout mask of ``_mask``, as the reference did."""
    monkeypatch.setattr(tseg, "dropout_mask", _port_mask)


def _port_model(family, variables):
    tm = tseg.SemanticFPN(RecNextConfig(**TINY[family]), num_classes=CLASSES,
                          fpn_channels=FPN_CH)
    tm.load_state_dict(jax_task_to_torch(variables, tm), strict=True)
    return tm


def _stats_close(got, want, what):
    """BN running statistics: rtol 1e-5 and atol 1e-5 of the tensor's scale (at least 1):
    fp32 sums over the batch's pixels carry rounding of the inputs' scale, which the
    heads' statistics (tens, from an unnormalised FPN at init) have and an O(1) element
    does not show."""
    got, want = got.numpy(), want.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _close(got, want, tol, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("sizes", [(16, 8, 4, 2), (13, 7, 4, 2)])
def test_fpn_matches_jax_with_the_extra_levels_a_stride_2_subsample(sizes):
    rng = np.random.default_rng(1)
    chans = (8, 16, 32, 64)
    feats = [rng.normal(size=(2, s, s, c)).astype(np.float32) for s, c in zip(sizes, chans)]
    jf = JFPN(out_channels=12, num_outs=6)
    variables = jax_init(jf, [jnp.asarray(f) for f in feats])
    want = jax.jit(jf.apply)(variables, [jnp.asarray(f) for f in feats])
    tf = FPN(chans, 12, num_outs=6)
    sd = jax_task_to_torch({"params": {"neck": variables["params"]}})
    tf.load_state_dict({k[len("neck."):]: v for k, v in sd.items()}, strict=True)
    got = tf([nchw(f) for f in feats])
    assert [tuple(g.shape[2:]) for g in got] == [tuple(w.shape[1:3]) for w in want]
    for g, w in zip(got, want):
        _close(nhwc(g), np.asarray(w), 1e-5, "fpn")


@pytest.mark.parametrize("family", ["m", "a"])
def test_semantic_fpn_eval_logits_match_jax(family):
    ref = jax_reference(family)
    tm = _port_model(family, ref["variables"])
    with torch.no_grad():
        got = nhwc(tm.eval()(nchw(ref["x"])))
    assert got.shape == (2, SIDE[family], SIDE[family], CLASSES)
    _close(got, np.asarray(ref["eval_logits"]), 1e-4, "eval logits")


@pytest.mark.parametrize("family", ["m", "a"])
def test_semantic_fpn_train_mode_frozen_backbone_matches_jax(family, same_dropout):
    ref = jax_reference(family)
    tm = _port_model(family, ref["variables"])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.train()
    bns = [m for m in tm.backbone.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and not any(m.training for m in bns) and tm.decode_head.training
    with torch.no_grad():
        got = nhwc(tm(nchw(ref["x"])))
    _close(got, np.asarray(ref["train_logits"]), 1e-4, "train logits")
    after = tm.state_dict()
    want = jax_task_to_torch({"params": ref["variables"]["params"],
                              "batch_stats": ref["stats"]})
    for k in after:
        if k.endswith(("running_mean", "running_var")):
            if k.startswith("backbone."):  # frozen: the same bits on both sides
                assert torch.equal(after[k], before[k]), k
                assert torch.equal(want[k], before[k]), k
            else:
                assert not torch.equal(after[k], before[k]), k
                _stats_close(after[k], want[k], k)


@pytest.mark.parametrize("family", ["m", "a"])
def test_one_train_step_matches_jax(family, same_dropout):
    ref = jax_reference(family)
    tm = _port_model(family, ref["variables"])
    opt = make_optimizer(tm.named_parameters(), ttrain.poly_schedule(LR, 100), 0.05,
                         agc_clip=0.0, decay_all=True)
    state = TrainState.create(tm, opt, ema=False)
    batch = {"image": nchw(ref["x"]), "label": torch.from_numpy(ref["y"])}
    exact = f64_grads(tm, lambda m: tseg.segmentation_loss(m(batch["image"].double()),
                                                           batch["label"]))
    got = ttrain.make_seg_train_step()(state, batch, None)
    assert float(got) == pytest.approx(float(ref["loss"]), rel=1e-5)
    after = jax_task_to_torch({"params": ref["params"], "batch_stats": ref["stats"]}, tm)
    raw = jax_task_to_torch({"params": ref["grads"], "batch_stats": ref["stats"]}, tm)
    sd = tm.state_dict()
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            _stats_close(sd[k], after[k], k)
    _check_step_params(tm, after, raw, exact)


def f64_grads(model, loss_fn):
    """Every parameter's gradient of ``loss_fn(model)`` with the model in float64 (a copy):
    the exact gradient both float32 sides are held to."""
    m = copy.deepcopy(model).double().train()
    loss_fn(m).backward()
    return {n: p.grad.numpy() for n, p in m.named_parameters()}


def _check_step_params(model, after, raw, exact, lr=LR):
    """One AdamW step against the reference's. Each gradient (left in ``.grad`` by the
    step) within 1e-4 of its tensor's max s of the exact (float64) gradient, or no
    further from it than the reference's float32 gradient is (e, the max of |reference -
    exact| in the tensor: up to 2e-3 s in the A models on the CPU), and within 1e-4 s + e
    of the reference's. Then the parameters:
    Adam's first step is lr * g / (|g| + eps), so where the reference's g is nonzero but
    under 1e-4 s + e (or 1e-7), its sign is not pinned and the steps may differ by 2 lr;
    elsewhere within 1e-6. A tensor whose exact gradient is under 1e-5 throughout (a
    shift that a train-mode BatchNorm follows; q/k at a 1x1 attention map) holds
    rounding noise: under 1e-5, its step within 2 lr."""
    noise = 0
    for name, p in model.named_parameters():
        g, ex, got = raw[name].numpy(), exact[name], p.grad.numpy()
        scale, e = np.abs(ex).max(), np.abs(g - ex).max()
        if scale < 1e-5:
            assert np.abs(got).max() < 1e-5, name
            tol = np.full(g.shape, 2 * lr)
            noise += 1
        else:
            assert np.abs(got - ex).max() <= max(1e-4 * scale, e), (name, "exact")
            assert np.abs(got - g).max() <= 1e-4 * scale + e, (name, "reference")
            unpinned = (g != 0) & (np.abs(g) < max(1e-4 * scale + e, 1e-7))
            tol = np.where(unpinned, 2 * lr, 1e-6)
        err = np.abs(p.detach().numpy() - after[name].numpy())
        assert (err <= tol).all(), (name, err.max())
    assert noise < len(list(model.parameters())) // 4


def test_frozen_recnext_trains_its_bn_affine_on_running_statistics():
    """Frozen BN in RecNext (the JAX side's in the Semantic FPN tests above): in train
    mode every BatchNorm is in eval mode and DropPath is not; the features are the
    eval-mode ones (drop-path 0), no statistic moves, the BN scale gets a gradient."""
    tm = RecNext(RecNextConfig(**TINY["m"]), frozen_stats=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = tm.eval().features(x)
    tm.train()
    assert all(not m.training for m in tm.modules() if isinstance(m, torch.nn.BatchNorm2d))
    assert all(m.training for m in tm.modules() if type(m).__name__ == "DropPath")
    got = tm.features(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got[-1].sum().backward()
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    bn = tm.stages[0].blocks[0].norm
    assert bn.weight.grad is not None and bn.weight.grad.abs().max() > 0
    assert RecNext(RecNextConfig(**TINY["m"])).train().stages[0].blocks[0].norm.training


def test_set_bn_eval_keeps_the_classifier_trainers_statistics(tmp_path):
    from recnext_tpu_torch.models.registry import create_model
    from recnext_tpu_torch.train import main as tmain

    kwargs = "embed_dim=16:32:64:128,depth=1:1:2:1"
    common = ["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", kwargs,
              "--data-set", "FAKE", "--simple-aug", "--input-size", "32", "--batch-size", "4",
              "--epochs", "1", "--steps-per-epoch", "2", "--fake-classes", "5",
              "--dtype", "float32", "--no-model-ema"]
    init = create_model("recnext_m0", device="cpu", embed_dim=(16, 32, 64, 128),
                        depth=(1, 1, 2, 1), num_classes=5,
                        generator=torch.Generator().manual_seed(0)).state_dict()
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    for flag, frozen in (([], False), (["--set-bn-eval"], True)):
        res = tmain.main(common + flag + ["--output-dir", str(tmp_path / str(frozen))])
        model = res["state"].model
        assert model.frozen_stats is frozen
        sd = model.state_dict()
        same = [torch.equal(sd[k], init[k]) for k in stats]
        assert all(same) if frozen else not any(same)
        # the BN scale and bias train either way
        assert not torch.equal(sd["stages.0.blocks.0.norm.weight"],
                               init["stages.0.blocks.0.norm.weight"])


def test_loss_and_miou_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 9, 12, 5)).astype(np.float32)
    logits[0, 0, 0] = 1.0  # a tie: the first maximum
    labels = rng.integers(0, 5, size=(2, 9, 12)).astype(np.int32)
    labels[1, :3] = 255
    want = float(jseg.segmentation_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tseg.segmentation_loss(nchw(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    wi, wu = jseg.miou(jnp.asarray(logits), jnp.asarray(labels), 5)
    gi, gu = tseg.miou(nchw(logits), torch.from_numpy(labels), 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    all_ignored = np.full_like(labels, 255)
    assert float(tseg.segmentation_loss(nchw(logits), torch.from_numpy(all_ignored))) == 0.0


def test_poly_schedule_and_synthetic_batch_match_jax():
    js, ts = jtrain.poly_schedule(1e-4, 40000), ttrain.poly_schedule(1e-4, 40000)
    for step in (0, 1, 777, 20000, 39999, 40000, 50000):
        assert ts(step) == float(js(jnp.int32(step))), step
    want = jtrain.synthetic_seg_batch(np.random.default_rng(3), 3, 32, 150)
    got = ttrain.synthetic_seg_batch(np.random.default_rng(3), 3, 32, 150)
    np.testing.assert_array_equal(got["image"], want["image"].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(got["label"], want["label"])


def _ade_folder(root, n=3, seed=0):
    rng = np.random.default_rng(seed)
    for split in ("training", "validation"):
        (root / "images" / split).mkdir(parents=True)
        (root / "annotations" / split).mkdir(parents=True)
        for i in range(n):
            h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                root / "images" / split / f"ADE_{i}.jpg", quality=90)
            Image.fromarray(rng.integers(0, 151, (h, w), np.uint8)).save(
                root / "annotations" / split / f"ADE_{i}.png")
        (root / "images" / split / "orphan.jpg").write_bytes(
            (root / "images" / split / "ADE_0.jpg").read_bytes())
    return root


def test_segfolder_and_samples_match_jax(tmp_path):
    root = _ade_folder(tmp_path)
    jds, tds = JSegFolder(str(root)), SegFolder(str(root))
    assert len(tds) == len(jds) == 3
    for i in range(3):
        (jimg, jlab), (timg, tlab) = jds[i], tds[i]
        np.testing.assert_array_equal(np.asarray(timg), np.asarray(jimg))
        np.testing.assert_array_equal(tlab, jlab)
        assert set(np.unique(tlab)) <= set(range(150)) | {255}
        for crop in (32, 128):
            ja, js_ = jseg.seg_train_sample(np.random.default_rng(i), jimg, jlab, crop)
            ta, ts_ = tseg.seg_train_sample(np.random.default_rng(i), timg, tlab, crop)
            np.testing.assert_array_equal(ta, ja.transpose(2, 0, 1))
            np.testing.assert_array_equal(ts_, js_)
            ja, js_ = jseg.seg_eval_sample(jimg, jlab, crop)
            ta, ts_ = tseg.seg_eval_sample(timg, tlab, crop)
            np.testing.assert_array_equal(ta, ja.transpose(2, 0, 1))
            np.testing.assert_array_equal(ts_, js_)


@pytest.mark.parametrize("shape", [(37, 53), (512, 683), (20, 20)])
def test_align_resize_matches_jax(shape):
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, size=(*shape, 3)).astype(np.float32)
    seg = rng.integers(0, 150, size=shape).astype(np.int32)
    wi, ws = jseg.align_resize(img, seg)
    gi, gs = tseg.align_resize(img, seg)
    assert gi.shape[0] % 32 == 0 and gi.shape[1] % 32 == 0
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)
    assert tseg.align_resize(img)[1] is None
