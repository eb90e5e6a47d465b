"""The port's two-stage detector (``recnext_tpu_torch/tasks/roi.py``,
``tasks/mask_rcnn.py``) against the JAX package's (``recnext_tpu/tasks/``) on the CPU,
at a small size (the tiny M backbone at 64^2, FPN 16, 16 proposals an image, batch 2),
from JAX-initialised variables through ``jax_task_to_torch`` (``strict=True``) and the
same numpy inputs: RoIAlign (odd planes, boxes partly outside, degenerate boxes) and
its input gradient, the FPN level rule, the multilevel RoIAlign and the mask target's
crop, the proposals (ties included), the three heads (the box head's flatten order,
the mask head's x2), Mask R-CNN in eval mode and in train mode with the gt splice, its
inference, its loss and one AdamW step, ``paste_masks`` and the synthetic data with
masks.

Freshly initialised objectness and deltas differ between the two sides by float32
noise, enough to reorder close proposals; the model is compared stage by stage, each
stage of the port fed the JAX stage's proposals (the port's ``_propose`` stands in
for that in the train step). The JAX package runs jitted, as it runs itself, the model
in three programs compiled at once (``jax_reference``)."""

import contextlib
import functools
import itertools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from recnext_tpu.models.recnext import RecNextConfig as JConfig
from recnext_tpu.tasks import mask_rcnn as jmrc
from recnext_tpu.tasks import roi as jroi
from recnext_tpu.tasks import train_det as jtrain
from recnext_tpu_torch.convert import jax_task_to_torch
from recnext_tpu_torch.models.recnext import RecNextConfig
from recnext_tpu_torch.tasks import mask_rcnn as tmrc
from recnext_tpu_torch.tasks import roi as troi
from recnext_tpu_torch.tasks import train_det as ttrain
from recnext_tpu_torch.train.optim import make_optimizer
from recnext_tpu_torch.train.state import TrainState
from tests.test_torch_tasks_det import TINY, _close, _random_boxes, nchw, t
from tests.test_torch_tasks_seg import _check_step_params, _stats_close, f64_grads

CLASSES, FPN_CH, PROPOSALS, SIDE, LR = 5, 16, 16, 64, 2e-4
MAX_DET = 20  # predict's detections an image (the CLI's 100: the mask head's time 5x)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sub(variables, name):
    """A head's flax variables under the task model's name, for ``jax_task_to_torch``,
    and the port's keys without the prefix."""
    sd = jax_task_to_torch({"params": {name: variables["params"]}})
    return {k[len(name) + 1:]: v for k, v in sd.items()}


def _cases():
    """(plane (1, H, W, C), boxes (R, 4) in its coordinates): an odd plane; boxes
    partly or wholly outside it; degenerate boxes (zero or negative extent)."""
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(1, 13, 11, 6)).astype(np.float32)
    inside = _random_boxes(rng, 6, span=8, max_wh=6)
    outside = np.array([[-3, -2, 5, 4], [8, 9, 15, 17], [-6, -6, -1, -2], [2, 3, 30, 40]],
                       np.float32)
    degenerate = np.array([[4, 4, 4, 4], [6, 2, 3, 7], [1, 5, 9, 5]], np.float32)
    return feat, np.concatenate([inside, outside, degenerate])


@pytest.mark.parametrize("out_size", [7, 3])
def test_roi_align_and_its_input_gradient_match_jax(out_size):
    feat, boxes = _cases()
    cot = np.random.default_rng(1).normal(size=(len(boxes), out_size, out_size, 6)).astype(
        np.float32)

    @jax.jit
    def value_and_vjp(f, b, c):
        out, vjp = jax.vjp(lambda f_: jroi.roi_align(f_, b, out_size), f)
        return out, vjp(c)[0]

    want, want_grad = value_and_vjp(jnp.asarray(feat[0]), jnp.asarray(boxes), jnp.asarray(cot))
    x = nchw(feat).requires_grad_()
    got = troi.roi_align(x, t(boxes)[None], out_size)
    assert got.shape == (1, len(boxes), out_size, out_size, 6)
    _close(got[0].detach().numpy(), want, 1e-5, "roi_align")
    got.backward(t(cot)[None])
    _close(x.grad[0].numpy().transpose(1, 2, 0), np.asarray(want_grad), 2e-5,
           "roi_align input gradient")


def test_fpn_levels_multilevel_roi_align_and_the_mask_crop_match_jax():
    rng = np.random.default_rng(2)
    sides = ((40, 36), (20, 18), (10, 9), (5, 5))
    feats = [rng.normal(size=(h, w, 4)).astype(np.float32) for h, w in sides]
    boxes = np.concatenate([_random_boxes(rng, 12, span=120, max_wh=40),
                            _random_boxes(rng, 12, span=100, max_wh=500),
                            np.array([[0, 0, 56, 56], [0, 0, 112, 112], [0, 0, 224, 224],
                                      [0, 0, 448, 448], [3, 3, 3, 9]], np.float32)])
    levels = troi.assign_fpn_level(t(boxes)).numpy()
    np.testing.assert_array_equal(levels, np.asarray(jroi.assign_fpn_level(jnp.asarray(boxes))))
    assert set(levels.tolist()) == {0, 1, 2, 3}
    want = jax.jit(lambda f, b: jroi.multilevel_roi_align(f, b, (4, 8, 16, 32), 5))(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes))
    got = troi.multilevel_roi_align([nchw(f[None]) for f in feats], t(boxes)[None],
                                    (4, 8, 16, 32), 5)
    _close(got[0].numpy(), want, 1e-5, "multilevel_roi_align")
    # the mask target: every gt's mask cropped, then the matched one's (JAX), against
    # the matched one's cropped (the port)
    masks = (rng.uniform(size=(3, 48, 40)) < 0.5).astype(np.uint8)
    props = _random_boxes(rng, 20, span=40, max_wh=25) - 4
    best = rng.integers(0, 3, 20)
    crop = jax.jit(lambda m, b: jroi.roi_align(m.astype(jnp.float32).transpose(1, 2, 0), b,
                                              out_size=12))(jnp.asarray(masks), jnp.asarray(props))
    want = np.asarray(jnp.take_along_axis(crop, jnp.asarray(best)[:, None, None, None],
                                          axis=-1)[..., 0] > 0.5).astype(np.float32)
    got = tmrc.mask_targets(t(masks)[None], t(props)[None], t(best)[None], 12)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_proposals_match_jax_with_exact_ties():
    rng = np.random.default_rng(3)
    anchors = tmrc.rpn_anchors([(s, s) for s in (16, 8, 4, 2, 1)])
    n = anchors.shape[0]
    obj = np.round(rng.normal(size=(2, n)) * 2) / 2  # many exact ties
    obj = obj.astype(np.float32)
    deltas = rng.normal(scale=0.2, size=(2, n, 4)).astype(np.float32)
    kw = dict(img_hw=(SIDE, SIDE), pre_nms_top_n=200, post_nms_top_n=40)
    got = troi.generate_proposals(t(obj), t(deltas), t(anchors), **kw)
    order = torch.sort(t(obj), dim=1, descending=True, stable=True).indices[:, :200]
    for b in range(2):
        np.testing.assert_array_equal(order[b].numpy(), np.asarray(
            jax.lax.top_k(jnp.asarray(obj[b]), 200)[1]))
        boxes, valid = jax.jit(functools.partial(jroi.generate_proposals, **kw))(
            jnp.asarray(obj[b]), jnp.asarray(deltas[b]), jnp.asarray(anchors))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(valid))
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(boxes), rtol=0, atol=1e-5)
        assert np.asarray(valid).sum() > 10


def test_heads_match_jax_and_the_mask_head_x2_is_jax_nearest():
    """Each head alone (the JAX model's initial weights) on random inputs."""
    params = jax_reference()["variables"]["params"]
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(2, s, s, FPN_CH)).astype(np.float32) for s in (8, 4, 2, 1)]
    rois = rng.normal(size=(6, 7, 7, FPN_CH)).astype(np.float32)
    mrois = rng.normal(size=(3, 14, 14, FPN_CH)).astype(np.float32)
    heads = {"rpn": (jmrc.RPNHead(channels=FPN_CH), tmrc.RPNHead(FPN_CH)),
             "box_head": (jmrc.BoxHead(num_classes=CLASSES), tmrc.BoxHead(CLASSES, FPN_CH * 49)),
             "mask_head": (jmrc.MaskHead(num_classes=CLASSES), tmrc.MaskHead(CLASSES, FPN_CH))}
    for (name, (jhead, thead)), x in zip(heads.items(), (feats, rois, mrois)):
        v = {"params": params[name]}
        want = jax.jit(jhead.apply)(v, jax.tree.map(jnp.asarray, x))
        thead.load_state_dict(_sub(v, name), strict=True)
        with torch.no_grad():
            got = thead([nchw(f) for f in x] if name == "rpn" else t(x))
        if name == "mask_head":
            assert got.shape == (3, CLASSES, 28, 28)
            got, want = (got.permute(0, 2, 3, 1),), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g.numpy(), w, 1e-5, (name, i))
    assert got[0].shape == (3, 28, 28, CLASSES)
    with torch.no_grad():  # fc1 reads (7, 7, C) in that order: a channel-major flatten differs
        box = heads["box_head"][1]
        right = box(t(rois))[0]
        wrong = box(t(rois.transpose(0, 3, 1, 2).copy()).reshape(6, 7, 7, FPN_CH))[0]
    assert (wrong - right).abs().max() > 1e-3 * right.abs().max()
    x = rng.normal(size=(2, 7, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        F.interpolate(nchw(x), scale_factor=2, mode="nearest").numpy().transpose(0, 2, 3, 1),
        np.asarray(jax.image.resize(jnp.asarray(x), (2, 14, 10, 3), method="nearest")))


def _compiled(fn, *args):
    """``fast_jit``'s compile of ``fn`` (args may be abstract), not run."""
    fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=fast)


@functools.lru_cache(maxsize=None)
def jax_reference():
    """The JAX Mask R-CNN (backbone BN training, as the JAX CLI builds it; running
    statistics moved off identity) on the tiny M backbone: variables, batch, eval-mode
    outputs and ``predict``; train-mode outputs with the gt splice, their loss terms,
    moved statistics, gradients and one AdamW step. Three programs (the init, eval and
    train), compiled at once in threads (``fast_jit``'s options): their compiles are
    most of this file's time."""
    jm = jmrc.MaskRCNN(backbone_cfg=JConfig(**TINY["m"]), num_classes=CLASSES,
                       fpn_channels=FPN_CH, num_proposals=PROPOSALS,
                       frozen_backbone_stats=False, with_mask=True)
    batch = jtrain.synthetic_det_batch(np.random.default_rng(3), 2, SIDE, CLASSES,
                                       with_masks=True)
    tx = optax.adamw(jtrain.step_lr(LR, 10, warmup_steps=0), weight_decay=0.05)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(0, impl="rbg")  # as jax_init's

    def loss_fn(params, stats):  # the JAX CLI's
        out, mut = jm.apply({"params": params, "batch_stats": stats}, jb["image"],
                            training=True, gt_boxes=jb["gt_boxes"], gt_labels=jb["gt_labels"],
                            mutable=["batch_stats"])
        loss, parts = jmrc.mask_rcnn_loss(out, jb, num_classes=CLASSES,
                                          return_components=True)
        return loss, (out, parts, mut["batch_stats"])

    def train(v):
        (loss, (out, parts, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"], v["batch_stats"])
        updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        return out, parts, stats, loss, optax.apply_updates(v["params"], updates), grads

    def evaluate(v):
        return (jm.apply(v, jb["image"], training=False),
                jm.apply(v, jb["image"], method="predict", max_det=MAX_DET))

    shapes = jax.eval_shape(jm.init, key, jb["image"])
    with ThreadPoolExecutor(3) as pool:
        init, train, evaluate = pool.map(lambda a: _compiled(*a), (
            (jm.init, key, jb["image"]), (train, shapes), (evaluate, shapes)))
    variables = init(key, jb["image"])
    rng = np.random.default_rng(3)
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.2 * np.abs(rng.normal(size=v.shape)).astype(v.dtype),
        variables["batch_stats"])}
    keys = ("train", "parts", "stats", "loss", "params", "grads")
    return dict(zip(keys, train(variables)), **dict(zip(("eval", "predict"),
                                                        evaluate(variables))),
                variables=variables, batch=batch)


def _port_model(variables):
    tm = tmrc.MaskRCNN(RecNextConfig(**TINY["m"]), num_classes=CLASSES, fpn_channels=FPN_CH,
                       num_proposals=PROPOSALS, frozen_backbone_stats=False)
    tm.load_state_dict(jax_task_to_torch(variables, tm), strict=True)
    return tm


def _batch(ref):
    return {k: nchw(v) if k == "image" else t(v) for k, v in ref["batch"].items()}


def _mask_nchw(mlog):
    """JAX's (N, R, m, m, C) mask logits in the port's (N, R, C, m, m)."""
    return np.asarray(mlog).transpose(0, 1, 4, 2, 3)


def _check_heads(got, want, what):
    _close(got["roi_cls"].detach().numpy(), want["roi_cls"], 1e-4, f"{what} roi_cls")
    _close(got["roi_reg"].detach().numpy(), want["roi_reg"], 1e-4, f"{what} roi_reg")
    _close(got["mask_logits"].detach().numpy(), _mask_nchw(want["mask_logits"]), 1e-4,
           f"{what} mask_logits")


def test_converter_keys_and_shapes_are_the_models():
    ref = jax_reference()
    tm = tmrc.MaskRCNN(RecNextConfig(**TINY["m"]), num_classes=CLASSES, fpn_channels=FPN_CH)
    sd = jax_task_to_torch(ref["variables"], tm)
    assert {k.split(".")[0] for k in sd} == {"extractor", "rpn", "box_head", "mask_head"}
    assert sd["box_head.fc1.weight"].shape == (1024, FPN_CH * 49)
    assert sd["mask_head.convs.0.weight"].shape == (256, FPN_CH, 3, 3)
    with pytest.raises(ValueError, match="does not match"):
        jax_task_to_torch(ref["variables"], tmrc.MaskRCNN(
            RecNextConfig(**TINY["m"]), num_classes=CLASSES, fpn_channels=FPN_CH,
            with_mask=False))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_mask_rcnn_matches_jax_stage_by_stage(mode):
    """The RPN's outputs and anchors; the proposals from JAX's RPN outputs (with the gt
    spliced in train mode); the heads on JAX's proposals; the moved statistics."""
    ref = jax_reference()
    want = ref[mode]
    tm = _port_model(ref["variables"]).train(mode == "train")
    b = _batch(ref)
    with torch.no_grad():
        feats, obj, deltas, anchors = tm._rpn(b["image"])
        np.testing.assert_array_equal(anchors.numpy(), np.asarray(want["anchors"]))
        _close(obj.numpy(), want["rpn_obj"], 1e-4, "rpn_obj")
        _close(deltas.numpy(), want["rpn_deltas"], 1e-4, "rpn_deltas")
        props = tm._propose(t(want["rpn_obj"]), t(want["rpn_deltas"]), anchors, (SIDE, SIDE))
        if mode == "train":
            props = tmrc.splice_gt(*props, b["gt_boxes"], b["gt_labels"])
        np.testing.assert_array_equal(props[1].numpy(), np.asarray(want["proposals_valid"]))
        np.testing.assert_allclose(props[0].numpy(), np.asarray(want["proposals"]), rtol=0,
                                   atol=1e-5)
        _check_heads(tm._roi_heads(feats, t(want["proposals"])), want, mode)
    if mode == "train":
        assert int(np.asarray(want["proposals_valid"]).sum()) > 8
        after = jax_task_to_torch({"params": ref["variables"]["params"],
                                   "batch_stats": ref["stats"]}, tm)
        for k, v in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                _stats_close(v, after[k], k)


def test_predict_matches_jax():
    """The box head's refinement, the batched multiclass NMS and the masks of the
    refined boxes, on JAX's proposals (the eval-mode proposals ``predict`` makes)."""
    ref = jax_reference()
    tm = _port_model(ref["variables"]).eval()
    ev = ref["eval"]
    with torch.no_grad():
        feats = tm._rpn(_batch(ref)["image"])[0]
        got = tm._detect(feats, t(ev["proposals"]), t(ev["proposals_valid"]), (SIDE, SIDE),
                         max_det=MAX_DET)
    boxes, scores, labels, masks, valid = (np.asarray(w) for w in ref["predict"])
    assert valid.sum() > 5
    np.testing.assert_array_equal(got[4].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy()[valid], labels[valid])
    _close(got[0].numpy()[valid], boxes[valid], 1e-5, "boxes")
    _close(got[1].numpy()[valid], scores[valid], 1e-4, "scores")
    _close(got[3].numpy()[valid], masks[valid], 1e-4, "mask probabilities")


def test_loss_and_its_terms_match_jax():
    ref = jax_reference()
    out = {k: (t(_mask_nchw(v)) if k == "mask_logits" else t(v))
           for k, v in ref["train"].items()}
    loss, parts = tmrc.mask_rcnn_loss(out, _batch(ref), num_classes=CLASSES,
                                      return_components=True)
    assert float(loss) == pytest.approx(float(ref["loss"]), rel=1e-6)
    for k, v in ref["parts"].items():
        assert float(parts[k]) == pytest.approx(float(v), rel=1e-6), k
    assert all(float(v) > 0.05 for v in parts.values())
    no_masks = {k: v for k, v in _batch(ref).items() if k != "gt_masks"}
    _, parts = tmrc.mask_rcnn_loss(out, no_masks, num_classes=CLASSES, return_components=True)
    assert float(parts["loss_mask"]) == 0.0


@contextlib.contextmanager
def _pinned_relus(pattern):
    """The heads' ReLUs (``tasks/mask_rcnn.py``'s ``F.relu``) record their on/off
    pattern into an empty ``pattern``, or apply the recorded one: y * mask has ReLU's
    value and gradient where the pattern is y's own."""
    record, calls = not pattern, itertools.count()

    def relu(y):
        i = next(calls)
        if record:
            pattern[i] = y > 0
        return y * pattern[i].to(y.dtype)

    tmrc.F = SimpleNamespace(relu=relu, interpolate=F.interpolate)
    try:
        yield
    finally:
        tmrc.F = F


def test_one_train_step_matches_jax():
    """``make_mask_rcnn_train_step`` (forward with the gt splice, the loss, AdamW) with
    JAX's train-mode proposals: loss, gradients against float64's, parameters and
    running statistics after the step. The heads' ReLUs take the float64 path's on/off
    pattern in the step: fp32 noise puts a few of the mask head's 10^6 ReLU inputs on
    the other side of 0, each such flip moving a conv's gradient by one position's term
    (up to 1.4e-4 of its max here), and the FPN's and backbone's after it."""
    ref = jax_reference()
    tm = _port_model(ref["variables"])
    props = (t(ref["train"]["proposals"]), t(ref["train"]["proposals_valid"]))
    tm._propose = lambda *args: props  # the splice leaves JAX's spliced proposals as they are
    opt = make_optimizer(tm.named_parameters(), ttrain.step_lr(LR, 10, warmup_steps=0), 0.05,
                         agc_clip=0.0, decay_all=True)
    state = TrainState.create(tm, opt, ema=False)
    batch = _batch(ref)
    pattern = {}
    with _pinned_relus(pattern):
        exact = f64_grads(tm, lambda m: tmrc.mask_rcnn_loss(
            m(batch["image"].double(), batch["gt_boxes"].double(), batch["gt_labels"]),
            {**batch, "gt_boxes": batch["gt_boxes"].double()}, num_classes=CLASSES))
    with _pinned_relus(pattern):
        got = tmrc.make_mask_rcnn_train_step(CLASSES)(state, batch)
    assert float(got["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    assert {k: pytest.approx(float(got[k]), rel=1e-5) for k in ref["parts"]} == {
        k: float(v) for k, v in ref["parts"].items()}
    after = jax_task_to_torch({"params": ref["params"], "batch_stats": ref["stats"]}, tm)
    raw = jax_task_to_torch({"params": ref["grads"], "batch_stats": ref["stats"]}, tm)
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _stats_close(v, after[k], k)
    _check_step_params(tm, after, raw, exact, lr=LR)


def test_paste_masks_is_the_jax_packages_bit_for_bit():
    rng = np.random.default_rng(6)
    probs = rng.uniform(size=(7, 28, 28)).astype(np.float32)
    boxes = np.concatenate([_random_boxes(rng, 5, span=60, max_wh=50),
                            np.array([[-10, -5, 20, 30], [50, 40, 90, 95]], np.float32)])
    for scale, hw in ((1.0, (64, 64)), (1.37, (47, 70))):
        want = jmrc.paste_masks(probs, boxes, hw, scale)
        got = tmrc.paste_masks(probs, boxes, hw, scale)
        assert got.dtype == np.uint8 and want.sum() > 0
        np.testing.assert_array_equal(got, want)


def test_synthetic_data_with_masks_is_the_jax_packages():
    want = jtrain.synthetic_det_batch(np.random.default_rng(9), 3, 48, 6, with_masks=True)
    got = ttrain.synthetic_det_batch(np.random.default_rng(9), 3, 48, 6, with_masks=True)
    np.testing.assert_array_equal(got["image"], want["image"].transpose(0, 3, 1, 2))
    for k in ("gt_boxes", "gt_labels", "gt_masks"):
        np.testing.assert_array_equal(got[k], want[k])
    assert "gt_masks" not in ttrain.synthetic_det_batch(np.random.default_rng(9), 1, 48, 6)
    jf = jtrain.FakeDetDataset(3, 48, 6, with_masks=True, seed=2)
    tf = ttrain.FakeDetDataset(3, 48, 6, with_masks=True, seed=2)
    for i in range(3):
        np.testing.assert_array_equal(tf[i]["gt_masks"], jf[i]["gt_masks"])
        for k, v in jf.gt_for_eval(i).items():
            np.testing.assert_array_equal(tf.gt_for_eval(i)[k], v, err_msg=k)
