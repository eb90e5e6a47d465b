"""The port's detection recipe against the JAX package's (``recnext_tpu/tasks/``,
``recnext_tpu/data/coco.py``) on the CPU, at small sizes: RetinaNet's outputs in eval
and train mode and one train step (per-image assignment, focal loss plus smooth-L1,
AdamW: loss, parameters, running statistics) for a tiny M and a tiny A backbone, from
JAX-initialised variables through ``jax_task_to_torch`` (``strict=True``); the step
schedule and the synthetic data, the backbone init from a classification checkpoint,
the COCO evaluator, and the COCO loader with its RLE decoding (the same bits). The box
ops, NMS, the post-process and the losses are in ``tests/test_torch_tasks_boxes.py``."""

import functools
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from recnext_tpu.data import coco as jcoco
from recnext_tpu.models.recnext import RecNextConfig as JConfig
from recnext_tpu.tasks import boxes as jboxes
from recnext_tpu.tasks import coco_eval as jeval
from recnext_tpu.tasks import detection as jdet
from recnext_tpu.tasks import train_det as jtrain
from recnext_tpu_torch.convert import jax_task_to_torch, jax_to_torch
from recnext_tpu_torch.data import coco as tcoco
from recnext_tpu_torch.models.recnext import RecNextConfig
from recnext_tpu_torch.tasks import coco_eval as teval
from recnext_tpu_torch.tasks import detection as tdet
from recnext_tpu_torch.tasks import train_det as ttrain
from recnext_tpu_torch.train.optim import make_optimizer
from recnext_tpu_torch.train.state import TrainState
from tests.test_torch_tasks_seg import (_check_step_params, _stats_close, f64_grads, fast_jit,
                                        jax_init)

TINY = {"m": dict(name="tiny_m", family="m", embed_dim=(8, 16, 32, 64), depth=(1, 1, 1, 1),
                  mlp_ratio=(2, 2, 2, 2), num_classes=0),
        "a": dict(name="tiny_a", family="a", embed_dim=(16, 32, 64, 128), depth=(1, 1, 1, 1),
                  mlp_ratio=(2, 2, 2, 2), num_classes=0)}
CLASSES, FPN_CH, LR = 5, 16, 2e-4
SIDE = {"m": 64, "a": 128}  # the A model at 128^2: its last stage's BN sees 4x4 maps
STRIDES = (4, 8, 16, 32, 64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


def _anchors(side=64):
    return jdet.generate_anchors([(side // s, side // s) for s in STRIDES], strides=STRIDES)


def _random_boxes(rng, n, span=80.0, max_wh=30.0):
    xy = rng.uniform(0, span, size=(n, 2)).astype(np.float32)
    wh = rng.uniform(0, max_wh, size=(n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1)


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
    """The JAX RetinaNet (backbone BN training, as the JAX CLI builds it) on the tiny
    ``family`` backbone: variables, batch, eval and train-mode outputs and statistics,
    and one train step as ``make_detection_train_step`` takes it (its per-image loss,
    value_and_grad, optax's AdamW): loss, gradients, parameters, in one jitted call."""
    side = SIDE[family]
    jm = jdet.RetinaNet(backbone_cfg=JConfig(**TINY[family]), num_classes=CLASSES,
                        fpn_channels=FPN_CH, frozen_backbone_stats=False)
    batch = jtrain.synthetic_det_batch(np.random.default_rng(3), 2, side, CLASSES)
    variables = jax_init(jm, jnp.asarray(batch["image"]))
    rng = np.random.default_rng(3)
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.2 * np.abs(rng.normal(size=v.shape)).astype(v.dtype),
        variables["batch_stats"])}
    anchors = jnp.asarray(_anchors(side))
    tx = optax.adamw(jtrain.step_lr(LR, 10, warmup_steps=0), weight_decay=0.05)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):  # make_detection_train_step's
        (cls, reg), mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jb["image"], training=True, mutable=["batch_stats"])

        def per_image(s, p, gtb, gtl):
            idx, labels, pos, valid = jboxes.assign_anchors(anchors, gtb, gtl)
            targets = jax.nn.one_hot(jnp.where(labels >= 0, labels, 0), CLASSES)
            targets = targets * (labels >= 0)[:, None]
            deltas = jnp.where(pos[:, None], jboxes.encode_boxes(anchors, gtb[idx]), 0.0)
            return jdet.focal_loss(s, targets, valid) + jdet.smooth_l1(p, deltas, pos)

        loss = jnp.mean(jax.vmap(per_image)(cls, reg, jb["gt_boxes"], jb["gt_labels"]))
        return loss, ((cls, reg), mut["batch_stats"])

    def run(v):
        eval_out = jm.apply(v, jb["image"], training=False)
        (loss, (train_out, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
        return eval_out, train_out, stats, loss, optax.apply_updates(v["params"], updates), grads

    keys = ("eval", "train", "stats", "loss", "params", "grads")
    return dict(zip(keys, fast_jit(run, variables)), variables=variables, batch=batch,
                side=side)


def _port_model(family, variables):
    tm = tdet.RetinaNet(RecNextConfig(**TINY[family]), num_classes=CLASSES,
                        fpn_channels=FPN_CH, frozen_backbone_stats=False)
    tm.load_state_dict(jax_task_to_torch(variables, tm), strict=True)
    return tm


@pytest.mark.parametrize("family", ["m", "a"])
def test_retinanet_outputs_match_jax_in_eval_and_train_mode(family):
    ref = jax_reference(family)
    tm = _port_model(family, ref["variables"])
    x = nchw(ref["batch"]["image"])
    for mode, want in (("eval", ref["eval"]), ("train", ref["train"])):
        with torch.no_grad():
            got = tm.train(mode == "train")(x)
        assert got[0].shape == (2, _anchors(ref["side"]).shape[0], CLASSES)
        for g, w, what in zip(got, want, ("scores", "deltas")):
            _close(g.numpy(), w, 1e-4, f"{mode} {what}")
    want = jax_task_to_torch({"params": ref["variables"]["params"],
                              "batch_stats": ref["stats"]}, tm)
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _stats_close(v, want[k], k)


@pytest.mark.parametrize("family", ["m", "a"])
def test_one_train_step_matches_jax(family):

    ref = jax_reference(family)
    tm = _port_model(family, ref["variables"])
    opt = make_optimizer(tm.named_parameters(), ttrain.step_lr(LR, 10, warmup_steps=0), 0.05,
                         agc_clip=0.0, decay_all=True)
    state = TrainState.create(tm, opt, ema=False)
    batch = {k: nchw(v) if k == "image" else t(v) for k, v in ref["batch"].items()}
    anchors = t(_anchors(ref["side"]))
    exact = f64_grads(tm, lambda m: tdet.detection_loss(
        *m(batch["image"].double()), anchors.double(), batch["gt_boxes"].double(),
        batch["gt_labels"], CLASSES))
    got = tdet.make_detection_train_step(anchors, CLASSES)(state, batch)
    assert float(got["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    after = jax_task_to_torch({"params": ref["params"], "batch_stats": ref["stats"]}, tm)
    raw = jax_task_to_torch({"params": ref["grads"], "batch_stats": ref["stats"]}, tm)
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _stats_close(v, after[k], k)
    _check_step_params(tm, after, raw, exact, lr=LR)


def test_step_lr_and_synthetic_data_match_jax():
    for kw in ({}, {"warmup_steps": 0}, {"decay_epochs": (1, 2)}):
        js, ts = jtrain.step_lr(2e-4, 7, **kw), ttrain.step_lr(2e-4, 7, **kw)
        for step in (0, 1, 6, 7, 13, 14, 250, 499, 500, 10000):
            assert ts(step) == pytest.approx(float(js(jnp.int32(step))), rel=1e-7), (kw, step)
    want = jtrain.synthetic_det_batch(np.random.default_rng(9), 3, 48, 6)
    got = ttrain.synthetic_det_batch(np.random.default_rng(9), 3, 48, 6)
    np.testing.assert_array_equal(got["image"], want["image"].transpose(0, 3, 1, 2))
    for k in ("gt_boxes", "gt_labels"):
        np.testing.assert_array_equal(got[k], want[k])
    jf, tf = jtrain.FakeDetDataset(4, 48, 6, seed=2), ttrain.FakeDetDataset(4, 48, 6, seed=2)
    for i in range(4):
        np.testing.assert_array_equal(tf[i]["image"], jf[i]["image"].transpose(2, 0, 1))
        for k, v in jf.gt_for_eval(i).items():
            np.testing.assert_array_equal(tf.gt_for_eval(i)[k], v)


def test_init_backbone_from_classification_matches_jax():
    from recnext_tpu.models.recnext import RecNext as JRecNext

    ref = jax_reference("m")
    cls_cfg = dict(TINY["m"], num_classes=10)
    cls = JRecNext(cfg=JConfig(**cls_cfg))
    # the classifier's variables: its init's tree and shapes (traced, not compiled),
    # values from a seed
    rng = np.random.default_rng(5)
    cls_vars = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(v.dtype),
                            jax.eval_shape(cls.init, jax.random.PRNGKey(5),
                                           jnp.zeros((1, 32, 32, 3))))
    want = jax_task_to_torch(jdet.init_backbone_from_classification(ref["variables"],
                                                                    cls_vars))
    task = jax_task_to_torch(ref["variables"])
    got = tdet.init_backbone_from_classification(task, jax_to_torch(cls_vars))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="does not fit the backbone"):
        bad = jax_to_torch(cls_vars)
        bad.pop("stem.stem.0.conv.weight")
        tdet.init_backbone_from_classification(task, bad)


def test_coco_evaluator_matches_jax():
    rng = np.random.default_rng(8)
    evs = (jeval.COCOEvaluator(4), teval.COCOEvaluator(4))
    for _ in range(6):
        gt_boxes = _random_boxes(rng, 5, span=200, max_wh=120) + [0, 0, 2, 2]
        masks = rng.uniform(size=(5, 48, 48)) < 0.3
        gt = {"boxes": gt_boxes, "labels": rng.integers(0, 4, 5),
              "iscrowd": rng.uniform(size=5) < 0.2, "masks": masks}
        n = int(rng.integers(0, 12))
        noisy = np.concatenate([gt_boxes, _random_boxes(rng, 12, span=200, max_wh=120)])[:n]
        pred = {"boxes": noisy + rng.normal(scale=4, size=noisy.shape),
                "scores": rng.uniform(size=n), "labels": rng.integers(0, 4, n),
                "masks": rng.uniform(size=(n, 48, 48)) < 0.3}
        for ev in evs:
            ev.add(gt, pred)
    want, got = evs[0].summarize(), evs[1].summarize()
    assert set(got) == set(want) and "segm_mAP" in got
    np.testing.assert_array_equal(np.array(list(got.values())), np.array(list(want.values())))
    a, b = _random_boxes(rng, 6), _random_boxes(rng, 4)
    crowd = np.array([True, False, False, True])
    np.testing.assert_array_equal(teval.box_iou_np(a, b, crowd), jeval.box_iou_np(a, b, crowd))
    ma, mb = rng.uniform(size=(3, 9, 9)) < 0.5, rng.uniform(size=(4, 9, 9)) < 0.5
    np.testing.assert_array_equal(teval.mask_iou_np(ma, mb, crowd),
                                  jeval.mask_iou_np(ma, mb, crowd))


def _rle_string(counts):
    """pycocotools' compressed RLE encoding (rleToString)."""
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def _runs(mask):
    flat = mask.T.reshape(-1)
    runs, val, n = [], 0, 0
    for v in flat:
        if v != val:
            runs.append(n)
            val, n = v, 0
        n += 1
    return runs + [n]


def coco_folder(root, n=4, seed=0):
    """A COCO-format folder: JPEGs of several sizes, polygons, an uncompressed and a
    compressed RLE, a crowd box, a tiny box the loader drops, an image without boxes."""
    rng = np.random.default_rng(seed)
    (root / "train2017").mkdir(parents=True)
    images, anns = [], []
    for i in range(n):
        h, w = int(rng.integers(50, 120)), int(rng.integers(50, 120))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            root / "train2017" / f"{i:06d}.jpg", quality=92)
        images.append({"id": 10 + i, "file_name": f"{i:06d}.jpg", "height": h, "width": w})
        if i == n - 1:
            continue  # an image without annotations
        for j in range(3):
            x0, y0 = float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2))
            bw, bh = float(rng.uniform(4, w / 2)), float(rng.uniform(4, h / 2))
            mask = np.zeros((h, w), np.uint8)
            mask[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = 1
            seg = ([[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]] if j == 0 else
                   {"size": [h, w], "counts": _runs(mask) if j == 1 else _rle_string(_runs(mask))})
            anns.append({"id": len(anns) + 1, "image_id": 10 + i, "category_id": [3, 7, 9][j],
                         "bbox": [x0, y0, bw, bh], "iscrowd": int(j == 2 and i == 1),
                         "segmentation": seg, "area": bw * bh})
        anns.append({"id": len(anns) + 1, "image_id": 10 + i, "category_id": 3,
                     "bbox": [1.0, 1.0, 0.5, 3.0], "iscrowd": 0, "area": 1.5,
                     "segmentation": [[1, 1, 1.5, 1, 1.5, 4, 1, 4]]})
    cats = [{"id": c, "name": f"c{c}"} for c in (9, 3, 7)]
    (root / "annotations").mkdir()
    (root / "annotations" / "instances_train2017.json").write_text(
        json.dumps({"images": images, "annotations": anns, "categories": cats}))
    return root


def test_coco_loader_and_rle_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    for _ in range(3):
        mask = (rng.uniform(size=(13, 17)) < 0.4).astype(np.uint8)
        s = _rle_string(_runs(mask))
        np.testing.assert_array_equal(tcoco.decode_compressed_rle(s, 13, 17), mask)
        np.testing.assert_array_equal(tcoco.decode_compressed_rle(s, 13, 17),
                                      jcoco.decode_compressed_rle(s, 13, 17))
    root = coco_folder(tmp_path)
    ann = str(root / "annotations" / "instances_train2017.json")
    for train, masks in ((True, True), (False, True), (True, False)):
        kw = dict(img_size=96, max_gt=5, with_masks=masks, train=train, seed=3)
        jds = jcoco.CocoDetection(str(root / "train2017"), ann, **kw)
        tds = tcoco.CocoDetection(str(root / "train2017"), ann, **kw)
        assert len(tds) == len(jds) == (3 if train else 4) and tds.nb_classes == 3
        for i in range(len(jds)):
            want, got = jds[i], tds[i]
            np.testing.assert_array_equal(got["image"], want["image"].transpose(2, 0, 1))
            for k in want:
                if k != "image":
                    np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                                  err_msg=k)
            for k, v in jds.gt_for_eval(i).items():
                np.testing.assert_array_equal(tds.gt_for_eval(i)[k], v, err_msg=k)
        want = jcoco.collate_det([jds[i] for i in range(2)])
        got = tcoco.collate_det([tds[i] for i in range(2)])
        assert set(got) == set(want)
        for k in want:
            if k != "image":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
