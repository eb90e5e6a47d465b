"""The port's box ops and detection post-processing (``recnext_tpu_torch/tasks/boxes.py``,
``tasks/detection.py``) against the JAX package's (``recnext_tpu/tasks/``) on the CPU:
box IoU and the delta coding (1e-5 on coordinates), the anchor assignment (its
duplicate force-match targets too), NMS and multiclass NMS (the same kept indices, on
``tests/test_boxes.py``'s random boxes and ``tests/test_box_semantics.py``'s
fixtures), RetinaNet's post-process, the focal and smooth-L1 losses (1e-6 relative),
the anchors and the pyramid's level sizes. The JAX functions run jitted, as the JAX
package runs them."""

import functools

import jax
import numpy as np
import pytest
import torch

from recnext_tpu.tasks import boxes as jboxes
from recnext_tpu.tasks import detection as jdet
from recnext_tpu.tasks import train_det as jtrain
from recnext_tpu_torch.models.recnext import RecNextConfig
from recnext_tpu_torch.tasks import boxes as tboxes
from recnext_tpu_torch.tasks import detection as tdet
from recnext_tpu_torch.tasks import train_det as ttrain
from tests.test_torch_tasks_det import CLASSES, STRIDES, TINY, _anchors, _close, _random_boxes, t


def jitted(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` of the JAX package under ``jax.jit``, the keyword arguments
    static, as the package runs its fixed-shape box ops (one compile per call here;
    op by op they take 4x as long on the CPU)."""
    return jax.jit(functools.partial(fn, **kwargs))(*args)


def test_box_iou_and_coding_match_jax():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 40), _random_boxes(rng, 7)
    _close(tboxes.box_iou(t(a), t(b)).numpy(), jitted(jboxes.box_iou, a, b),
           1e-6, "iou")
    anchors, gt = _random_boxes(rng, 50, max_wh=40) + [0, 0, 1, 1], _random_boxes(rng, 50)
    stds = (0.1, 0.1, 0.2, 0.2)
    for kw in ({}, {"stds": stds, "means": (0.1, 0.0, -0.1, 0.0)}):
        want = jitted(jboxes.encode_boxes, anchors, gt, **kw)
        _close(tboxes.encode_boxes(t(anchors), t(gt), **kw).numpy(), want, 1e-5, "encode")
    deltas = rng.normal(scale=3.0, size=(50, 4)).astype(np.float32)
    deltas[:5, 2:] = 100.0  # beyond the wh-ratio clip
    for kw in ({}, {"stds": stds}, {"max_shape": (60, 70)}):
        want = jitted(jboxes.decode_boxes, anchors, deltas, **kw)
        _close(tboxes.decode_boxes(t(anchors), t(deltas), **kw).numpy(), want, 1e-5, "decode")


def _check_assign(anchors, gtb, gtl):
    want = jitted(jboxes.assign_anchors, anchors, gtb, gtl)
    got = tboxes.assign_anchors(t(anchors), t(gtb), t(gtl))
    for g, w, what in zip(got, want, ("gt", "labels", "pos", "valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    return got


def test_assign_anchors_matches_jax():
    rng = np.random.default_rng(1)
    anchors = _anchors()
    for trial in range(5):
        batch = jtrain.synthetic_det_batch(rng, 1, 64, CLASSES, max_gt=6)
        _check_assign(anchors, batch["gt_boxes"][0], batch["gt_labels"][0])


def test_assign_anchors_duplicate_best_anchor_goes_to_the_highest_gt():
    """Two valid gts (and a padded one) whose best anchor is the same: JAX's scatter on
    the CPU gives it to the last gt; the port takes the highest index by an amax
    reduction, whatever the device's scatter order."""
    anchors = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 60, 60]], np.float32)
    gtb = np.array([[1, 1, 9, 9], [0, 0, 8, 8], [-1, -1, -1, -1], [42, 42, 58, 58]],
                   np.float32)
    gtl = np.array([2, 3, -1, 1], np.int32)
    idx, labels, pos, _ = _check_assign(anchors, gtb, gtl)
    assert int(idx[0]) == 1 and int(labels[0]) == 3 and bool(pos[0])


def _greedy_nms(boxes, scores, iou_thresh, max_out):
    """The textbook sort-then-suppress greedy NMS (tests/test_boxes.py's reference)."""
    order = np.argsort(-scores, kind="stable")
    iou = tboxes.box_iou(t(boxes), t(boxes)).numpy()
    kept = []
    for i in order:
        if scores[i] > 0 and all(iou[i, j] <= iou_thresh for j in kept):
            kept.append(int(i))
        if len(kept) == max_out:
            break
    return kept


def test_nms_keeps_the_same_indices_as_jax_on_random_boxes():
    """tests/test_boxes.py's random configurations (duplicate and zero-area boxes,
    sub-threshold scores): the port's picks are the greedy reference's in all 20, and
    the JAX package's (indices and mask) in the first 6."""
    rng = np.random.default_rng(11)
    for trial in range(20):
        n = int(rng.integers(4, 64))
        boxes = _random_boxes(rng, n)
        if trial % 3 == 0 and n >= 2:
            boxes[1] = boxes[0]
        scores = rng.uniform(0, 1, size=n).astype(np.float32)
        scores[rng.uniform(size=n) < 0.2] = 0.0
        max_out, thr = int(rng.integers(1, 12)), float(rng.uniform(0.3, 0.7))
        gi, gm = tboxes.nms(t(boxes), t(scores), iou_thresh=thr, max_out=max_out)
        kept = [int(i) for i, m in zip(gi, gm) if m]
        assert kept == _greedy_nms(boxes, scores, thr, max_out), trial
        if trial < 6:
            wi, wm = jitted(jboxes.nms, boxes, scores, iou_thresh=thr, max_out=max_out)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), err_msg=str(trial))
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm), err_msg=str(trial))


def _check_multiclass(boxes, probs, **kw):
    want = jitted(jboxes.multiclass_nms, boxes, probs, **kw)
    got = tboxes.multiclass_nms(t(boxes), t(probs), **kw)
    valid = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), valid)
    for g, w, what in zip(got[:3], want[:3], ("boxes", "scores", "labels")):
        np.testing.assert_array_equal(g.numpy()[valid], np.asarray(w)[valid], err_msg=what)


def test_multiclass_nms_matches_jax_on_fixtures_and_random_boxes():
    # tests/test_box_semantics.py's fixtures: a greedy chain, overlapping classes
    chain = np.array([[0, 0, 10, 10], [2, 0, 12, 10], [5, 0, 15, 10]], np.float32)
    _check_multiclass(chain, np.array([[0.9], [0.8], [0.7]], np.float32), max_out=3)
    _check_multiclass(np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]], np.float32),
                      np.array([[0.9, 0.04], [0.8, 0.85], [0.7, 0.6]], np.float32), max_out=6)
    _check_multiclass(np.array([[0, 0, 10, 10], [1, 1, 11, 11]], np.float32),
                      np.array([[0.9, 0.0], [0.8, 0.0]], np.float32), max_out=4)
    rng = np.random.default_rng(5)
    for _ in range(2):
        boxes = _random_boxes(rng, 60)
        probs = rng.uniform(0, 1, size=(60, 4)).astype(np.float32) ** 3
        _check_multiclass(boxes, probs, max_out=int(rng.integers(5, 30)))


def test_retinanet_postprocess_matches_jax():
    rng = np.random.default_rng(6)
    anchors = _anchors()
    level_sizes = [9 * (64 // s) ** 2 for s in STRIDES]
    scores = rng.normal(-3, 2, size=(anchors.shape[0], CLASSES)).astype(np.float32)
    deltas = rng.normal(0, 0.3, size=(anchors.shape[0], 4)).astype(np.float32)
    kw = dict(level_sizes=level_sizes, nms_pre=50, max_det=30)
    want = jitted(jdet.retinanet_postprocess, scores, deltas, anchors, **kw)
    got = tdet.retinanet_postprocess(t(scores), t(deltas), t(anchors), **kw)
    valid = np.asarray(want[3])
    assert valid.sum() > 5
    np.testing.assert_array_equal(got[3].numpy(), valid)
    _close(got[0].numpy()[valid], np.asarray(want[0])[valid], 1e-5, "boxes")
    np.testing.assert_array_equal(got[1].numpy()[valid], np.asarray(want[1])[valid])
    np.testing.assert_array_equal(got[2].numpy()[valid], np.asarray(want[2])[valid])
    with pytest.raises(ValueError, match="level_sizes"):
        tdet.retinanet_postprocess(t(scores), t(deltas), t(anchors), level_sizes=[5])


def test_losses_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 3, size=(300, CLASSES)).astype(np.float32)
    targets = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 300)]
    targets[rng.uniform(size=300) < 0.7] = 0.0
    valid = rng.uniform(size=300) < 0.9
    want = float(jitted(jdet.focal_loss, logits, targets, valid))
    assert float(tdet.focal_loss(t(logits), t(targets), t(valid))) == pytest.approx(want,
                                                                                    rel=1e-6)
    pred = rng.normal(size=(300, 4)).astype(np.float32)
    target = pred + rng.normal(scale=0.2, size=(300, 4)).astype(np.float32)
    want = float(jitted(jdet.smooth_l1, pred, target, valid))
    assert float(tdet.smooth_l1(t(pred), t(target), t(valid))) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("side", [64, 96, 100])
def test_anchors_follow_the_pyramid_level_sizes(side):
    np.testing.assert_array_equal(
        tdet.generate_anchors([(8, 8), (4, 4)], strides=(8, 16), center_offset=0.0),
        jdet.generate_anchors([(8, 8), (4, 4)], strides=(8, 16), center_offset=0.0))
    shapes = ttrain.pyramid_shapes(side)
    model = tdet.RetinaNet(RecNextConfig(**TINY["m"]), num_classes=2, fpn_channels=8).eval()
    with torch.no_grad():
        feats = model.extractor(torch.zeros(1, 3, side, side))
    assert shapes == [tuple(f.shape[2:]) for f in feats]
    if side % 64 == 0:  # the JAX CLI's img // stride agrees there
        assert shapes == [(side // s, side // s) for s in STRIDES]
    assert ttrain.pyramid_shapes(800) == [(200, 200), (100, 100), (50, 50), (25, 25), (13, 13)]
