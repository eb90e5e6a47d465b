"""COCO-style AP evaluator (boxes and masks) in numpy: the port's copy of
``recnext_tpu/tasks/coco_eval.py`` (the port imports nothing of the JAX package).

It stands in for the pycocotools COCOeval that the reference gets through mmdet
(bbox and segm mAP), with pycocotools' semantics:

* 10 IoU thresholds 0.50:0.05:0.95, 101-point interpolated precision,
  maxDets=100 per image and category, area ranges all/small/medium/large;
* greedy score-ordered matching; each non-crowd gt matches at most one det;
  crowd ("iscrowd") gts use IoU = inter/area(det), may match many dets, and
  matched dets are ignored (neither TP nor FP);
* mAP averages over the categories that have at least one gt.

Matching happens per image at ``add()``, so nothing larger than one image's IoU
matrix is held: masks never accumulate in memory.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def box_iou_np(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; for crowd gts, IoU = inter / area(dt) (pycocotools convention)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float64)
    ad = np.maximum(dt[:, 2] - dt[:, 0], 0) * np.maximum(dt[:, 3] - dt[:, 1], 0)
    ag = np.maximum(gt[:, 2] - gt[:, 0], 0) * np.maximum(gt[:, 3] - gt[:, 1], 0)
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = np.where(crowd[None, :], ad[:, None], ad[:, None] + ag[None, :] - inter)
    return inter / np.maximum(union, 1e-12)


def mask_iou_np(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU between boolean masks (D,H,W) and (G,H,W)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float64)
    d = dt.reshape(len(dt), -1).astype(np.float64)
    g = gt.reshape(len(gt), -1).astype(np.float64)
    inter = d @ g.T
    ad = d.sum(1)
    ag = g.sum(1)
    union = np.where(crowd[None, :], ad[:, None], ad[:, None] + ag[None, :] - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEvaluator:
    """Accumulate per-image predictions + ground truth; `summarize()` -> AP dict.

    add(gt, pred):
      gt:   boxes (G,4) xyxy orig coords, labels (G,), iscrowd (G,) bool,
            optional masks (G,H,W) {0,1}
      pred: boxes (D,4), scores (D,), labels (D,), optional masks (D,H,W)
    """

    def __init__(self, num_classes: int, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.iou_types: List[str] = []
        # per iou_type -> cat -> area -> list of (scores, tp(10,D), ig(10,D))
        self._results: Dict = {}
        # per cat -> area -> gt count (same for both iou types)
        self._npig = np.zeros((num_classes, len(AREA_RANGES)), np.int64)

    def _ensure(self, iou_type: str):
        if iou_type not in self._results:
            self.iou_types.append(iou_type)
            self._results[iou_type] = [
                [[] for _ in AREA_RANGES] for _ in range(self.num_classes)]

    def add(self, gt: dict, pred: dict):
        gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt["labels"], np.int64).reshape(-1)
        iscrowd = np.asarray(
            gt.get("iscrowd", np.zeros(len(gt_labels), bool))).astype(bool)
        dt_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        dt_scores = np.asarray(pred["scores"], np.float64).reshape(-1)
        dt_labels = np.asarray(pred["labels"], np.int64).reshape(-1)

        gt_area = (np.maximum(gt_boxes[:, 2] - gt_boxes[:, 0], 0)
                   * np.maximum(gt_boxes[:, 3] - gt_boxes[:, 1], 0))
        dt_area = (np.maximum(dt_boxes[:, 2] - dt_boxes[:, 0], 0)
                   * np.maximum(dt_boxes[:, 3] - dt_boxes[:, 1], 0))
        # pycocotools uses ann['area'] — the SEGMENTATION pixel area for
        # instance gts — for the area-range gates of BOTH bbox and segm eval,
        # and the same area feeds the recall denominator; the per-gt gate and
        # _npig must agree or tps/npig can exceed 1 in a range
        if "masks" in gt and gt.get("masks") is not None and len(gt_labels):
            gt_area_eval = np.asarray(gt["masks"]).reshape(len(gt_labels), -1).sum(1)
        else:
            gt_area_eval = gt_area
        if pred.get("masks") is not None and len(dt_labels):
            dt_area_seg = np.asarray(pred["masks"]).reshape(len(dt_labels), -1).sum(1)
        else:
            dt_area_seg = dt_area

        types = [("bbox", None)]
        if pred.get("masks") is not None and gt.get("masks") is not None:
            types.append(("segm", None))

        for iou_type, _ in types:
            self._ensure(iou_type)
            for c in np.unique(np.concatenate([gt_labels, dt_labels])):
                if c < 0 or c >= self.num_classes:
                    continue
                gi = np.where(gt_labels == c)[0]
                di = np.where(dt_labels == c)[0]
                order = np.argsort(-dt_scores[di], kind="mergesort")
                di = di[order][:self.max_dets]
                if iou_type == "bbox":
                    ious = box_iou_np(dt_boxes[di], gt_boxes[gi], iscrowd[gi])
                    darea = dt_area[di]
                else:
                    ious = mask_iou_np(
                        np.asarray(pred["masks"])[di].astype(bool),
                        np.asarray(gt["masks"])[gi].astype(bool), iscrowd[gi])
                    darea = dt_area_seg[di]
                self._match(iou_type, int(c), ious, dt_scores[di], darea,
                            gt_area_eval[gi], iscrowd[gi])

        # gt counts once (ann['area'] convention, crowd excluded)
        for c in np.unique(gt_labels):
            if c < 0 or c >= self.num_classes:
                continue
            gi = np.where((gt_labels == c) & ~iscrowd)[0]
            for ai, (lo, hi) in enumerate(AREA_RANGES.values()):
                self._npig[int(c), ai] += int(
                    np.sum((gt_area_eval[gi] >= lo) & (gt_area_eval[gi] < hi)))

    def _match(self, iou_type: str, c: int, ious: np.ndarray, scores: np.ndarray,
               dt_area: np.ndarray, gt_area: np.ndarray, crowd: np.ndarray):
        D, G = ious.shape
        T = len(IOU_THRS)
        for ai, (lo, hi) in enumerate(AREA_RANGES.values()):
            gt_ig = crowd | (gt_area < lo) | (gt_area >= hi)
            # sort gts: non-ignored first (pycocotools matching order)
            gorder = np.argsort(gt_ig, kind="mergesort")
            iou_s = ious[:, gorder]
            ig_s = gt_ig[gorder]
            tp = np.zeros((T, D), bool)
            dt_ig = np.zeros((T, D), bool)
            for ti, t in enumerate(IOU_THRS):
                gt_matched = np.zeros(G, bool)
                for d in range(D):
                    best = min(t, 1 - 1e-10)
                    m = -1
                    for g in range(G):
                        if gt_matched[g] and not (crowd[gorder[g]]):
                            continue
                        # gts are ignore-sorted: once we'd move from a real gt
                        # to an ignored one, stop
                        if m > -1 and not ig_s[m] and ig_s[g]:
                            break
                        if iou_s[d, g] < best:
                            continue
                        best = iou_s[d, g]
                        m = g
                    if m == -1:
                        # unmatched det outside the area range is ignored
                        dt_ig[ti, d] = (dt_area[d] < lo) or (dt_area[d] >= hi)
                        continue
                    gt_matched[m] = True
                    dt_ig[ti, d] = ig_s[m]
                    tp[ti, d] = not ig_s[m]
            self._results[iou_type][c][ai].append((scores, tp, dt_ig))

    def _accumulate(self, iou_type: str) -> np.ndarray:
        """(T, C, A) AP array; NaN where a category has no gt."""
        T, C, A = len(IOU_THRS), self.num_classes, len(AREA_RANGES)
        ap = np.full((T, C, A), np.nan)
        res = self._results[iou_type]
        for c in range(C):
            for a in range(A):
                npig = self._npig[c, a]
                if npig == 0:
                    continue
                entries = res[c][a]
                if not entries:
                    ap[:, c, a] = 0.0
                    continue
                scores = np.concatenate([e[0] for e in entries])
                tp = np.concatenate([e[1] for e in entries], axis=1)
                ig = np.concatenate([e[2] for e in entries], axis=1)
                order = np.argsort(-scores, kind="mergesort")
                tp = tp[:, order]
                ig = ig[:, order]
                for ti in range(T):
                    keep = ~ig[ti]
                    tps = np.cumsum(tp[ti][keep])
                    fps = np.cumsum(~tp[ti][keep])
                    if len(tps) == 0:
                        ap[ti, c, a] = 0.0
                        continue
                    rc = tps / npig
                    pr = tps / np.maximum(tps + fps, 1e-12)
                    # monotone non-increasing interpolation
                    pr = np.maximum.accumulate(pr[::-1])[::-1]
                    idx = np.searchsorted(rc, RECALL_THRS, side="left")
                    q = np.where(idx < len(pr), pr[np.minimum(idx, len(pr) - 1)], 0.0)
                    ap[ti, c, a] = q.mean()
        return ap

    def summarize(self) -> Dict[str, float]:
        """{bbox_mAP, bbox_mAP_50, bbox_mAP_75, bbox_mAP_{s,m,l}, segm_*}."""
        out: Dict[str, float] = {}
        area_idx = {k: i for i, k in enumerate(AREA_RANGES)}
        for iou_type in self.iou_types:
            ap = self._accumulate(iou_type)

            def mean(ti, ai):
                v = ap[ti, :, ai]
                v = v[~np.isnan(v)]
                return float(v.mean()) if len(v) else float("nan")

            pre = iou_type
            out[f"{pre}_mAP"] = mean(slice(None), area_idx["all"])
            out[f"{pre}_mAP_50"] = mean(0, area_idx["all"])
            out[f"{pre}_mAP_75"] = mean(5, area_idx["all"])
            out[f"{pre}_mAP_s"] = mean(slice(None), area_idx["small"])
            out[f"{pre}_mAP_m"] = mean(slice(None), area_idx["medium"])
            out[f"{pre}_mAP_l"] = mean(slice(None), area_idx["large"])
        return out
