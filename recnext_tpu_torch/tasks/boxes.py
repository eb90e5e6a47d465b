"""Box utilities of the detection recipes: IoU, delta coding, MaxIoU anchor
assignment and NMS; the port's counterpart of ``recnext_tpu/tasks/boxes.py`` (what
mmdet supplies around the reference's backbone: MaxIoUAssigner pos 0.5 / neg 0.4,
DeltaXYWHBBoxCoder, multiclass NMS at IoU 0.5).

Every function takes tensors of fixed shapes (ground truth padded with rows of -1)
and runs on the tensors' device with no host synchronisation: no ``.item()`` and no
Python branch on a tensor, so a detection step never waits on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (N, 4) and (M, 4) xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-9)


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor,
                 means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
                 stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """mmdet's bbox2delta: (dx, dy, dw, dh) of ``gt`` relative to ``anchors``,
    normalised by ``means`` and ``stds``; degenerate anchors and boxes are clamped so
    that the encoding stays finite."""
    aw = (anchors[:, 2] - anchors[:, 0]).clamp_min(1e-3)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp_min(1e-3)
    ax, ay = anchors[:, 0] + aw / 2, anchors[:, 1] + ah / 2
    gw = (gt[:, 2] - gt[:, 0]).clamp_min(1e-6)
    gh = (gt[:, 3] - gt[:, 1]).clamp_min(1e-6)
    gx, gy = gt[:, 0] + gw / 2, gt[:, 1] + gh / 2
    deltas = torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                          torch.log(gh / ah)], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
                 stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0),
                 wh_ratio_clip: float = 16 / 1000,
                 max_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """mmdet's delta2bbox: denormalise, clamp dw and dh to +-|log(wh_ratio_clip)|,
    apply to the anchors; clamp to [0, W] x [0, H] where ``max_shape`` = (H, W)."""
    d = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    aw, ah = anchors[:, 2] - anchors[:, 0], anchors[:, 3] - anchors[:, 1]
    ax, ay = anchors[:, 0] + aw / 2, anchors[:, 1] + ah / 2
    cx, cy = d[:, 0] * aw + ax, d[:, 1] * ah + ay
    max_ratio = abs(math.log(wh_ratio_clip))
    w = torch.exp(d[:, 2].clamp(-max_ratio, max_ratio)) * aw
    h = torch.exp(d[:, 3].clamp(-max_ratio, max_ratio)) * ah
    out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    if max_shape is not None:
        hh, ww = max_shape
        out = torch.stack([out[:, 0].clamp(0, ww), out[:, 1].clamp(0, hh),
                           out[:, 2].clamp(0, ww), out[:, 3].clamp(0, hh)], dim=-1)
    return out


def assign_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   *, pos_iou: float = 0.5, neg_iou: float = 0.4):
    """MaxIoU assignment of (A, 4) anchors to (G, 4) ground truth (padded rows: label
    -1). Returns (matched gt index, labels (the class of positives, -1 otherwise),
    positive mask, valid mask: not in the band between ``neg_iou`` and ``pos_iou``).
    The best anchor of each valid gt is forced positive for it; where several gts
    share their best anchor, the highest gt index takes it, as the JAX package's
    scatter does on the CPU, whatever order the device's scatter runs in."""
    a, g = anchors.shape[0], gt_boxes.shape[0]
    gt_valid = gt_labels >= 0
    iou = box_iou(anchors, gt_boxes) * gt_valid[None, :]
    best_iou = iou.max(dim=1).values
    best_gt = iou.argmax(dim=1)  # the first maximum, as jnp.argmax
    pos = best_iou >= pos_iou
    valid = pos | (best_iou < neg_iou)
    # a padded gt scatters to the extra slot a, which is dropped
    target = torch.where(gt_valid, iou.argmax(dim=0), torch.full_like(gt_labels, a).long())
    forced = torch.full((a + 1,), -1, dtype=torch.long, device=anchors.device)
    forced = forced.scatter_reduce(0, target, torch.arange(g, device=anchors.device),
                                   "amax")[:a]
    force = forced >= 0
    best_gt = torch.where(force, forced, best_gt)
    pos = pos | force
    valid = valid | force
    labels = torch.where(pos, gt_labels.long()[best_gt], torch.full_like(best_gt, -1))
    return best_gt, labels, pos, valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, *, iou_thresh: float = 0.5,
        max_out: int = 100, iou: Optional[torch.Tensor] = None):
    """Greedy NMS of fixed shape over (..., N) scores (a leading class axis is
    vectorised, all rows sharing the (N, N) ``iou`` of ``boxes``): ``max_out`` argmax
    picks, each suppressing its IoU > ``iou_thresh`` neighbours and itself, so only kept
    boxes suppress; ties go to the first index. Scores <= 0 are never kept. Returns
    (indices (..., max_out), keep mask); unused slots have index 0 and mask False."""
    if iou is None:
        iou = box_iou(boxes, boxes)
    s = scores.float().clone()
    squeeze = s.dim() == 1
    if squeeze:
        s = s[None]
    neg = torch.tensor(float("-inf"), device=s.device)
    idx, vals = [], []
    for _ in range(max_out):
        i = s.argmax(dim=1)
        vals.append(s.gather(1, i[:, None])[:, 0])
        idx.append(i)
        s = torch.where(iou[i] > iou_thresh, neg, s)
        s = s.scatter(1, i[:, None], neg.expand(s.shape[0], 1))
    idx, vals = torch.stack(idx, dim=1), torch.stack(vals, dim=1)
    mask = vals > 0
    idx = torch.where(mask, idx, torch.zeros_like(idx))
    return (idx[0], mask[0]) if squeeze else (idx, mask)


def multiclass_nms(boxes: torch.Tensor, probs: torch.Tensor, *, score_thresh: float = 0.05,
                   iou_thresh: float = 0.5, max_out: int = 100):
    """mmdet's multiclass NMS over one box set: NMS per class (scores below
    ``score_thresh`` zeroed), all classes at once on one shared IoU matrix, then the
    top ``max_out`` across classes (a stable sort: ties in index order). Returns
    (boxes (max_out, 4), scores, labels, valid)."""
    num_classes = probs.shape[-1]
    iou = box_iou(boxes, boxes)
    s = torch.where(probs >= score_thresh, probs.float(), torch.zeros_like(probs.float())).t()
    idx, keep = nms(boxes, s, iou_thresh=iou_thresh, max_out=max_out, iou=iou)
    sc = s.gather(1, idx) * keep
    bx = boxes[idx.reshape(-1)]
    labels = torch.arange(num_classes, device=probs.device).repeat_interleave(max_out)
    top_s, top_i = torch.sort(sc.reshape(-1), descending=True, stable=True)
    top_s, top_i = top_s[:max_out], top_i[:max_out]
    valid = top_s > 0
    return bx[top_i], top_s, torch.where(valid, labels[top_i], torch.zeros_like(top_i)), valid
