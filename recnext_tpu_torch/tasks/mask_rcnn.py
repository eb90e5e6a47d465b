"""Mask R-CNN, NCHW: the port's counterpart of ``recnext_tpu/tasks/mask_rcnn.py`` (the
reference's COCO recipe ``mask_rcnn_recnext_m{3,4,5}_fpn_1x_coco.py`` on mmdet: an
RPNHead, the shared-2FC box head and the 4-conv mask head over an FPN on the RecNext
backbone), with the JAX package's fixed shapes: a constant number of proposals an
image with a validity mask, top-k and NMS of fixed size, no host synchronisation.

The model runs in stages (internal methods): ``_rpn`` (features, objectness, deltas,
anchors), ``_propose`` (proposals, no gradient), ``_roi_heads`` (the box head on 7^2
RoIs, the mask head on 14^2 RoIs) and, at inference, ``_detect`` (refine, NMS, masks on
the refined boxes); a caller can hand one stage's proposals to another model. RoIs are
channels-last (``tasks/roi.py``): the box head flattens (R, 7, 7, C) in the JAX
package's order; mask logits are (N, R, classes, 28, 28).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from recnext_tpu_torch.models.recnext import RecNextConfig
from recnext_tpu_torch.tasks.boxes import (assign_anchors, box_iou, decode_boxes, encode_boxes,
                                           multiclass_nms)
from recnext_tpu_torch.tasks.detection import DetectionBackbone, generate_anchors
from recnext_tpu_torch.tasks.roi import (generate_proposals, multilevel_roi_align, pack_levels,
                                         roi_align_rows)

# mmdet's Shared2FCBBoxHead delta coder (target_stds); the RPN's coder keeps all-1 stds
RCNN_DELTA_STDS = (0.1, 0.1, 0.2, 0.2)
RPN_STRIDES = (4, 8, 16, 32, 64)
ROI_STRIDES = (4, 8, 16, 32)  # P2-P5: RoIs never pool from P6


class RPNHead(nn.Module):
    """A shared 3x3 conv and ReLU, then objectness (``num_anchors``) and deltas
    (``num_anchors`` x 4) a location; returns (N, sum_l H_l W_l A) and (N, sum_l H_l W_l
    A, 4), anchors ordered (y, x, anchor) per level as the JAX package's NHWC reshape
    orders them."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls = nn.Conv2d(channels, num_anchors, 1)
        self.reg = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        obj, deltas = [], []
        for f in feats:
            y = F.relu(self.conv(f))
            n = f.shape[0]
            obj.append(self.cls(y).permute(0, 2, 3, 1).reshape(n, -1))
            deltas.append(self.reg(y).permute(0, 2, 3, 1).reshape(n, -1, 4))
        return torch.cat(obj, dim=1), torch.cat(deltas, dim=1)


class BoxHead(nn.Module):
    """mmdet's Shared2FCBBoxHead: (R, 7, 7, C) RoIs flattened channels-last (the JAX
    package's order) -> fc1, fc2 of ``hidden`` with ReLU -> class logits (C + 1, the
    last background) and class-agnostic deltas."""

    def __init__(self, num_classes: int = 80, in_features: int = 256 * 49, hidden: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.cls = nn.Linear(hidden, num_classes + 1)
        self.reg = nn.Linear(hidden, 4)

    def forward(self, rois: torch.Tensor):
        x = F.relu(self.fc1(rois.reshape(rois.shape[0], -1)))
        x = F.relu(self.fc2(x))
        return self.cls(x), self.reg(x)


class MaskHead(nn.Module):
    """mmdet's FCNMaskHead: 4 x (3x3 conv, ReLU), nearest x2, a 3x3 conv and ReLU, then
    per-class 1x1 logits: (R, 14, 14, C) channels-last RoIs -> (R, classes, 28, 28)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256, channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(in_channels if i == 0 else channels, channels, 3,
                                             padding=1) for i in range(4))
        self.up = nn.Conv2d(channels, channels, 3, padding=1)
        self.logits = nn.Conv2d(channels, num_classes, 1)

    def forward(self, rois: torch.Tensor):
        x = rois.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.interpolate(x, scale_factor=2, mode="nearest")  # jax.image.resize's at 2x
        return self.logits(F.relu(self.up(x)))


def splice_gt(proposals: torch.Tensor, valid: torch.Tensor, gt_boxes: torch.Tensor,
              gt_labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mmdet's add_gt_as_proposals in fixed shape: each image's G ground-truth boxes
    (padded rows: label -1, left alone) into its last G proposal slots, made valid."""
    g, r = gt_boxes.shape[1], proposals.shape[1]
    if g > r:
        raise ValueError(f"{g} ground-truth slots do not fit in {r} proposals")
    gv = gt_labels >= 0
    tail = torch.where(gv[..., None], gt_boxes.to(proposals.dtype), proposals[:, r - g:])
    return (torch.cat([proposals[:, :r - g], tail], dim=1),
            torch.cat([valid[:, :r - g], gv | valid[:, r - g:]], dim=1))


def rpn_anchors(feat_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """The RPN's anchors over levels of ``feat_shapes`` at strides 4-64: mmdet's single
    scale 8 a level and ratios 0.5, 1, 2 (sides 32-512 px)."""
    return generate_anchors(feat_shapes, strides=RPN_STRIDES, scales=(1.0,),
                            ratios=(0.5, 1.0, 2.0), base_size=8)


class MaskRCNN(nn.Module):
    def __init__(self, backbone_cfg: RecNextConfig, num_classes: int = 80,
                 fpn_channels: int = 256, num_proposals: int = 256,
                 frozen_backbone_stats: bool = True, with_mask: bool = True):
        super().__init__()
        self.num_classes, self.num_proposals = num_classes, num_proposals
        self.extractor = DetectionBackbone(backbone_cfg, fpn_channels, num_outs=5,
                                           frozen_backbone_stats=frozen_backbone_stats)
        self.rpn = RPNHead(fpn_channels)
        self.box_head = BoxHead(num_classes, fpn_channels * 49)
        self.mask_head = MaskHead(num_classes, fpn_channels) if with_mask else None
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """``rpn_anchors`` for the pyramid's own level sizes, made once for each size
        and device."""
        shapes = tuple(tuple(f.shape[2:]) for f in feats)
        key = (shapes, feats[0].device)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(rpn_anchors(shapes)).to(feats[0].device)
        return self._anchors[key]

    def forward(self, x: torch.Tensor, gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The RPN's outputs, the proposals (with ``gt_boxes`` and ``gt_labels``, the
        ground truth spliced into their last slots, mmdet's add_gt_as_proposals) and
        the RoI heads' outputs, for ``mask_rcnn_loss``."""
        feats, obj, deltas, anchors = self._rpn(x)
        with torch.no_grad():
            proposals, valid = self._propose(obj.detach(), deltas.detach(), anchors,
                                             tuple(x.shape[2:]))
            if gt_boxes is not None and gt_labels is not None:
                proposals, valid = splice_gt(proposals, valid, gt_boxes, gt_labels)
        return {"anchors": anchors, "rpn_obj": obj, "rpn_deltas": deltas,
                "proposals": proposals, "proposals_valid": valid,
                **self._roi_heads(feats, proposals)}

    def _rpn(self, x: torch.Tensor):
        feats = self.extractor(x)
        obj, deltas = self.rpn(feats)
        return feats, obj, deltas, self.anchors(feats)

    def _propose(self, obj, deltas, anchors, img_hw):
        return generate_proposals(obj, deltas, anchors, img_hw=img_hw,
                                  post_nms_top_n=self.num_proposals)

    def _roi_heads(self, feats, proposals) -> Dict[str, torch.Tensor]:
        packed = pack_levels(feats[:4])
        b, r = proposals.shape[:2]
        rois = multilevel_roi_align(feats[:4], proposals, ROI_STRIDES, 7, packed=packed)
        cls, reg = self.box_head(rois.reshape(b * r, *rois.shape[2:]))
        out = {"roi_cls": cls.reshape(b, r, -1), "roi_reg": reg.reshape(b, r, 4)}
        if self.mask_head is not None:
            mrois = multilevel_roi_align(feats[:4], proposals, ROI_STRIDES, 14, packed=packed)
            mlog = self.mask_head(mrois.reshape(b * r, *mrois.shape[2:]))
            out["mask_logits"] = mlog.reshape(b, r, *mlog.shape[1:])
        return out

    @torch.no_grad()
    def predict(self, x: torch.Tensor, *, score_thresh: float = 0.05, iou_thresh: float = 0.5,
                max_det: int = 100):
        """mmdet's test path in fixed shape: RPN proposals -> the box head's refined
        boxes and class scores -> multiclass NMS -> the mask head on the refined boxes.
        Returns (boxes (N, D, 4) in canvas coordinates, scores (N, D), labels (N, D),
        mask probabilities (N, D, 28, 28) or None, valid (N, D))."""
        img_hw = tuple(x.shape[2:])
        feats, obj, deltas, anchors = self._rpn(x)
        proposals, valid = self._propose(obj, deltas, anchors, img_hw)
        return self._detect(feats, proposals, valid, img_hw, score_thresh=score_thresh,
                            iou_thresh=iou_thresh, max_det=max_det)

    def _detect(self, feats, proposals, pvalid, img_hw, *, score_thresh: float = 0.05,
                iou_thresh: float = 0.5, max_det: int = 100):
        packed = pack_levels(feats[:4])
        b, r = proposals.shape[:2]
        rois = multilevel_roi_align(feats[:4], proposals, ROI_STRIDES, 7, packed=packed)
        cls, reg = self.box_head(rois.reshape(b * r, *rois.shape[2:]))
        probs = torch.softmax(cls.float(), dim=-1)[:, :-1].reshape(b, r, -1)
        probs = probs * pvalid.float()[..., None]
        boxes = decode_boxes(proposals.reshape(-1, 4), reg.float(), stds=RCNN_DELTA_STDS,
                             max_shape=img_hw).reshape(b, r, 4)
        det_boxes, det_scores, det_labels, det_valid = multiclass_nms(
            boxes, probs, score_thresh=score_thresh, iou_thresh=iou_thresh, max_out=max_det)
        mask_probs = None
        if self.mask_head is not None:
            mrois = multilevel_roi_align(feats[:4], det_boxes, ROI_STRIDES, 14, packed=packed)
            d = det_boxes.shape[1]
            mlog = self.mask_head(mrois.reshape(b * d, *mrois.shape[2:]))
            mlog = mlog.reshape(b, d, *mlog.shape[1:])
            sel = det_labels.clamp(0, mlog.shape[2] - 1)
            mlog = mlog.gather(2, sel[:, :, None, None, None].expand(
                b, d, 1, *mlog.shape[3:]))[:, :, 0]
            mask_probs = torch.sigmoid(mlog.float())
        return det_boxes, det_scores, det_labels, mask_probs, det_valid


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray, orig_hw, scale: float,
                thresh: float = 0.5) -> np.ndarray:
    """(D, m, m) mask probabilities and canvas-coordinate boxes -> (D, H, W) binary
    masks in the original image's coordinates (boxes divided by the letterbox scale),
    on the host (numpy and PIL): mmdet's _do_paste_mask, the JAX package's copy."""
    from PIL import Image

    H, W = int(orig_hw[0]), int(orig_hw[1])
    out = np.zeros((len(boxes), H, W), np.uint8)
    for i, (box, mp) in enumerate(zip(np.asarray(boxes) / scale, np.asarray(mask_probs))):
        x1, y1, x2, y2 = box
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        w, h = max(x2i - x1i, 1), max(y2i - y1i, 1)
        m = Image.fromarray((mp * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR)
        m = np.asarray(m, np.float32) / 255.0 >= thresh
        sx1, sy1 = max(0, -x1i), max(0, -y1i)
        dx1, dy1 = max(0, x1i), max(0, y1i)
        dx2, dy2 = min(W, x1i + w), min(H, y1i + h)
        if dx2 > dx1 and dy2 > dy1:
            out[i, dy1:dy2, dx1:dx2] = m[sy1:sy1 + dy2 - dy1, sx1:sx1 + dx2 - dx1]
    return out


def _fp32(x: torch.Tensor) -> torch.Tensor:
    """The loss's arithmetic: fp32, as the JAX package's, or float64 where given."""
    return x if x.dtype == torch.float64 else x.float()


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per image (rows): the sum of ``values`` where ``mask`` over max(count, 1)."""
    zero = torch.zeros_like(values)
    return torch.where(mask, values, zero).sum(-1) / mask.sum(-1).clamp_min(1)


def _smooth_l1_rows(pred, target, mask, beta: float = 1.0 / 9.0):
    """``detection.smooth_l1`` of each image (rows of (N, R, 4))."""
    d = (_fp32(pred) - target).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    loss = torch.where(mask[..., None], loss, torch.zeros_like(loss))
    return loss.sum(dim=(-2, -1)) / mask.sum(-1).clamp_min(1)


def mask_targets(gt_masks: torch.Tensor, proposals: torch.Tensor, matched: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """Each proposal's matched ground-truth mask ((N, G, H, W) binary at image
    resolution; ``matched`` (N, R) its index) RoIAligned to ``out_size``^2 over the
    proposal and thresholded at 0.5: the JAX package's crop of every gt's mask then
    the matched one's, with the matched mask selected first (the same arithmetic per
    channel). Returns (N, R, out_size, out_size) float 0/1."""
    n, g, h, w = gt_masks.shape
    r = proposals.shape[1]
    dev = gt_masks.device
    plane = torch.arange(n, device=dev)[:, None] * g + matched
    side = (torch.full((n * r,), s, device=dev) for s in (h, w))
    crop = roi_align_rows(gt_masks.reshape(-1, 1), plane.reshape(-1) * (h * w), *side,
                          proposals.reshape(-1, 4).float(), out_size)
    return (crop[..., 0] > 0.5).float().reshape(n, r, out_size, out_size)


def _match(proposals, valid, gt_boxes, gt_labels):
    """Each proposal's best gt by IoU (padded gts excluded) and whether it is positive
    (IoU >= 0.5 and valid)."""
    iou = box_iou(proposals, gt_boxes) * (gt_labels >= 0)[:, None, :]
    best_iou, best = iou.max(dim=-1)  # the first maximum, as jnp.argmax
    return best, (best_iou >= 0.5) & valid


def mask_rcnn_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], *,
                   num_classes: int, return_components: bool = False):
    """The JAX package's loss, each term the mean over the images: the RPN's BCE
    balanced 0.5 / 0.5 over positive (IoU 0.7) and negative (0.3) anchors plus
    smooth-L1 on the positives; the RoI head's cross-entropy over C + 1 classes
    weighted 0.25 positive / 0.75 negative (IoU 0.5) plus smooth-L1 in
    ``RCNN_DELTA_STDS`` units; the mask BCE of the matched class's logits against the
    matched gt mask cropped to each positive proposal (``mask_targets``), where the
    outputs have mask logits and the batch has ``gt_masks``. batch: gt_boxes (N, G, 4)
    and gt_labels (N, G), padded with -1."""
    anchors, gtb, gtl = outputs["anchors"], batch["gt_boxes"], batch["gt_labels"]
    n, a = outputs["rpn_obj"].shape
    with torch.no_grad():
        idx, _, pos, valid = assign_anchors(anchors, gtb, gtl, pos_iou=0.7, neg_iou=0.3)
        matched = gtb.gather(1, idx[..., None].expand(n, a, 4))
        tgt = encode_boxes(anchors.repeat(n, 1), matched.reshape(-1, 4)).reshape(n, a, 4)
        tgt = torch.where(pos[..., None], tgt, torch.zeros_like(tgt))
    bce = _bce(_fp32(outputs["rpn_obj"]), pos.float())
    bce = 0.5 * (_masked_mean(bce, pos) + _masked_mean(bce, valid & ~pos))
    rpn_loss = (bce + _smooth_l1_rows(outputs["rpn_deltas"], tgt, pos)).mean()

    props, pvalid = outputs["proposals"], outputs["proposals_valid"]
    n, r = props.shape[:2]
    best, pos = _match(props, pvalid, gtb, gtl)
    labels = torch.where(pos, gtl.long().gather(1, best), torch.full_like(best, num_classes))
    logp = torch.log_softmax(_fp32(outputs["roi_cls"]), dim=-1)
    ce = -logp.gather(-1, labels[..., None])[..., 0]
    ce = 0.25 * _masked_mean(ce, pos) + 0.75 * _masked_mean(ce, pvalid & ~pos)
    matched = gtb.gather(1, best[..., None].expand(n, r, 4))
    tgt = encode_boxes(props.reshape(-1, 4), matched.reshape(-1, 4),
                       stds=RCNN_DELTA_STDS).reshape(n, r, 4)
    tgt = torch.where(pos[..., None], tgt, torch.zeros_like(tgt))
    roi_loss = (ce + _smooth_l1_rows(outputs["roi_reg"], tgt, pos)).mean()

    mask_loss = torch.zeros((), device=props.device)
    if "mask_logits" in outputs and "gt_masks" in batch:
        mlog = outputs["mask_logits"]
        m = mlog.shape[-1]
        target = mask_targets(batch["gt_masks"], props, best, m)
        cls = gtl.long().gather(1, best).clamp(0, mlog.shape[2] - 1)
        logit = mlog.gather(2, cls[:, :, None, None, None].expand(n, r, 1, m, m))[:, :, 0]
        bce = _bce(_fp32(logit), target)
        bce = torch.where(pos[..., None, None], bce, torch.zeros_like(bce))
        mask_loss = (bce.sum(dim=(1, 2, 3)) / (pos.sum(-1) * m * m).clamp_min(1)).mean()

    total = rpn_loss + roi_loss + mask_loss
    if return_components:
        return total, {"loss_rpn": rpn_loss, "loss_roi": roi_loss, "loss_mask": mask_loss}
    return total


def make_mask_rcnn_train_step(num_classes: int, dtype: torch.dtype = torch.float32):
    """``train_step(state, batch) -> {"loss", "loss_rpn", "loss_roi", "loss_mask"}`` for
    a Mask R-CNN train state (``train/state.py``, no EMA): the forward in ``dtype``
    (``train/step.py:forward_model``) with the ground truth spliced into the
    proposals, ``mask_rcnn_loss``, backward, the state's optimizer. batch = {"image"
    (N, 3, H, W), "gt_boxes" (N, G, 4), "gt_labels" (N, G), padded with -1, and
    optionally "gt_masks" (N, G, H, W)}, on the model's device."""
    from recnext_tpu_torch.train.step import forward_model

    def train_step(state, batch):
        state.model.train()
        state.optimizer.zero_grad()
        out = forward_model(state.model, batch["image"], dtype, gt_boxes=batch["gt_boxes"],
                            gt_labels=batch["gt_labels"])
        loss, parts = mask_rcnn_loss(out, batch, num_classes=num_classes,
                                     return_components=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    return train_step
