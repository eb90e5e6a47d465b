"""Detection, NCHW: the port's counterpart of ``recnext_tpu/tasks/detection.py``.

``DetectionBackbone`` is the reference's mmdet backbone registration (RecNext
features in the frozen-BN mode, then an FPN to P2-P6); ``RetinaHead`` and
``RetinaNet`` the single-stage detector the JAX package trains end to end, with
mmdet's init (prediction layers Normal(0.01), the classifier's bias at the focal
prior -log((1 - 0.01) / 0.01)); ``focal_loss``, ``smooth_l1`` and
``make_detection_train_step`` its training (per-image MaxIoU assignment, focal loss
plus smooth-L1, AdamW); ``retinanet_postprocess`` its decode (a per-level top-1000
prefilter, then multiclass NMS); ``generate_anchors`` the anchors (a copy, numpy).
``init_backbone_from_classification`` loads a classification checkpoint's state dict
into a task model's backbone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from recnext_tpu_torch.models.recnext import _TRUNC_STD, RecNext, RecNextConfig, init_weights
from recnext_tpu_torch.tasks.boxes import (
    assign_anchors,
    decode_boxes,
    encode_boxes,
    multiclass_nms,
)
from recnext_tpu_torch.tasks.fpn import FPN

FOCAL_PRIOR_BIAS = -4.59512  # -log((1 - pi) / pi), pi = 0.01


class DetectionBackbone(nn.Module):
    """RecNext features -> FPN P2..P6 (``num_outs`` levels), the backbone's BN frozen
    where ``frozen_backbone_stats``."""

    def __init__(self, backbone_cfg: RecNextConfig, fpn_channels: int = 256,
                 num_outs: int = 5, frozen_backbone_stats: bool = True):
        super().__init__()
        self.backbone = RecNext(backbone_cfg, frozen_stats=frozen_backbone_stats)
        self.neck = FPN(backbone_cfg.embed_dim, fpn_channels, num_outs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.neck(self.backbone.features(x))


def init_backbone_from_classification(task_state: Mapping[str, torch.Tensor],
                                      cls_state: Mapping[str, torch.Tensor]
                                      ) -> Dict[str, torch.Tensor]:
    """``task_state`` (a task model's state dict) with its backbone (the keys under the
    one prefix that ends in ``backbone.``: ``backbone.`` or ``extractor.backbone.``) taken
    from ``cls_state``, a classification model's state dict
    (``train/finetune.py:read_weights``); the classifier (``head.*``) is dropped and
    every other backbone key must match in name and shape (BN's
    ``num_batches_tracked`` may be absent); the neck and head keep theirs."""
    prefixes = {k[: k.index("backbone.") + len("backbone.")] for k in task_state
                if "backbone." in k}
    if len(prefixes) != 1:
        raise ValueError(f"expected one backbone prefix in the task model, got {prefixes}")
    prefix = prefixes.pop()
    want = {k[len(prefix):]: v for k, v in task_state.items() if k.startswith(prefix)}
    got = {k: v for k, v in cls_state.items() if not k.startswith("head.")}
    missing = sorted(k for k in set(want) - set(got) if not k.endswith("num_batches_tracked"))
    extra = sorted(set(got) - set(want))
    shapes = sorted(k for k in set(want) & set(got)
                    if tuple(want[k].shape) != tuple(got[k].shape))
    if missing or extra or shapes:
        raise ValueError(f"classification checkpoint does not fit the backbone: missing "
                         f"{missing[:5]} unexpected {extra[:5]} shape mismatch {shapes[:5]}")
    out = dict(task_state)
    for k, v in got.items():
        out[prefix + k] = v.detach().to(device=want[k].device, dtype=want[k].dtype)
    return out


class RetinaHead(nn.Module):
    """Shared towers of ``stacked_convs`` 3x3 convs with ReLU for classification and
    regression over every FPN level; returns (N, sum_l H_l W_l A, classes) scores and
    (N, sum_l H_l W_l A, 4) deltas, anchors ordered (y, x, anchor) per level as the
    JAX package's NHWC reshape orders them."""

    def __init__(self, num_classes: int = 80, num_anchors: int = 9, channels: int = 256,
                 stacked_convs: int = 4):
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, num_anchors
        self.cls_convs = nn.ModuleList(nn.Conv2d(channels, channels, 3, padding=1)
                                       for _ in range(stacked_convs))
        self.reg_convs = nn.ModuleList(nn.Conv2d(channels, channels, 3, padding=1)
                                       for _ in range(stacked_convs))
        self.retina_cls = nn.Conv2d(channels, num_anchors * num_classes, 3, padding=1)
        self.retina_reg = nn.Conv2d(channels, num_anchors * 4, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_scores, bbox_preds = [], []
        for f in feats:
            c = r = f
            for conv in self.cls_convs:
                c = F.relu(conv(c))
            for conv in self.reg_convs:
                r = F.relu(conv(r))
            n = f.shape[0]
            cls_scores.append(self.retina_cls(c).permute(0, 2, 3, 1).reshape(
                n, -1, self.num_classes))
            bbox_preds.append(self.retina_reg(r).permute(0, 2, 3, 1).reshape(n, -1, 4))
        return torch.cat(cls_scores, dim=1), torch.cat(bbox_preds, dim=1)


class RetinaNet(nn.Module):
    def __init__(self, backbone_cfg: RecNextConfig, num_classes: int = 80,
                 fpn_channels: int = 256, frozen_backbone_stats: bool = True):
        super().__init__()
        self.extractor = DetectionBackbone(backbone_cfg, fpn_channels,
                                           frozen_backbone_stats=frozen_backbone_stats)
        self.head = RetinaHead(num_classes, channels=fpn_channels)

    def forward(self, x: torch.Tensor):
        return self.head(self.extractor(x))


@torch.no_grad()
def init_task_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisation of a task model, drawn from ``generator``: He
    normal convs and zero biases (``models/recnext.py:init_weights``), BN at identity,
    a RetinaHead's prediction layers Normal(0.01) with the focal prior's bias, and Mask
    R-CNN's as mmdet's: the RPN's and the mask logits Normal(0.01), the box head's
    fc1 and fc2 LeCun normal (flax's Dense), its classifier Normal(0.01) and its
    deltas Normal(0.001)."""
    from recnext_tpu_torch.tasks.mask_rcnn import BoxHead, MaskHead, RPNHead

    init_weights(model, generator)
    for m in model.modules():
        if isinstance(m, RetinaHead):
            for conv in (m.retina_cls, m.retina_reg):
                conv.weight.normal_(0.0, 0.01, generator=generator)
            m.retina_cls.bias.fill_(FOCAL_PRIOR_BIAS)
        elif isinstance(m, (RPNHead, MaskHead)):
            for layer in (m.cls, m.reg) if isinstance(m, RPNHead) else (m.logits,):
                layer.weight.normal_(0.0, 0.01, generator=generator)
        elif isinstance(m, BoxHead):
            for fc in (m.fc1, m.fc2):
                std = math.sqrt(1.0 / fc.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(fc.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            m.cls.weight.normal_(0.0, 0.01, generator=generator)
            m.reg.weight.normal_(0.0, 0.001, generator=generator)
    return model


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss in fp32 over (A, C) logits, ``targets`` one-hot (zeros for
    background), anchors outside ``valid`` ignored; normalised by the positives."""
    logits = logits.float()
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits) + (1 - targets) * F.logsigmoid(-logits))
    pt = targets * p + (1 - targets) * (1 - p)
    a = targets * alpha + (1 - targets) * (1 - alpha)
    loss = a * (1 - pt) ** gamma * ce
    loss = torch.where(valid[..., None], loss, torch.zeros_like(loss))
    return loss.sum() / targets.sum().clamp_min(1.0)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              beta: float = 1.0 / 9.0) -> torch.Tensor:
    d = (pred.float() - target).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    loss = torch.where(mask[..., None], loss, torch.zeros_like(loss))
    return loss.sum() / mask.sum().clamp_min(1.0)


def _image_loss(scores, preds, anchors, gt_boxes, labels, pos, valid, idx, num_classes):
    targets = F.one_hot(labels.clamp_min(0), num_classes).float() * (labels >= 0)[:, None]
    deltas = encode_boxes(anchors, gt_boxes[idx])
    deltas = torch.where(pos[:, None], deltas, torch.zeros_like(deltas))
    return focal_loss(scores, targets, valid) + smooth_l1(preds, deltas, pos)


def detection_loss(cls_scores: torch.Tensor, bbox_preds: torch.Tensor, anchors: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """The mean over the images of focal loss plus smooth-L1 after each image's MaxIoU
    assignment. Each image's loss is recomputed in the backward
    (``torch.utils.checkpoint``): its fp32 intermediates over every anchor and class
    (2.5 GB a tensor for a batch of 16 at 800^2) are not kept for it."""
    losses = []
    for b in range(cls_scores.shape[0]):
        with torch.no_grad():
            idx, labels, pos, valid = assign_anchors(anchors, gt_boxes[b], gt_labels[b])
        losses.append(checkpoint(_image_loss, cls_scores[b], bbox_preds[b], anchors,
                                 gt_boxes[b], labels, pos, valid, idx, num_classes,
                                 use_reentrant=False))
    return torch.stack(losses).mean()


def make_detection_train_step(anchors: torch.Tensor, num_classes: int,
                              dtype: torch.dtype = torch.float32):
    """``train_step(state, batch) -> {"loss"}`` for a RetinaNet train state
    (``train/state.py``, no EMA): forward in ``dtype`` (``train/step.py:forward_model``),
    ``detection_loss``, backward, the state's optimizer. batch = {"image" (N, 3, H, W),
    "gt_boxes" (N, G, 4) and "gt_labels" (N, G), padded with -1}, on the model's
    device."""
    from recnext_tpu_torch.train.step import forward_model

    def train_step(state, batch):
        state.model.train()
        state.optimizer.zero_grad()
        cls_scores, bbox_preds = forward_model(state.model, batch["image"], dtype)
        loss = detection_loss(cls_scores, bbox_preds, anchors, batch["gt_boxes"],
                              batch["gt_labels"], num_classes)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    return train_step


def retinanet_postprocess(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                          anchors: torch.Tensor, *, score_thresh: float = 0.05,
                          iou_thresh: float = 0.5, max_det: int = 100, nms_pre: int = 1000,
                          level_sizes: Optional[Sequence[int]] = None):
    """One image's decode: sigmoid scores, the top ``nms_pre`` anchors by their best
    class score in each level (``level_sizes``: anchors per level; mmdet's per-level
    prefilter), then multiclass NMS. Returns (boxes (max_det, 4), scores, labels,
    valid)."""
    probs = torch.sigmoid(cls_scores.float())
    best = probs.max(dim=-1).values
    boxes = decode_boxes(anchors, bbox_preds.float())
    level_sizes = list(level_sizes or [best.shape[0]])
    if sum(level_sizes) != best.shape[0]:
        raise ValueError(f"level_sizes {level_sizes} != {best.shape[0]} anchors")
    parts, start = [], 0
    for n in level_sizes:
        order = torch.sort(best[start:start + n], descending=True, stable=True).indices
        parts.append(order[:min(nms_pre, n)] + start)
        start += n
    top = torch.cat(parts)
    return multiclass_nms(boxes[top], probs[top], score_thresh=score_thresh,
                          iou_thresh=iou_thresh, max_out=max_det)


def generate_anchors(feat_shapes: Sequence[Tuple[int, int]],
                     strides: Sequence[int] = (8, 16, 32, 64, 128),
                     scales=(1.0, 2 ** (1 / 3), 2 ** (2 / 3)),
                     ratios=(0.5, 1.0, 2.0), base_size: int = 4,
                     center_offset: float = 0.5) -> np.ndarray:
    """(sum_l H_l W_l A, 4) xyxy anchors, RetinaNet's convention: octave base 4x the
    stride, ratio = h / w, w = base * scale / sqrt(r), h = base * scale * sqrt(r) (mmdet's
    AnchorGenerator); centers at (x + center_offset) * stride (mmdet uses 0.0, the JAX
    package 0.5)."""
    all_anchors = []
    for (h, w), stride in zip(feat_shapes, strides):
        base = base_size * stride
        ws, hs = [], []
        for r in ratios:
            for s in scales:
                ws.append(base * s * np.sqrt(1.0 / r))
                hs.append(base * s * np.sqrt(r))
        ws, hs = np.asarray(ws), np.asarray(hs)
        cx = (np.arange(w) + center_offset) * stride
        cy = (np.arange(h) + center_offset) * stride
        cy, cx = np.meshgrid(cy, cx, indexing="ij")
        centers = np.stack([cx, cy], axis=-1).reshape(-1, 1, 2)
        sizes = np.stack([ws, hs], axis=-1).reshape(1, -1, 2)
        boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=-1)
        all_anchors.append(boxes.reshape(-1, 4))
    return np.concatenate(all_anchors).astype(np.float32)
