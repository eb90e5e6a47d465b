"""Semantic FPN segmentation, NCHW: the port's counterpart of
``recnext_tpu/tasks/segmentation.py`` (the reference's ADE20K recipe: mmseg's
EncoderDecoder with an FPN neck and an FPNHead decode head, as one model).

* backbone: a registry RecNext, in the frozen-BN mode by default;
* neck: ``FPN`` (256 channels, 4 levels);
* head: ``FPNHead``: per level a scale head (3x3 conv, BN, ReLU, and a bilinear x2
  per octave above stride 4), summed, dropout, a 1x1 classifier; the logits are
  resized to the input;
* ``segmentation_loss``: per-pixel cross-entropy, ignore label 255; ``miou``: the
  (intersection, union) counts per class;
* ``seg_train_sample``/``seg_eval_sample``: the JAX package's samples on the same
  ``np.random.Generator`` draws (the same pixels), channels first;
* ``align_resize``: the eval-time AlignResize, both sides rounded up to /32 by resizing
  (RecConv's pyramid needs sizes that halve evenly).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from recnext_tpu_torch.models.layers import batch_norm2d
from recnext_tpu_torch.models.recnext import RecNext, RecNextConfig
from recnext_tpu_torch.ops.resize import resize
from recnext_tpu_torch.tasks.fpn import FPN

IGNORE = 255


class ScaleHeadStep(nn.Module):
    """3x3 conv (no bias), BN, ReLU, then a bilinear x2 where ``up``."""

    def __init__(self, cin: int, cout: int, up: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = batch_norm2d(cout)
        self.up = up

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        if self.up:
            x = resize(x, (x.shape[2] * 2, x.shape[3] * 2), mode="bilinear")
        return x


class FPNHead(nn.Module):
    """mmseg's FPNHead: each level's scale head brings it to stride 4; the sum goes
    through dropout (one keep-or-drop draw per image and channel, from ``generator``,
    None: torch's default generator of the device) and the 1x1 classifier."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 128,
                 feature_strides: Tuple[int, ...] = (4, 8, 16, 32), dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.generator = generator
        heads = []
        for stride in feature_strides:
            reps = max(1, int(np.log2(stride) - np.log2(feature_strides[0])))
            up = stride != feature_strides[0]
            heads.append(nn.Sequential(*(ScaleHeadStep(in_channels if r == 0 else channels,
                                                       channels, up) for r in range(reps))))
        self.scale_heads = nn.ModuleList(heads)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        target = feats[0].shape[2:]
        x = sum(resize(head(f), target, mode="bilinear")
                for head, f in zip(self.scale_heads, feats))
        if self.dropout > 0 and self.training:
            keep = 1.0 - self.dropout
            mask = dropout_mask((x.shape[0], x.shape[1], 1, 1), keep, x.device, self.generator)
            x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        return self.conv_seg(x)


def dropout_mask(shape, keep: float, device, generator: Optional[torch.Generator]):
    """A boolean mask of ``shape``, each element True with probability ``keep``."""
    return torch.empty(shape, device=device).bernoulli_(keep, generator=generator).bool()


class SemanticFPN(nn.Module):
    """backbone features -> FPN -> FPNHead -> logits (N, classes, H, W) at the input's
    size."""

    def __init__(self, backbone_cfg: RecNextConfig, num_classes: int = 150,
                 fpn_channels: int = 256, frozen_backbone_stats: bool = True):
        super().__init__()
        self.backbone = RecNext(backbone_cfg, frozen_stats=frozen_backbone_stats)
        self.neck = FPN(backbone_cfg.embed_dim, fpn_channels, num_outs=4)
        self.decode_head = FPNHead(fpn_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.decode_head(self.neck(self.backbone.features(x)))
        return resize(logits, x.shape[2:], mode="bilinear")


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int = IGNORE) -> torch.Tensor:
    """Per-pixel cross-entropy in fp32 over the labels that are not ``ignore_index``
    (mmseg's CrossEntropyLoss), logits (N, K, H, W), labels (N, H, W)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)


def miou(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
         ignore_index: int = IGNORE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's (intersection, union) pixel counts per class, over the pixels whose
    label is not ``ignore_index``; the prediction is the first maximal logit."""
    pred = logits.argmax(dim=1)
    valid = labels != ignore_index
    p, t = pred[valid], labels[valid].long()
    inter = torch.bincount(t[p == t], minlength=num_classes)
    union = (torch.bincount(p, minlength=num_classes) + torch.bincount(t, minlength=num_classes)
             - inter)
    return inter, union


def _scaled(img, seg: np.ndarray, nw: int, nh: int):
    from PIL import Image

    from recnext_tpu_torch.data.transforms import normalize

    img = img.resize((nw, nh), Image.BILINEAR)
    seg_img = Image.fromarray(seg.astype(np.int32), mode="I").resize((nw, nh), Image.NEAREST)
    return normalize(img).astype(np.float32), np.asarray(seg_img, dtype=np.int32)


def _pad(arr: np.ndarray, seg: np.ndarray, crop: int, ignore_index: int):
    """Pad (H, W, 3) and (H, W) at the bottom and right to at least ``crop``: zeros and
    ``ignore_index``."""
    ph, pw = max(crop - arr.shape[0], 0), max(crop - arr.shape[1], 0)
    if ph or pw:
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)))
        seg = np.pad(seg, ((0, ph), (0, pw)), constant_values=ignore_index)
    return arr, seg


def seg_train_sample(rng: np.random.Generator, img, seg: np.ndarray, crop: int,
                     scale_range=(0.5, 2.0), ignore_index: int = IGNORE):
    """mmseg's train sample: a random scale, a random crop (padded with zeros and the
    ignore label), a random flip, ImageNet normalisation. img: PIL; seg: (H, W)
    labels. Returns (3, crop, crop) float32 and (crop, crop) int32."""
    w, h = img.size
    f = rng.uniform(*scale_range)
    arr, seg = _scaled(img, seg, max(1, int(w * f)), max(1, int(h * f)))
    arr, seg = _pad(arr, seg, crop, ignore_index)
    y = int(rng.integers(0, arr.shape[0] - crop + 1))
    x = int(rng.integers(0, arr.shape[1] - crop + 1))
    arr, seg = arr[y:y + crop, x:x + crop], seg[y:y + crop, x:x + crop]
    if rng.random() < 0.5:
        arr, seg = arr[:, ::-1], seg[:, ::-1]
    return np.ascontiguousarray(arr.transpose(2, 0, 1)), np.ascontiguousarray(seg)


def seg_eval_sample(img, seg: np.ndarray, crop: int, ignore_index: int = IGNORE):
    """The deterministic eval sample at (crop, crop): the short side scaled to
    ``crop`` (aspect kept), a center crop, padding with the ignore label (the JAX
    package's fixed-shape stand-in for mmseg's whole-image eval). Returns
    (3, crop, crop) float32 and (crop, crop) int32."""
    w, h = img.size
    f = crop / min(w, h)
    arr, seg = _scaled(img, seg, max(1, int(round(w * f))), max(1, int(round(h * f))))
    arr, seg = _pad(arr, seg, crop, ignore_index)
    y, x = (arr.shape[0] - crop) // 2, (arr.shape[1] - crop) // 2
    return (np.ascontiguousarray(arr[y:y + crop, x:x + crop].transpose(2, 0, 1)),
            np.ascontiguousarray(seg[y:y + crop, x:x + crop]))


def align_resize(img: np.ndarray, seg: Optional[np.ndarray] = None,
                 scale: Tuple[int, int] = (2048, 512), size_divisor: int = 32):
    """Eval-time AlignResize on a decoded (H, W, 3) image: a keep-ratio resize to
    ``scale``, then both sides rounded up to a multiple of ``size_divisor`` by
    resizing (not padding); the image bilinear, the seg map nearest. Returns the
    (H', W', 3) float32 image and the (H', W') map (or None)."""
    h, w = img.shape[:2]
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    nh, nw = int(h * f + 0.5), int(w * f + 0.5)
    ah = math.ceil(nh / size_divisor) * size_divisor
    aw = math.ceil(nw / size_divisor) * size_divisor
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    out_img = resize(x, (ah, aw), mode="bilinear")[0].permute(1, 2, 0).numpy()
    out_seg = None
    if seg is not None:
        s = torch.from_numpy(np.ascontiguousarray(seg))[None, None]
        out_seg = resize(s, (ah, aw), mode="nearest")[0, 0].numpy()
    return out_img, out_seg
