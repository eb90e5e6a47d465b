"""Mixup / CutMix with label smoothing (timm Mixup, batch mode), NCHW.

Counterpart of ``recnext_tpu/data/mixup.py:mixup_cutmix``, split in two: the
random draws (``draw_mixup``: the cutmix switch, the two Beta draws and the box
centre, from an explicit ``torch.Generator`` on the host) and their application
(``apply_mixup``, on the batch's device). Sample i is paired with sample B-1-i
(the batch flipped), the cut box lies on the H and W axes, and lambda is corrected
by the area of the box actually cut. The box and lambda follow the JAX package's
float32 arithmetic, so the same draws give the same batch and targets.

Across processes the pairing is the global batch's, as JAX flips the batch it
shards: each rank's partners are the rows of rank W-1-r reversed
(``parallel/sharding.py:partner_rows``), and every rank makes the same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from recnext_tpu_torch.parallel.sharding import partner_rows


class MixupDraw(NamedTuple):
    use_cutmix: bool
    lam_mix: float  # Beta(mixup_alpha, mixup_alpha)
    lam_cut: float  # Beta(cutmix_alpha, cutmix_alpha)
    center: Tuple[int, int]  # (row, col) of the cut box, uniform over the image


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.1) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _beta(generator: torch.Generator, alpha: float) -> float:
    g = torch._standard_gamma(torch.full((2,), float(alpha), dtype=torch.float64),
                              generator=generator)
    return float(np.float32(g[0] / (g[0] + g[1])))


def draw_mixup(generator: torch.Generator, h: int, w: int, *, mixup_alpha: float = 0.8,
               cutmix_alpha: float = 1.0, switch_prob: float = 0.5) -> MixupDraw:
    """The draws of one batch, from ``generator`` (a CPU generator)."""
    use_cutmix = bool(torch.rand((), generator=generator, dtype=torch.float64) < switch_prob)
    lam_mix = _beta(generator, mixup_alpha)
    lam_cut = _beta(generator, cutmix_alpha)
    ry = int(torch.randint(0, h, (), generator=generator))
    rx = int(torch.randint(0, w, (), generator=generator))
    return MixupDraw(use_cutmix, lam_mix, lam_cut, (ry, rx))


def cut_box(h: int, w: int, lam: float, center: Tuple[int, int]):
    """timm rand_bbox: cut ratio sqrt(1-lam) (float32), box clipped to the image:
    (y1, y2, x1, x2)."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
    ry, rx = center
    return (min(max(ry - cut_h // 2, 0), h), min(max(ry + cut_h // 2, 0), h),
            min(max(rx - cut_w // 2, 0), w), min(max(rx + cut_w // 2, 0), w))


def apply_mixup(x: torch.Tensor, labels: torch.Tensor, draw: MixupDraw, *, num_classes: int,
                smoothing: float = 0.1):
    """x: NCHW batch (this rank's rows of the global batch); labels: integer. Returns
    the mixed batch (x's dtype) and the soft targets (float32)."""
    h, w = int(x.shape[2]), int(x.shape[3])
    x_flip = partner_rows(x)
    if draw.use_cutmix:
        y1, y2, x1, x2 = cut_box(h, w, draw.lam_cut, draw.center)
        out = x.clone()
        out[:, :, y1:y2, x1:x2] = x_flip[:, :, y1:y2, x1:x2]
        lam = np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1)) / np.float32(h * w)
    else:
        lam = np.float32(draw.lam_mix)
        out = x * float(lam) + x_flip * float(np.float32(1.0) - lam)
    t = one_hot_smooth(labels, num_classes, smoothing)
    targets = t * float(lam) + partner_rows(t) * float(np.float32(1.0) - lam)
    return out.to(x.dtype), targets


def mixup_cutmix(generator: torch.Generator, x: torch.Tensor, labels: torch.Tensor, *,
                 num_classes: int, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 switch_prob: float = 0.5, smoothing: float = 0.1):
    """Draw and apply in one call: the train step's entry."""
    draw = draw_mixup(generator, int(x.shape[2]), int(x.shape[3]), mixup_alpha=mixup_alpha,
                      cutmix_alpha=cutmix_alpha, switch_prob=switch_prob)
    return apply_mixup(x, labels, draw, num_classes=num_classes, smoothing=smoothing)
