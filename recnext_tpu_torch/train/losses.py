"""Losses: soft-target cross-entropy (mixup), label smoothing, BCE, JSD and the DeiT
distillation blend.

Counterpart of ``recnext_tpu/train/losses.py``, function by function. Every loss
takes logits of any float dtype and computes in fp32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """targets are probability rows (mixup/cutmix output). Mean over the batch."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(targets * logp).sum(dim=-1).mean()


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return label_smoothing_cross_entropy(logits, labels, smoothing=0.0)


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         target_thresh: float = 0.0) -> torch.Tensor:
    """Sigmoid BCE against soft targets (timm BinaryCrossEntropy), with optional
    target thresholding."""
    t = targets.float()
    if target_thresh > 0:
        t = (t >= target_thresh).float()
    logits = logits.float()
    per = logits.clamp_min(0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    return (per.sum(dim=-1) / logits.shape[-1]).mean()


def jsd_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, num_splits: int = 3,
                      alpha: float = 12.0, smoothing: float = 0.1) -> torch.Tensor:
    """timm JsdCrossEntropy: the batch holds ``num_splits`` blocks (block 0 the clean
    view, the rest augmented views of the same samples). Smoothed CE on the clean
    block + alpha * the Jensen-Shannon divergence of the blocks' softmaxes."""
    n = logits.shape[0] // num_splits
    parts = [logits[i * n:(i + 1) * n].float() for i in range(num_splits)]
    loss = label_smoothing_cross_entropy(parts[0], labels[:n], smoothing=smoothing)
    probs = [F.softmax(p, dim=-1) for p in parts]
    logm = torch.log((sum(probs) / num_splits).clamp(1e-7, 1.0))
    kl = sum((p * (torch.log(p.clamp(1e-7, 1.0)) - logm)).sum() / n
             for p in probs) / num_splits
    return loss + alpha * kl


def distillation_loss(outputs, targets: torch.Tensor,
                      teacher_logits: Optional[torch.Tensor] = None, *,
                      base_criterion: Callable = soft_target_cross_entropy,
                      kind: str = "none", alpha: float = 0.5,
                      tau: float = 1.0) -> torch.Tensor:
    """DeiT distillation blend. ``outputs`` is the model output: logits, or a
    (logits, logits_dist) tuple from a model built with distillation=True."""
    outputs_kd = None
    if isinstance(outputs, (tuple, list)):
        outputs, outputs_kd = outputs
    base = base_criterion(outputs, targets)
    if kind == "none":
        return base
    if outputs_kd is None:
        raise ValueError("distillation requires the dual-head (logits, logits_dist) output")
    if teacher_logits is None:
        raise ValueError("distillation requires teacher logits")
    if kind == "soft":
        logp_s = F.log_softmax(outputs_kd.float() / tau, dim=-1)
        logp_t = F.log_softmax(teacher_logits.float() / tau, dim=-1)
        # KL with log targets, summed, scaled tau^2 / numel (torch reduction='sum')
        kl = (torch.exp(logp_t) * (logp_t - logp_s)).sum()
        dist = kl * (tau * tau) / outputs_kd.numel()
    elif kind == "hard":
        dist = cross_entropy(outputs_kd, teacher_logits.argmax(dim=-1))
    else:
        raise ValueError(f"unknown distillation kind {kind!r}")
    return base * (1.0 - alpha) + dist * alpha
