"""Optimizer and learning-rate schedule of the reference recipe.

Counterpart of ``recnext_tpu/train/optim.py``: AdamW (lr 1e-3 x batch/512, weight
decay 0.025 on >=2-D parameters only), the cosine schedule as the reference runs it,
and adaptive gradient clipping (AGC, 0.02) before the update.

``Optimizer`` is optax's ``chain(adaptive_grad_clip, multi_transform(adamw(wd),
adamw(0)))`` on torch parameters:

* AGC takes unit-wise norms as optax does on the JAX layouts. A vector or scalar
  (and any tensor that squeezes to one) is one unit; an optax (in, out) Dense kernel
  or HWIO conv kernel has one unit per output, which in the port's (out, in) and
  OIHW layouts is a slice along the first axis, so the norm reduces over every axis
  but the first. A unit is rescaled to ``clipping * max(|p|, 1e-3)`` when its
  gradient norm is not below that.
* ``torch.optim.AdamW`` is optax's ``adamw`` with the same placement of epsilon and
  decay: epsilon is added to sqrt of the bias-corrected second moment (optax
  ``eps_root`` 0), and the decay ``lr * wd * p`` uses the parameters before the
  update and the scheduled lr, as ``add_decayed_weights`` before
  ``scale_by_learning_rate``. The schedule is read at the update count, 0 first.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

TRAIN_ITEM = "ROADMAP.md Queue 1 item 6 (training: grad_accum, MESA, JSD, remat)"


def scaled_lr(base_lr: float, global_batch: int) -> float:
    """Linear lr scaling: lr * total_batch / 512."""
    return base_lr * global_batch / 512.0


def cosine_schedule(base_lr: float, steps_per_epoch: int, epochs: int = 300,
                    warmup_epochs: int = 5, cooldown_epochs: int = 0,
                    warmup_lr: float = 1e-6, min_lr: float = 1e-5) -> Callable[[int], float]:
    """timm's CosineLRScheduler as the reference runs it: the cosine spans all
    ``epochs``, and the lr used in epoch e is the schedule at t = max(e - 1, 0) (the
    reference steps the scheduler with the epoch just finished). Piecewise constant
    over epochs; past ``epochs`` it stays at ``min_lr`` (the caller runs the
    ``cooldown_epochs``, which do not change the function). Computed in float32, as
    the JAX package computes it."""
    del cooldown_epochs
    f32 = np.float32

    def sched(step: int) -> float:
        t = max(int(step) // steps_per_epoch - 1, 0)
        if t < warmup_epochs:
            return float(f32(warmup_lr) + f32(base_lr - warmup_lr)
                         * (f32(t) / f32(max(warmup_epochs, 1))))
        if t < epochs:
            cos = np.cos(f32(math.pi) * f32(t) / f32(max(epochs, 1)), dtype=f32)
            return float(f32(min_lr) + f32(0.5 * (base_lr - min_lr)) * (f32(1.0) + cos))
        return float(f32(min_lr))

    return sched


def param_labels(named_params: Iterable[Tuple[str, torch.Tensor]]) -> dict:
    """'decay' for >=2-D kernels, 'no_decay' for 1-D parameters (biases, norm
    scales): timm's no-weight-decay rule."""
    return {n: "decay" if p.ndim >= 2 else "no_decay" for n, p in named_params}


def unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """optax's unit-wise L2 norm on the port's layouts, broadcast to x's shape."""
    if x.squeeze().dim() <= 1:
        n = x.float().square().sum()
    else:
        n = x.float().square().sum(dim=tuple(range(1, x.dim())), keepdim=True)
    return n.sqrt().expand(x.shape)


@torch.no_grad()
def adaptive_grad_clip_(params: Iterable[torch.Tensor], clipping: float,
                        eps: float = 1e-3) -> None:
    """optax.adaptive_grad_clip, in place on each parameter's ``.grad``."""
    for p in params:
        if p.grad is None:
            continue
        g_norm = unitwise_norm(p.grad)
        max_norm = clipping * unitwise_norm(p).clamp_min(eps)
        clipped = p.grad * (max_norm / g_norm.clamp_min(1e-6))
        p.grad.copy_(torch.where(g_norm < max_norm, p.grad, clipped))


@torch.no_grad()
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class Optimizer:
    """AGC, then AdamW with decay on >=2-D parameters only, the lr read from
    ``schedule`` at the update count. ``step()`` uses and clips the parameters'
    ``.grad`` in place."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable[[int], float], weight_decay: float = 0.025,
                 agc_clip: float = 0.02, betas: Tuple[float, float] = (0.9, 0.999)):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        labels = param_labels(named)
        self.params = [p for _, p in named]
        self.schedule = schedule
        self.agc_clip = agc_clip
        self.count = 0
        groups = [{"params": [p for n, p in named if labels[n] == "decay"],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in named if labels[n] == "no_decay"],
                   "weight_decay": 0.0}]
        self.adamw = torch.optim.AdamW(groups, lr=schedule(0), betas=betas, eps=1e-8)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def lr(self) -> float:
        """The lr of the next update."""
        return self.schedule(self.count)

    def step(self) -> None:
        if self.agc_clip and self.agc_clip > 0:
            adaptive_grad_clip_(self.params, self.agc_clip)
        lr = self.lr()
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(named_params, learning_rate: Callable[[int], float],
                   weight_decay: float = 0.025, agc_clip: float = 0.02,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   grad_accum: int = 1) -> Optimizer:
    """AGC -> AdamW (decay on >=2-D parameters only), the RecNeXt recipe. The JAX
    package's global-norm clip (the MLLA recipe) comes with the MLLA family;
    ``grad_accum`` > 1 (optax.MultiSteps there) is not ported yet and raises."""
    if grad_accum > 1:
        raise NotImplementedError(f"gradient accumulation (grad_accum={grad_accum}) is not "
                                  f"ported yet; see {TRAIN_ITEM}")
    return Optimizer(named_params, learning_rate, weight_decay, agc_clip, betas)
