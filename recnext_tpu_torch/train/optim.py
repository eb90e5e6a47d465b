"""Optimizer and learning-rate schedule of the reference recipe.

Counterpart of ``recnext_tpu/train/optim.py``: AdamW (lr 1e-3 x batch/512, weight
decay 0.025 on >=2-D parameters only), the cosine schedule as the reference runs it,
and adaptive gradient clipping (AGC, 0.02) before the update, or the MLLA recipe's
global-norm clipping (``clip_mode="norm"``, 5.0).

``Optimizer`` is optax's ``chain(clip, multi_transform(adamw(wd), adamw(0)))`` on
torch parameters, ``clip`` ``adaptive_grad_clip`` or ``clip_by_global_norm``:

* AGC takes unit-wise norms as optax does on the JAX layouts. A vector or scalar
  (and any tensor that squeezes to one) is one unit; an optax (in, out) Dense kernel
  or HWIO conv kernel has one unit per output, which in the port's (out, in) and
  OIHW layouts is a slice along the first axis, so the norm reduces over every axis
  but the first. A unit is rescaled to ``clipping * max(|p|, 1e-3)`` when its
  gradient norm is not below that.
* the global-norm clip is optax's: where the gradients' global norm n is not below
  the maximum, every gradient becomes (g / n) * max (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``); the norms are foreach reductions;
* ``torch.optim.AdamW`` is optax's ``adamw`` with the same placement of epsilon and
  decay: epsilon is added to sqrt of the bias-corrected second moment (optax
  ``eps_root`` 0), and the decay ``lr * wd * p`` uses the parameters before the
  update and the scheduled lr, as ``add_decayed_weights`` before
  ``scale_by_learning_rate``. The schedule is read at the update count, 0 first.
* ``grad_accum`` k > 1 is ``optax.MultiSteps``: each ``step()`` folds the
  parameters' gradients into their running mean (``acc + (g - acc) / (i + 1)``, as
  optax does), and every k-th applies the clip and AdamW to that mean; the update count,
  and so the schedule, advances once per k micro-steps.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import numpy as np
import torch



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
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place on the parameters' ``.grad``: where the
    global norm n >= ``max_norm``, g <- (g / n) * max_norm; else unchanged. Foreach
    ops throughout, and no host synchronisation (the branch is a select of the
    divisor and the factor, 1 where the gradients stay)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))


@torch.no_grad()
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


CLIP_MODES = ("agc", "norm")


class Optimizer:
    """AGC (``clip_mode="agc"``) or the global-norm clip (``"norm"``) at ``agc_clip``
    (none where it is 0), then AdamW with decay on >=2-D parameters only, the lr read
    from ``schedule`` at the update count. ``step()`` uses and clips the parameters'
    ``.grad`` in place."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable[[int], float], weight_decay: float = 0.025,
                 agc_clip: float = 0.02, betas: Tuple[float, float] = (0.9, 0.999),
                 grad_accum: int = 1, clip_mode: str = "agc"):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if clip_mode not in CLIP_MODES:
            raise ValueError(f"unknown clip_mode {clip_mode!r}; one of {CLIP_MODES}")
        self.clip_mode = clip_mode
        named = [(n, p) for n, p in named_params if p.requires_grad]
        labels = param_labels(named)
        self.params = [p for _, p in named]
        self.schedule = schedule
        self.agc_clip = agc_clip
        self.count = 0  # updates applied
        self.grad_accum = grad_accum
        self.mini_step = 0  # micro-steps folded into ``acc`` since the last update
        self.acc = None  # the running mean of the micro-gradients (grad_accum > 1)
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

    @torch.no_grad()
    def _accumulate(self) -> bool:
        """Fold the micro-step's gradients into ``acc``; on the k-th, put the mean in
        ``.grad`` and return True."""
        if self.acc is None:
            self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        i = self.mini_step
        for a, p in zip(self.acc, self.params):
            if p.grad is not None:
                a.add_((p.grad.float() - a) / (i + 1))
            else:  # a zero gradient
                a.sub_(a / (i + 1))
        self.mini_step = (i + 1) % self.grad_accum
        if self.mini_step:
            return False
        for a, p in zip(self.acc, self.params):
            p.grad = a.to(p.dtype).clone()
            a.zero_()
        return True

    def step(self) -> bool:
        """One micro-step: returns whether the parameters were updated (always, at
        ``grad_accum`` 1)."""
        if self.grad_accum > 1 and not self._accumulate():
            return False
        if self.agc_clip and self.agc_clip > 0:
            if self.clip_mode == "agc":
                adaptive_grad_clip_(self.params, self.agc_clip)
            else:
                clip_by_global_norm_(self.params, self.agc_clip)
        lr = self.lr()
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


def make_optimizer(named_params, learning_rate: Callable[[int], float],
                   weight_decay: float = 0.025, agc_clip: float = 0.02,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   grad_accum: int = 1, clip_mode: str = "agc") -> Optimizer:
    """The clip -> AdamW (decay on >=2-D parameters only), applied to the mean of
    every ``grad_accum`` micro-steps' gradients (optax.MultiSteps in the JAX package).
    ``clip_mode`` "agc" is the RecNeXt recipe (AGC at ``agc_clip``, 0.02), "norm" the
    MLLA recipe's global-norm clip (``agc_clip`` the maximum norm, 5.0).
    ``learning_rate`` is read at the update count: under accumulation the caller maps
    it back to micro-steps (``sched(u * grad_accum)``), as the JAX CLI does."""
    return Optimizer(named_params, learning_rate, weight_decay, agc_clip, betas, grad_accum,
                     clip_mode)
