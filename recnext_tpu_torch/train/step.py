"""The train step and the eval steps.

Counterpart of ``recnext_tpu/train/step.py``. One train step is mixup/cutmix ->
forward -> loss (fp32) -> backward -> AGC + AdamW -> EMA, and returns
``{"loss", "grad_norm"}`` (the gradient's global norm before clipping). The state
(``train/state.py``) is updated in place.

Precision is the JAX model's at ``dtype=bf16``: the parameters stay fp32, and the
forward runs on the activations and the conv and linear weights (and their
biases) cast to ``dtype`` (``compute_params``, through
``torch.func.functional_call``), so the gradient flows back through each cast to
the fp32 parameter. This is the one place that casts weights: the modules use
theirs as given. BatchNorm computes its statistics and normalisation in fp32
(``models/layers.py``). The RecConv2d mixers run the forward kernel and the
backward kernel on a CUDA tensor (``ops/recconv.py:RecConv2dFunction``), the
linear-attention mixers theirs (``ops/attention.py:LinearAttentionFunction``).

Distillation (DeiT's, as the reference recipe trains every headline model): a
teacher (``make_teacher_apply``: the RegNetY of ``models/regnet.py`` or a registry
model) scores the mixed batch in eval mode, without gradient, in the compute dtype,
and the dual-head student's second head learns its hard labels or its softened
distribution (``train/losses.py:distillation_loss``).

The JAX step's other options: ``grad_accum`` (the optimizer's mean of k micro-
steps, ``train/optim.py``; the EMA moves only on the steps that update), ``remat``
(each block's forward recomputed in the backward by ``torch.utils.checkpoint``,
``RecNext.forward(x, remat=True)``), MESA (self-distillation from the EMA model's
eval-mode softmax from ``mesa_start_step`` on) and the JSD loss on a batch of
``jsd_splits`` given views.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from recnext_tpu_torch.data.mixup import mixup_cutmix
from recnext_tpu_torch.fusion import fuse_params
from recnext_tpu_torch.models.recnext import RecNext, RecNextConfig
from recnext_tpu_torch.train import losses as L
from recnext_tpu_torch.train.optim import global_norm
from recnext_tpu_torch.train.state import TrainState, ema_update

PACKED_ITEM = "ROADMAP.md Queue 1 item 12 (models/packed_infer.py)"


def compute_params(model: nn.Module, dtype: torch.dtype,
                   source: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The conv and linear parameters (weights and biases) cast to ``dtype``, by
    name, from ``source`` where it has them (an EMA copy), else from the model. The
    BatchNorm parameters and those of a layer flagged ``fp32`` (RegNetY's classifier)
    are left out: they stay fp32."""
    source = source or {}
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)) and not getattr(mod, "fp32", False):
            for leaf, p in mod.named_parameters(recurse=False):
                name = f"{prefix}.{leaf}" if prefix else leaf
                out[name] = source.get(name, p).to(dtype)
    return out


def forward_model(model: nn.Module, x: torch.Tensor, dtype: torch.dtype,
                  source: Optional[Dict[str, torch.Tensor]] = None, remat: bool = False,
                  **kwargs):
    """The model's output on x in the compute ``dtype`` (parameters kept in fp32),
    with the tensors of ``source`` (an EMA copy) in place of the model's; ``remat``
    is the RecNext forward's (each block recomputed in the backward); ``kwargs`` go
    to the model's forward as they are (Mask R-CNN's ground truth)."""
    tensors = dict(source or {})
    tensors.update(compute_params(model, dtype, source))
    return functional_call(model, tensors, (x.to(dtype),),
                           {"remat": True, **kwargs} if remat else kwargs, strict=False)


def create_teacher(name: str, *, num_classes: int, device=None) -> nn.Module:
    """The teacher ``name``: a RegNetY of ``models/regnet.py`` (``regnet*``) or a
    registry model, with weights from a generator of seed 1 (the JAX CLI's teacher
    without a checkpoint is ``init(PRNGKey(1))``), on ``device``, in eval mode."""
    from recnext_tpu_torch.models.regnet import create_regnet
    from recnext_tpu_torch.models.registry import create_model

    make = create_regnet if name.startswith("regnet") else create_model
    return make(name, num_classes=num_classes, device=device,
                generator=torch.Generator().manual_seed(1))


def make_teacher_apply(teacher: nn.Module, dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``teacher_apply(x) -> logits`` for the train step: ``teacher`` in eval mode,
    without gradient, on x in ``dtype``, its conv and linear weights cast to ``dtype``
    once (the teacher never changes) but for RegNetY's fp32 classifier, its BatchNorm
    in fp32 on running statistics."""
    teacher.eval()
    params = compute_params(teacher, dtype)

    def teacher_apply(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return functional_call(teacher, params, (x.to(dtype),), strict=False)

    return teacher_apply


def train_loss(model: nn.Module, x: torch.Tensor, targets: torch.Tensor, *,
               dtype: torch.dtype = torch.bfloat16, smoothing: float = 0.1,
               teacher_logits: Optional[torch.Tensor] = None, distillation: str = "none",
               alpha: float = 0.5, tau: float = 1.0, remat: bool = False,
               jsd_splits: int = 0, jsd_alpha: float = 12.0,
               mesa_targets: Optional[torch.Tensor] = None,
               mesa: float = 0.0) -> torch.Tensor:
    """Forward in ``dtype`` (each block rematerialised in the backward where
    ``remat``) and the fp32 loss: the JSD loss over ``jsd_splits`` views where it is
    > 1; else soft-target CE on mixup targets, label-smoothing CE on integer labels,
    blended with the distillation loss on the dual-head model's second head where
    ``distillation`` is "hard" or "soft", plus ``mesa`` times the soft-target CE
    against ``mesa_targets`` where they are given."""
    outputs = forward_model(model, x, dtype, remat=remat)
    if jsd_splits > 1:
        return L.jsd_cross_entropy(outputs, targets, num_splits=jsd_splits, alpha=jsd_alpha,
                                   smoothing=smoothing)
    base = (L.soft_target_cross_entropy if targets.dim() == 2 else
            functools.partial(L.label_smoothing_cross_entropy, smoothing=smoothing))
    loss = L.distillation_loss(outputs, targets, teacher_logits, base_criterion=base,
                               kind=distillation, alpha=alpha, tau=tau)
    if mesa_targets is not None:
        loss = loss + mesa * L.soft_target_cross_entropy(outputs, mesa_targets)
    return loss


def ema_softmax(model: nn.Module, x: torch.Tensor, ema: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """MESA's targets: the fp32 softmax of the EMA model's logits on x, from an
    eval-mode forward without gradient."""
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            logits = forward_model(model, x, dtype, ema)
    finally:
        model.train(was)
    return torch.softmax(logits.float(), dim=-1)


def make_train_step(*, num_classes: int = 1000, mixup: bool = True,
                    mixup_kwargs: Optional[dict] = None, smoothing: float = 0.1,
                    ema_decay: float = 0.99996, dtype: torch.dtype = torch.bfloat16,
                    teacher_apply: Optional[Callable] = None, distillation: str = "none",
                    alpha: float = 0.5, tau: float = 1.0, remat: bool = False,
                    jsd_splits: int = 0, jsd_alpha: float = 12.0, grad_accum: int = 1,
                    mesa: float = 0.0, mesa_start_step: int = 0):
    """Returns ``train_step(state, batch, generator) -> {"loss", "grad_norm"}``: the
    state (``train/state.py``) carries the model and the optimizer.

    batch = {"image": NCHW float tensor, "label": integer tensor}, on the model's
    device; ``generator`` (a CPU ``torch.Generator``) gives the mixup draws. With
    ``distillation`` "hard" or "soft", ``teacher_apply(x) -> logits``
    (``make_teacher_apply``) scores the mixed batch and the state's model is the
    dual-head one (``distillation=True``); ``alpha`` and ``tau`` blend the losses as
    the JAX step does. ``grad_accum`` must be the state's optimizer's: the EMA decays
    only on the micro-steps that update. ``remat`` recomputes each block's forward in
    the backward. ``mesa`` > 0 adds MESA's term once ``state.step >=
    mesa_start_step`` (it needs the state's EMA; not with distillation or JSD).
    ``jsd_splits`` > 1: the batch holds that many views of the same samples, the
    clean one first, and the loss is the JSD loss (no mixup, no distillation)."""
    if distillation not in ("none", "hard", "soft"):
        raise ValueError(f"unknown distillation kind {distillation!r} (none, hard, soft)")
    if distillation != "none" and teacher_apply is None:
        raise ValueError(f"{distillation} distillation needs a teacher (teacher_apply)")
    if mesa > 0 and (distillation != "none" or jsd_splits > 1):
        raise ValueError("MESA self-distillation requires a single-logits model (no "
                         "dual-head distillation) and is incompatible with JSD")
    if jsd_splits > 1 and (mixup or distillation != "none"):
        raise ValueError("the JSD loss excludes mixup and distillation")
    mk = dict(num_classes=num_classes, smoothing=smoothing, **(mixup_kwargs or {}))

    def train_step(state: TrainState, batch, generator: torch.Generator):
        if state.optimizer.grad_accum != grad_accum:
            raise ValueError(f"the step accumulates {grad_accum} micro-steps, the "
                             f"optimizer {state.optimizer.grad_accum}")
        state.model.train()
        x, y = batch["image"], batch["label"]
        targets = y
        if mixup:
            x, targets = mixup_cutmix(generator, x, y, **mk)
        teacher_logits = teacher_apply(x) if distillation != "none" else None
        mesa_targets = None
        if mesa > 0 and state.step >= mesa_start_step:
            if state.ema is None:
                raise ValueError("MESA needs the EMA model as its teacher")
            mesa_targets = ema_softmax(state.model, x, state.ema, dtype)
        state.optimizer.zero_grad()
        loss = train_loss(state.model, x, targets, dtype=dtype, smoothing=smoothing,
                          teacher_logits=teacher_logits, distillation=distillation,
                          alpha=alpha, tau=tau, remat=remat, jsd_splits=jsd_splits,
                          jsd_alpha=jsd_alpha, mesa_targets=mesa_targets, mesa=mesa)
        loss.backward()
        gnorm = global_norm([p.grad for p in state.optimizer.params if p.grad is not None])
        updated = state.optimizer.step()
        if updated and state.ema is not None:
            ema_update(state.ema, state.model, ema_decay)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def eval_metrics(logits: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Summed correct@1/@5, CE sum and count, so results add up exactly across
    batches; padded rows carry label -1."""
    valid = labels >= 0
    top5 = torch.argsort(logits, dim=-1, stable=True)[:, -5:]
    acc1 = ((top5[:, -1] == labels) & valid).sum()
    acc5 = ((top5 == labels[:, None]).any(dim=-1) & valid).sum()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels.clamp_min(0).long()[:, None])[:, 0]
    loss_sum = torch.where(valid, ce, torch.zeros_like(ce)).sum()
    return {"correct1": acc1, "correct5": acc5, "loss_sum": loss_sum,
            "count": valid.sum()}


def make_eval_step(model: nn.Module, *, ema: bool = False,
                   dtype: torch.dtype = torch.bfloat16):
    """eval_step(state, batch) -> metrics: the unfused model in eval mode, in
    ``dtype``, on the model's weights or the EMA copy."""

    def eval_step(state: TrainState, batch):
        was = state.model.training
        state.model.eval()
        try:
            with torch.no_grad():
                logits = forward_model(state.model, batch["image"], dtype,
                                       state.ema if ema else None)
        finally:
            state.model.train(was)
        return eval_metrics(logits, batch["label"])

    return eval_step


def make_fused_eval_step(cfg: RecNextConfig, *, ema: bool = False,
                         fused_model: Optional[nn.Module] = None, packed: bool = False,
                         dtype: torch.dtype = torch.bfloat16):
    """Eval through BN-fused weights: each call folds the state's weights (or its
    EMA copy) with ``fusion.fuse_params`` into a fused model in ``dtype`` (built
    from ``cfg`` on the batch's device at first use, unless ``fused_model`` is
    given) and scores the batch with it, through the kernels on a CUDA tensor. The
    lane-packed executor of the JAX package is not ported (``packed`` raises)."""
    if packed:
        raise NotImplementedError(f"the packed executor is not ported; see {PACKED_ITEM}")
    holder = [fused_model]

    def eval_step(state: TrainState, batch):
        x = batch["image"]
        if holder[0] is None:
            holder[0] = RecNext(cfg, fused=True).to(device=x.device, dtype=dtype).eval()
        fused = holder[0]
        fused.load_state_dict(fuse_params(state.variables(ema=ema)), strict=True)
        with torch.inference_mode():
            logits = fused(x.to(dtype))
        return eval_metrics(logits, batch["label"])

    return eval_step
