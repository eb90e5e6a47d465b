"""Structural layers: GELU, BatchNorm, ConvNorm, NormLinear, Mlp, DropPath.

Counterparts of ``recnext_tpu/models/layers.py`` in NCHW. Every layer has an
unfused (train/eval) and a fused (inference) structure, and the parameter names
are the torch keys that ``recnext_tpu/convert.py`` emits: ``X.conv.weight`` and
``X.norm.*`` for an unfused ConvNorm, a plain ``X.weight``/``X.bias`` conv once it
is fused. ``fusion.py`` maps one state dict onto the other.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5  # torch.nn.BatchNorm default, the reference's

_RECOMPUTING = contextvars.ContextVar("recomputing", default=False)


@contextlib.contextmanager
def recomputing():
    """The context of a forward recomputed for its backward (``torch.utils.
    checkpoint``): BatchNorm in train mode normalises by the batch's statistics
    again but leaves its running statistics, which the first forward updated."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, not the tanh approximation."""
    return F.gelu(x, approximate="none")


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class _ParamDtypeNorm:
    """BatchNorm in its parameters' dtype: in training (fp32 parameters, bf16
    activations) the statistics and the normalisation run in fp32 and the output
    takes x's dtype, as the JAX package's BatchNorm does; where x already has the
    parameters' dtype (the inference models) it is the plain torch BatchNorm. In
    train mode torch's BatchNorm is the JAX one: the batch's biased variance
    normalises, the unbiased one enters the running statistics with momentum 0.1;
    inside ``recomputing()`` the running statistics are not touched."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and _RECOMPUTING.get():
            # the first forward's op, with copies of the statistics to update: the
            # recomputation saves the same tensors for the backward
            xf = x if self.weight is None else x.to(self.weight.dtype)
            y = F.batch_norm(xf, self.running_mean.clone(), self.running_var.clone(),
                             self.weight, self.bias, True, self.momentum, self.eps)
            return y.to(x.dtype)
        if self.weight is None or x.dtype == self.weight.dtype:
            return super().forward(x)
        return super().forward(x.to(self.weight.dtype)).to(x.dtype)


class BatchNorm2d(_ParamDtypeNorm, nn.BatchNorm2d):
    pass


class BatchNorm1d(_ParamDtypeNorm, nn.BatchNorm1d):
    pass


def batch_norm2d(channels: int) -> nn.BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS)


class ConvNorm(nn.Module):
    """Conv2d (bias-free, the M/A form) + BatchNorm2d."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding, groups=groups,
                              bias=False)
        self.norm = batch_norm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


def conv_norm(cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
              padding: int = 0, groups: int = 1, *, fused: bool = False) -> nn.Module:
    """ConvNorm, or its fused form: one conv with a bias."""
    if fused:
        return nn.Conv2d(cin, cout, kernel_size, stride, padding, groups=groups, bias=True)
    return ConvNorm(cin, cout, kernel_size, stride, padding, groups)


class NormLinear(nn.Module):
    """BatchNorm1d + Linear (one classifier head); fused, a plain Linear."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = BatchNorm1d(cin, eps=BN_EPS)
        self.linear = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.norm(x))


def mlp(channels: int, hidden: int, *, fused: bool = False) -> nn.Sequential:
    """1x1 ConvNorm -> GELU -> 1x1 ConvNorm channel mixer (no internal residual).
    Keys ``0.*`` and ``2.*``, as the reference's Sequential."""
    return nn.Sequential(conv_norm(channels, hidden, fused=fused), GELU(),
                         conv_norm(hidden, channels, fused=fused))


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity in eval or at rate 0. Draws its mask
    from ``generator`` (None: torch's default generator of the device)."""

    def __init__(self, rate: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.empty(shape, device=x.device, dtype=x.dtype).bernoulli_(
            keep, generator=self.generator)
        return x * mask / keep
