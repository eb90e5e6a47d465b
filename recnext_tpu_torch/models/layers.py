"""Structural layers: GELU, BatchNorm, ConvNorm, RepVGGDW, NormLinear, Mlp, DropPath,
and the MLLA family's LayerNorm and ConvLayer.

Counterparts of ``recnext_tpu/models/layers.py`` (and of ``recnext_tpu/models/mlla.py``'s
``ConvLayer`` and flax's ``nn.LayerNorm``) in NCHW. Every layer has an
unfused (train/eval) and a fused (inference) structure, and the parameter names
are the torch keys that ``recnext_tpu/convert.py`` emits: ``X.conv.weight`` and
``X.norm.*`` for an unfused ConvNorm, a plain ``X.weight``/``X.bias`` conv once it
is fused (a RepVGGDW's ``X.lk.*`` and ``X.sk.*`` likewise become one conv ``X``).
``fusion.py`` maps one state dict onto the other.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5  # torch.nn.BatchNorm default, the reference's
LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)

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
    """Conv2d + BatchNorm2d; the conv is bias-free in the M/A form and has a bias in
    the L form (``bias=True``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding, groups=groups,
                              bias=bias)
        self.norm = batch_norm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


def conv_norm(cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
              padding: int = 0, groups: int = 1, *, bias: bool = False,
              fused: bool = False) -> nn.Module:
    """ConvNorm, or its fused form: one conv with a bias (a conv bias of the unfused
    form folds into it)."""
    if fused:
        return nn.Conv2d(cin, cout, kernel_size, stride, padding, groups=groups, bias=True)
    return ConvNorm(cin, cout, kernel_size, stride, padding, groups, bias)


class RepVGGDW(nn.Module):
    """The L family's reparameterisable depthwise block: ``lk(x) + sk(x) + x``, with
    ``lk`` a 3x3 and ``sk`` a 1x1 depthwise ConvNorm, both with a conv bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.lk = ConvNorm(dim, dim, 3, 1, 1, groups=dim, bias=True)
        self.sk = ConvNorm(dim, dim, 1, groups=dim, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lk(x) + self.sk(x) + x


def rep_vgg_dw(dim: int, *, fused: bool = False) -> nn.Module:
    """RepVGGDW, or its fused form: one 3x3 depthwise conv with a bias."""
    if fused:
        return nn.Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=True)
    return RepVGGDW(dim)


class NormLinear(nn.Module):
    """BatchNorm1d + Linear (one classifier head); fused, a plain Linear."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = BatchNorm1d(cin, eps=BN_EPS)
        self.linear = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.norm(x))


def mlp(channels: int, hidden: int, *, bias: bool = False,
        fused: bool = False) -> nn.Sequential:
    """1x1 ConvNorm -> GELU -> 1x1 ConvNorm channel mixer (no internal residual;
    conv biases in the L form). Keys ``0.*`` and ``2.*``, as the reference's
    Sequential."""
    return nn.Sequential(conv_norm(channels, hidden, bias=bias, fused=fused), GELU(),
                         conv_norm(hidden, channels, bias=bias, fused=fused))


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


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last dimension (the MLLA family's): the
    statistics, the normalisation, scale and bias in fp32 (flax's
    ``force_float32_reductions``, whatever dtype the scale and bias were cast to),
    epsilon 1e-6, and the output cast to x's dtype. Parameters ``weight`` and
    ``bias``, the reference's names. ``train/step.py:compute_params`` leaves them
    fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.eps = LN_EPS
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(x.dtype)


class ConvLayer(nn.Module):
    """A bias-free Conv2d (``conv``, padding k // 2), BatchNorm (``norm``) and, where
    ``act``, ReLU: the MLLA stem's building block (``recnext_tpu/models/mlla.py:
    ConvLayer`` as the stem uses it)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1, *,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, kernel_size // 2, bias=False)
        self.norm = batch_norm2d(cout)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        return F.relu(x) if self.act else x
