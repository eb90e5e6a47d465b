"""NCHW convolution primitives: thin ``F.conv2d`` wrappers.

Weights are PyTorch's OIHW ``(out, in // groups, kh, kw)``, the layout of the
state dicts that ``convert.py`` produces from the JAX package's HWIO kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int | tuple[int, int] = 1,
    padding: int | tuple[int, int] = 0,
    dilation: int | tuple[int, int] = 1,
    groups: int = 1,
) -> torch.Tensor:
    """2D convolution, NCHW activations, OIHW weights, integer symmetric padding.
    Weights and bias are cast to the activation dtype."""
    if b is not None:
        b = b.to(x.dtype)
    return F.conv2d(x, w.to(x.dtype), b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def depthwise_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int | tuple[int, int] = 1,
    padding: int | tuple[int, int] = 0,
) -> torch.Tensor:
    """Depthwise conv: w is (C, 1, kh, kw), groups = C."""
    return conv2d(x, w, b, stride=stride, padding=padding, groups=int(w.shape[0]))


def _taps_geometry(x: torch.Tensor, k: int, stride: int, padding: int):
    oh = (int(x.shape[2]) + 2 * padding - k) // stride + 1
    ow = (int(x.shape[3]) + 2 * padding - k) // stride + 1
    return oh, ow


def _tap(xp: torch.Tensor, dh: int, dw: int, oh: int, ow: int, stride: int) -> torch.Tensor:
    """The strided window of the padded input that tap (dh, dw) multiplies."""
    return xp[:, :, dh: dh + (oh - 1) * stride + 1: stride,
              dw: dw + (ow - 1) * stride + 1: stride]


def _taps_forward(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    k = int(w.shape[-1])
    oh, ow = _taps_geometry(x, k, stride, padding)
    xp = F.pad(x, (padding, padding, padding, padding))
    wt = w.to(x.dtype)
    out = None
    for dh in range(k):
        for dw in range(k):
            term = _tap(xp, dh, dw, oh, ow, stride) * wt[:, 0, dh, dw].view(1, -1, 1, 1)
            out = term if out is None else out + term
    return out


class _DepthwiseTaps(torch.autograd.Function):
    """k*k shifted multiply-adds forward; the backward of the same decomposition
    (``recnext_tpu/ops/conv.py:depthwise_conv2d_taps`` under ``jax.vjp``): each tap
    adds g * w[tap] into its strided window of the padded input's gradient, and the
    filter's gradient at a tap is the sum over batch and plane of g times that
    window."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return _taps_forward(x, w, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, p = ctx.stride, ctx.padding
        k = int(w.shape[-1])
        oh, ow = _taps_geometry(x, k, s, p)
        g = g.to(x.dtype)
        wt = w.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp = g.new_zeros((x.shape[0], x.shape[1], int(x.shape[2]) + 2 * p,
                               int(x.shape[3]) + 2 * p))
            for dh in range(k):
                for dwi in range(k):
                    _tap(dxp, dh, dwi, oh, ow, s).add_(g * wt[:, 0, dh, dwi].view(1, -1, 1, 1))
            dx = dxp[:, :, p: p + int(x.shape[2]), p: p + int(x.shape[3])]
        if ctx.needs_input_grad[1]:
            xp = F.pad(x, (p, p, p, p))
            taps = [(_tap(xp, dh, dwi, oh, ow, s) * g).sum(dim=(0, 2, 3))
                    for dh in range(k) for dwi in range(k)]
            dw = torch.stack(taps, dim=1).view(w.shape).to(w.dtype)
        return dx, dw, None, None


def depthwise_conv2d_taps(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """Depthwise conv decomposed into k*k shifted multiply-adds
    (``recnext_tpu/ops/conv.py:depthwise_conv2d_taps``): x NCHW, w (C, 1, k, k). The
    same function as ``depthwise_conv2d`` with the sum reassociated; its gradients
    come from the same decomposition (``_DepthwiseTaps``)."""
    out = _DepthwiseTaps.apply(x, w, int(stride), int(padding))
    if b is not None:
        out = out + b.to(out.dtype).view(1, -1, 1, 1)
    return out
