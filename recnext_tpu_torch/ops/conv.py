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
