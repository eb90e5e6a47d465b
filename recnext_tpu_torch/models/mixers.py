"""Token mixers: the M family's ``RecConv2dMixer``, and ``LinearAttention``
(variants 1 and 2, the A family's; variant 3, the L family's) and ``RecAttn2d``.

Counterparts of ``recnext_tpu/models/mixers.py`` in NCHW. The L family's forms
carry a conv bias in every ConvNorm (``bias=True``). Each mixer with a kernel has a
``forward_plain`` that runs the plain PyTorch version on any device: the
reference the kernel path is held against.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from recnext_tpu_torch.models.layers import conv_norm
from recnext_tpu_torch.ops.attention import (
    feature_map,
    linear_attention_nchw,
    linear_attention_nchw_plain,
)
from recnext_tpu_torch.ops.recconv import rec_conv2d, rec_conv2d_fused
from recnext_tpu_torch.ops.resize import resize


class RecConv2dMixer(nn.Module):
    """Recursive multi-frequency depthwise conv: a shared stride-2 ``down`` kernel
    plus level+1 per-level kernels, bias-free. Parameters ``down.weight`` and
    ``convs.{i}.weight``, each (C, 1, k, k). On a CUDA tensor the whole pyramid is
    one launch of the fused kernel, in either mode (planes too large for its shared
    memory peel their outer levels first: ``ops/recconv.py:rec_conv2d_fused``); in
    training, the backward is one launch of the backward kernel."""

    def __init__(self, channels: int, level: int, kernel_size: int = 5,
                 mode: str = "bilinear"):
        super().__init__()
        self.level = level
        self.mode = mode
        pad = kernel_size // 2

        def dw(stride):
            return nn.Conv2d(channels, channels, kernel_size, stride, pad,
                             groups=channels, bias=False)

        self.down = dw(2)
        self.convs = nn.ModuleList(dw(1) for _ in range(level + 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """On a CUDA tensor: the fused kernel, and where a gradient is needed, the
        kernel pair of ``ops/recconv.py:RecConv2dFunction`` (raises for planes the
        backward kernel cannot take). The weights must have x's dtype, as a Conv2d's
        must; the train step casts them (``train/step.py:compute_params``)."""
        return rec_conv2d_fused(x, self.down.weight, [c.weight for c in self.convs],
                                level=self.level, mode=self.mode)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version on any device: the reference the kernel path
        is held against."""
        return rec_conv2d(x, self.down.weight, [c.weight for c in self.convs],
                          level=self.level, mode=self.mode)


class LinearAttention(nn.Module):
    """Mean-normalised linear attention with a depthwise positional term:
    ``attn(feature_map(qk(x)), x) + pe(x)``, v = x. Variant 1 is the kv-first form,
    variant 2 the qk-first one (the same function). Variant 3 (the L family's) halves
    the heads, takes q and k from a c -> c ConvNorm (groups 1), so that a head's q and
    k are half as wide as its v (D = c / heads / 2, DV = c / heads), and runs the
    qk-first form. On a CUDA tensor every variant is one launch of the
    linear-attention kernel, and where a gradient is needed the kernel pair of
    ``ops/attention.py:LinearAttentionFunction`` (K2 forward, one launch of its
    backward kernel); x may be a channel slice of a wider tensor (the L family's
    partial-channel split), which the kernels read in place. Submodules ``qk`` (1x1;
    2C outputs in 2 groups, or C in one for variant 3) and ``pe`` (3x3 depthwise),
    each a ConvNorm."""

    def __init__(self, dim: int, num_heads: int, variant: int = 1, kernel: str = "elu",
                 *, bias: bool = False, fused: bool = False):
        super().__init__()
        if variant not in (1, 2, 3):
            raise ValueError(f"LinearAttention variant {variant} is not one of 1, 2, 3")
        self.variant = variant
        self.kernel = kernel
        if variant == 3:
            self.num_heads = num_heads // 2
            self.qk = conv_norm(dim, dim, 1, bias=bias, fused=fused)
        else:
            self.num_heads = num_heads
            self.qk = conv_norm(dim, dim * 2, 1, groups=2, bias=bias, fused=fused)
        self.pe = conv_norm(dim, dim, 3, padding=1, groups=dim, bias=bias, fused=fused)
        # variant 3 is the qk-first form over its narrower q and k
        self._form = 2 if variant == 3 else variant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qk = feature_map(self.qk(x), self.kernel)
        return linear_attention_nchw(qk, x, self.num_heads, variant=self._form) + self.pe(x)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version on any device (autograd over it where a gradient
        is needed): the reference the kernel path is held against."""
        qk = feature_map(self.qk(x), self.kernel)
        return (linear_attention_nchw_plain(qk, x, self.num_heads, variant=self._form)
                + self.pe(x))


class RecAttn2d(nn.Module):
    """A one-level RecConv whose coarse body is linear attention:
    ``conv(x + nearest_up(attn(down(x))))``. ``down`` is a Sequential of the
    stride-2 depthwise ConvNorm and the LinearAttention (torch keys ``down.0.*``,
    ``down.1.{qk,pe}.*``), ``conv`` the full-resolution depthwise ConvNorm; all with a
    conv bias in the L form. Its attention runs the LinearAttention's kernels, under
    grad both of them; its convolutions and the nearest upsample are plain PyTorch."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 5, la_variant: int = 1,
                 kernel: str = "elu", mode: str = "nearest", *, bias: bool = False,
                 fused: bool = False):
        super().__init__()
        self.mode = mode
        pad = kernel_size // 2
        kw = dict(groups=dim, bias=bias, fused=fused)
        self.down = nn.Sequential(
            conv_norm(dim, dim, kernel_size, 2, pad, **kw),
            LinearAttention(dim, num_heads, la_variant, kernel, bias=bias, fused=fused))
        self.conv = conv_norm(dim, dim, kernel_size, 1, pad, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = resize(self.down(x), (int(x.shape[2]), int(x.shape[3])), mode=self.mode)
        return self.conv(x + y)
