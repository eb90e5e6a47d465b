"""Token mixers. This slice ports the M family's ``RecConv2dMixer``
(``recnext_tpu/models/mixers.py:32-71``); the attention mixers come with the A family.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from recnext_tpu_torch.ops.recconv import rec_conv2d, rec_conv2d_fused


class RecConv2dMixer(nn.Module):
    """Recursive multi-frequency depthwise conv: a shared stride-2 ``down`` kernel
    plus level+1 per-level kernels, bias-free. Parameters ``down.weight`` and
    ``convs.{i}.weight``, each (C, 1, k, k). On a CUDA tensor the whole pyramid is
    one launch of the fused kernel."""

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

    def _weights(self):
        return self.down.weight, [c.weight for c in self.convs]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        down_w, conv_ws = self._weights()
        return rec_conv2d_fused(x, down_w, conv_ws, level=self.level, mode=self.mode)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version on any device: the reference the kernel path
        is held against."""
        down_w, conv_ws = self._weights()
        return rec_conv2d(x, down_w, conv_ws, level=self.level, mode=self.mode)
