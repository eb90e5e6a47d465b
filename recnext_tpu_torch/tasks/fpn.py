"""Feature Pyramid Network neck, NCHW: the port's counterpart of
``recnext_tpu/tasks/fpn.py`` (the mm-ecosystem FPN that the reference's detection and
segmentation recipes put after the backbone).

Takes the backbone pyramid [C2, C3, C4, C5] of ``RecNext.features`` and gives
``num_outs`` maps of ``out_channels``: 1x1 laterals, a top-down pass that adds each
level's nearest x2 upsample (``ops/resize.py``) to the level below, 3x3 output convs,
and extra levels (detection's P6) as a stride-2 subsample of the last output: the JAX
package's ``nn.max_pool`` with a 1x1 window and stride 2, not a 3x3 pool.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from recnext_tpu_torch.ops.resize import resize


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(nn.Conv2d(c, out_channels, 1)
                                           for c in in_channels)
        self.fpn_convs = nn.ModuleList(nn.Conv2d(out_channels, out_channels, 3, padding=1)
                                       for _ in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            up = resize(laterals[i], laterals[i - 1].shape[2:], mode="nearest")
            laterals[i - 1] = laterals[i - 1] + up
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return outs
