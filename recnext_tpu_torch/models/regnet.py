"""RegNetY: the hard-distillation teacher behind every headline RecNeXt accuracy.

The port's own copy of ``recnext_tpu/models/regnet.py``, in NCHW: the reference
trains with ``--teacher-model regnety_160`` and its published DeiT checkpoint. It has
the quantized-linear width rule (``generate_regnet_widths``, ``adjust_widths_groups``),
``RegNetConfig`` and ``REGNET_CONFIGS`` (regnety_160/040/016), and the Y bottleneck
(1x1 -> grouped 3x3 -> squeeze-excite on the block input's width -> 1x1, residual),
a stride-2 stem and an fp32 mean pool with an fp32 linear head. It is eval-only, as
in JAX: a teacher's BatchNorm uses its running statistics.

Module names are timm's (``stem.conv/bn``, ``s{i}.b{j}.conv{1,2,3}.{conv,bn}``,
``s{i}.b{j}.se.fc{1,2}``, ``s{i}.b{j}.downsample.{conv,bn}``, ``head.fc``), so a
published timm ``regnety_160`` state dict loads with ``load_state_dict(strict=True)``;
``convert.jax_regnet_to_torch`` carries the JAX package's weights across.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from recnext_tpu_torch.device import resolve_device
from recnext_tpu_torch.models.layers import batch_norm2d
from recnext_tpu_torch.models.recnext import init_weights


def generate_regnet_widths(w0: float, wa: float, wm: float, depth: int,
                           q: int = 8) -> Tuple[List[int], List[int]]:
    """pycls quantized-linear rule: per-stage (widths, depths)."""
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = (np.round(w0 * np.power(wm, ks) / q) * q).astype(int).tolist()
    stage_widths = sorted(set(widths))
    return stage_widths, [widths.count(w) for w in stage_widths]


def adjust_widths_groups(widths: Sequence[int], group_w: int,
                         bottle_ratio: float = 1.0) -> Tuple[List[int], List[int]]:
    """Make bottleneck widths divisible by their group width (pycls)."""
    ws_bot = [int(round(w * bottle_ratio)) for w in widths]
    gs = [min(group_w, wb) for wb in ws_bot]
    ws_bot = [int(round(wb / g) * g) for wb, g in zip(ws_bot, gs)]
    return [int(wb / bottle_ratio) for wb in ws_bot], gs


@dataclass(frozen=True)
class RegNetConfig:
    name: str
    w0: float
    wa: float
    wm: float
    depth: int
    group_width: int
    stem_width: int = 32
    bottle_ratio: float = 1.0
    se_ratio: float = 0.25
    num_classes: int = 1000

    def stages(self) -> Tuple[List[int], List[int], List[int]]:
        """(stage_widths, stage_depths, stage_group_widths)."""
        ws, ds = generate_regnet_widths(self.w0, self.wa, self.wm, self.depth)
        ws, gs = adjust_widths_groups(ws, self.group_width, self.bottle_ratio)
        return ws, ds, gs


REGNET_CONFIGS = {
    # regnety_160 = RegNetY-16GF: stages (224, 448, 1232, 3024) x (2, 4, 11, 1), g = 112
    "regnety_160": RegNetConfig("regnety_160", w0=200, wa=106.23, wm=2.48,
                                depth=18, group_width=112),
    "regnety_040": RegNetConfig("regnety_040", w0=96, wa=31.41, wm=2.24,
                                depth=22, group_width=64),
    "regnety_016": RegNetConfig("regnety_016", w0=48, wa=20.71, wm=2.65,
                                depth=27, group_width=24),
}


class ConvBn(nn.Module):
    """Bias-free Conv2d + BatchNorm2d (timm's ``conv``/``bn``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding, groups=groups,
                              bias=False)
        self.bn = batch_norm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class SEModule(nn.Module):
    """Squeeze-excite: fp32 mean pool -> 1x1 fc1 -> relu -> 1x1 fc2 -> fp32 sigmoid gate."""

    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, rd_channels, 1)
        self.fc2 = nn.Conv2d(rd_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s.float()).to(x.dtype)


class YBottleneck(nn.Module):
    """RegNetY bottleneck: 1x1 -> grouped 3x3 (stride) -> SE -> 1x1, residual. The SE
    width comes from the block input's width (pycls w_se = w_in * se_r)."""

    def __init__(self, cin: int, cout: int, stride: int, group_width: int,
                 bottle_ratio: float = 1.0, se_ratio: float = 0.25):
        super().__init__()
        w_b = int(round(cout * bottle_ratio))
        groups = max(1, w_b // group_width)
        self.conv1 = ConvBn(cin, w_b)
        self.conv2 = ConvBn(w_b, w_b, 3, stride, 1, groups=groups)
        self.se = SEModule(w_b, max(1, int(round(cin * se_ratio))))
        self.conv3 = ConvBn(w_b, cout)
        self.downsample = (ConvBn(cin, cout, 1, stride) if stride != 1 or cin != cout
                           else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(self.se(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class RegNetStage(nn.Module):
    """Blocks ``b1``, ``b2``, ... in order."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        for j, blk in enumerate(blocks):
            self.add_module(f"b{j + 1}", blk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.children():
            x = blk(x)
        return x


class Fp32Linear(nn.Linear):
    """A linear layer on fp32 inputs and weights whatever the compute dtype: its
    ``fp32`` flag keeps the train step's casts (``train/step.py:compute_params``) off
    its parameters."""

    fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class RegNetHead(nn.Module):
    """fp32 mean pool and an fp32 linear classifier (``head.fc``), whatever the
    compute dtype, as the JAX model's ``head_fc``."""

    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.fc = Fp32Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.float().mean(dim=(2, 3)))


class RegNetY(nn.Module):
    def __init__(self, cfg: RegNetConfig):
        super().__init__()
        self.cfg = cfg
        self.stem = ConvBn(3, cfg.stem_width, 3, 2, 1)
        ws, ds, gs = cfg.stages()
        cin = cfg.stem_width
        for si, (w, d, g) in enumerate(zip(ws, ds, gs)):
            blocks = []
            for bi in range(d):
                blocks.append(YBottleneck(cin, w, 2 if bi == 0 else 1, g, cfg.bottle_ratio,
                                          cfg.se_ratio))
                cin = w
            self.add_module(f"s{si + 1}", RegNetStage(blocks))
        self.num_stages = len(ws)
        self.head = RegNetHead(cin, cfg.num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem(x))
        for si in range(self.num_stages):
            x = getattr(self, f"s{si + 1}")(x)
        return self.head(x)


def create_regnet(name: str, *, num_classes: int = 1000,
                  device: str | torch.device | None = None,
                  generator: torch.Generator | None = None) -> RegNetY:
    """``name`` from ``REGNET_CONFIGS`` on ``device`` (default: the GPU; raises without
    one), fp32 weights drawn from ``generator`` (default: seed 0) by the JAX package's
    initialisation, in eval mode. The train step's ``make_teacher_apply`` casts them to
    the compute dtype."""
    if name not in REGNET_CONFIGS:
        raise KeyError(f"unknown regnet {name!r}; known: {sorted(REGNET_CONFIGS)}")
    dev = resolve_device(device)
    model = RegNetY(dataclasses.replace(REGNET_CONFIGS[name], num_classes=num_classes))
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(dev).eval()
