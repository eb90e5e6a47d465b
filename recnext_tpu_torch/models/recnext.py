"""RecNext backbone, M and A families: stem -> 4 stages of MetaNeXtBlockM or
MetaNeXtBlockA (a Downsample between stages) -> fp32 global mean pool -> classifier.

Counterpart of ``recnext_tpu/models/recnext.py`` in NCHW. The module tree is the
reference PyTorch model's, so the state dicts that ``recnext_tpu/convert.py`` emits
(and ``convert.py`` here) load with ``strict=True``: ``stem.stem.{0,2}``,
``stages.{i}.downsample``, ``stages.{i}.blocks.{j}``, and ``head.head``/
``head.head_dist`` (unfused) or a single ``head`` Linear (fused). The L family
comes in a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from recnext_tpu_torch.models.layers import (
    GELU,
    DropPath,
    NormLinear,
    batch_norm2d,
    conv_norm,
    mlp,
    recomputing,
)
from recnext_tpu_torch.models.mixers import RecAttn2d, RecConv2dMixer

def _checkpointed(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)``, keeping only x and recomputing the block in the backward
    (``torch.utils.checkpoint``, non-reentrant): the JAX step's ``remat``
    (``jax.checkpoint``). The recomputed forward leaves BatchNorm's running statistics
    alone (``layers.recomputing``) and runs the mixers' kernels a second time. The
    block's parameters as they stand
    (under ``functional_call``, the compute-dtype casts) are inputs of the
    checkpointed function, so the recomputation sees them and their gradients flow
    back through the casts."""
    params = dict(block.named_parameters())
    names = list(params)

    def run(x, *tensors):
        return functional_call(block, dict(zip(names, tensors)), (x,))

    return checkpoint(run, x, *params.values(), use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), recomputing()))


@dataclasses.dataclass(frozen=True)
class RecNextConfig:
    """Static architecture description for one model variant."""

    name: str
    family: str  # "m" | "a" | "l"
    embed_dim: Tuple[int, ...]
    depth: Tuple[int, ...]
    mlp_ratio: Tuple[float, ...]
    num_heads: Tuple[int, ...] = (2, 2, 2, 2)  # L only
    split_rates: Tuple[int, ...] = (4, 4, 4, 4)  # L only
    drop_path: float = 0.0
    num_classes: int = 1000
    distillation: bool = False
    drop_rate: float = 0.0
    in_chans: int = 3
    share_channel: bool = False  # L share-channel variant
    # RecConv ablation knobs (the reference's rec_{3x3,5x5,7x7} and *_nearest runs)
    recconv_kernel_size: int = 5
    recconv_mode: str = "bilinear"  # "bilinear" | "nearest"
    # linear-attention feature map (A family): "elu" | "softplus" | "relu"
    attn_kernel: str = "elu"

    @property
    def num_features(self) -> int:
        return self.embed_dim[-1]


class RecNextStem(nn.Module):
    """Two stride-2 3x3 ConvNorm with a GELU between them (total stride 4)."""

    def __init__(self, cin: int, cout: int, *, fused: bool = False):
        super().__init__()
        kw = dict(kernel_size=3, stride=2, padding=1, fused=fused)
        self.stem = nn.Sequential(conv_norm(cin, cout // 2, **kw), GELU(),
                                  conv_norm(cout // 2, cout, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stem(x)


class MetaNeXtBlockM(nn.Module):
    """x + drop_path(mlp(BN(RecConv2d(x)))), RecConv level = 4 - stage."""

    def __init__(self, dim: int, mlp_ratio: float, stage: int, drop_path: float = 0.0,
                 kernel_size: int = 5, mode: str = "bilinear", *, fused: bool = False):
        super().__init__()
        self.token_mixer = RecConv2dMixer(dim, level=4 - stage, kernel_size=kernel_size,
                                          mode=mode)
        # a standalone BN: fusion keeps it, as an affine with identity statistics
        self.norm = batch_norm2d(dim)
        self.channel_mixer = mlp(dim, int(dim * mlp_ratio), fused=fused)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.channel_mixer(self.norm(self.token_mixer(x)))
        return x + self.drop_path(y)


class MetaNeXtBlockA(nn.Module):
    """x + drop_path(mlp(RecAttn2d(x))): heads 2**(stage+1), the qk-first variant 2
    at stage 3; no standalone norm."""

    def __init__(self, dim: int, mlp_ratio: float, stage: int, drop_path: float = 0.0,
                 attn_kernel: str = "elu", *, fused: bool = False):
        super().__init__()
        self.token_mixer = RecAttn2d(dim, num_heads=2 ** (stage + 1),
                                     la_variant=2 if stage >= 3 else 1, kernel=attn_kernel,
                                     fused=fused)
        self.channel_mixer = mlp(dim, int(dim * mlp_ratio), fused=fused)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.drop_path(self.channel_mixer(self.token_mixer(x)))


class Downsample(nn.Module):
    """DW 7x7 stride-2 conv (channels double) + BN, then x + mlp(x)."""

    def __init__(self, cin: int, mlp_ratio: float, *, fused: bool = False):
        super().__init__()
        cout = cin * 2
        self.token_mixer = nn.Conv2d(cin, cout, 7, 2, 3, groups=cin, bias=True)
        self.norm = batch_norm2d(cout)
        self.channel_mixer = mlp(cout, int(cout * mlp_ratio), fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.token_mixer(x))
        return x + self.channel_mixer(x)


class Stage(nn.Module):
    def __init__(self, downsample: nn.Module | None, blocks: list):
        super().__init__()
        self.downsample = downsample if downsample is not None else nn.Identity()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``remat``: each block is recomputed in the backward (under grad)."""
        x = self.downsample(x)
        remat = remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = _checkpointed(blk, x) if remat else blk(x)
        return x


class RecNextClassifier(nn.Module):
    """Dual NormLinear heads: in training with distillation a tuple, otherwise their
    average. The fused model replaces this with one Linear (the heads averaged)."""

    def __init__(self, dim: int, num_classes: int, distillation: bool = False,
                 drop: float = 0.0):
        super().__init__()
        self.distillation = distillation
        self.drop = nn.Dropout(drop)
        self.head = NormLinear(dim, num_classes)
        self.head_dist = NormLinear(dim, num_classes)

    def forward(self, x: torch.Tensor):
        x = self.drop(x)
        x1, x2 = self.head(x), self.head_dist(x)
        if self.training and self.distillation:
            return x1, x2
        return (x1 + x2) / 2


# where each family not yet ported stands in ROADMAP.md
_NOT_PORTED = {
    "l": "ROADMAP.md Queue 1 item 8 (L family)",
}


class RecNext(nn.Module):
    """Top-level backbone. ``forward`` gives logits, ``forward_features`` the final
    map, ``features`` the four stage maps [C2, C3, C4, C5] (the downstream API)."""

    def __init__(self, cfg: RecNextConfig, *, fused: bool = False):
        super().__init__()
        if cfg.family in _NOT_PORTED:
            raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family is not ported "
                                      f"to PyTorch yet; see {_NOT_PORTED[cfg.family]}")
        self.cfg = cfg
        self.stem = RecNextStem(cfg.in_chans, cfg.embed_dim[0], fused=fused)
        stages = []
        for i, (dim, depth) in enumerate(zip(cfg.embed_dim, cfg.depth)):
            ratio = cfg.mlp_ratio[i]
            ds = None if i == 0 else Downsample(cfg.embed_dim[i - 1], ratio, fused=fused)
            if cfg.family == "m":
                blocks = [MetaNeXtBlockM(dim, ratio, stage=i, drop_path=cfg.drop_path,
                                         kernel_size=cfg.recconv_kernel_size,
                                         mode=cfg.recconv_mode, fused=fused)
                          for _ in range(depth)]
            else:
                blocks = [MetaNeXtBlockA(dim, ratio, stage=i, drop_path=cfg.drop_path,
                                         attn_kernel=cfg.attn_kernel, fused=fused)
                          for _ in range(depth)]
            stages.append(Stage(ds, blocks))
        self.stages = nn.ModuleList(stages)
        if cfg.num_classes <= 0:
            self.head = nn.Identity()
        elif fused:
            self.head = nn.Linear(cfg.num_features, cfg.num_classes)
        else:
            self.head = RecNextClassifier(cfg.num_features, cfg.num_classes,
                                          cfg.distillation, cfg.drop_rate)

    def features(self, x: torch.Tensor, remat: bool = False) -> list:
        x = self.stem(x)
        outs = []
        for stage in self.stages:
            x = stage(x, remat)
            outs.append(x)
        return outs

    def forward_features(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        return self.features(x, remat)[-1]

    def forward(self, x: torch.Tensor, remat: bool = False):
        x = self.forward_features(x, remat)
        x = x.float().mean(dim=(2, 3)).to(x.dtype)
        return self.head(x)


# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides by it
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisation, drawn from ``generator``: convs He-normal
    truncated at 2 std (variance_scaling(2.0, fan_in)), linears truncated normal
    std 0.02, zero biases, BatchNorm at identity."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, 0.0, 0.02, -0.04, 0.04, generator=generator)
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return model
