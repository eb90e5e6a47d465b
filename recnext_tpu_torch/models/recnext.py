"""RecNext backbone, M, A and L families: stem -> 4 stages of MetaNeXtBlockM,
MetaNeXtBlockA or MetaNeXtBlockL (a Downsample or DownsampleL between stages) ->
fp32 global mean pool -> classifier.

Counterpart of ``recnext_tpu/models/recnext.py`` in NCHW. The module tree is the
reference PyTorch model's, so the state dicts that ``recnext_tpu/convert.py`` emits
(and ``convert.py`` here) load with ``strict=True``: ``stem.stem.{0,2}`` (L:
``{0,2,4}``), ``stages.{i}.downsample``, ``stages.{i}.blocks.{j}`` (L:
``rep_mixer``, ``token_mixer.attn``, ``channel_mixer``), and ``head.head``/
``head.head_dist`` (unfused) or a single ``head`` Linear (fused).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
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
    rep_vgg_dw,
)
from recnext_tpu_torch.models.mixers import LinearAttention, RecAttn2d, RecConv2dMixer


def _checkpointed(block: nn.Module, *inputs: torch.Tensor):
    """``block(*inputs)``, keeping only the inputs and recomputing the block in the
    backward (``torch.utils.checkpoint``, non-reentrant): the JAX step's ``remat``
    (``jax.checkpoint``). The recomputed forward leaves BatchNorm's running statistics
    alone (``layers.recomputing``) and runs the mixers' kernels a second time. The
    block's parameters as they stand
    (under ``functional_call``, the compute-dtype casts) are inputs of the
    checkpointed function, so the recomputation sees them and their gradients flow
    back through the casts."""
    params = dict(block.named_parameters())
    names = list(params)
    k = len(inputs)

    def run(*tensors):
        return functional_call(block, dict(zip(names, tensors[k:])), tensors[:k])

    return checkpoint(run, *inputs, *params.values(), use_reentrant=False,
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

    def feature_info(self):
        """Each stage map's channels, stride and module name (the task heads' API)."""
        stride = 4 if self.family != "l" else 8
        info = []
        for i, dim in enumerate(self.embed_dim):
            if i != 0:
                stride *= 2
            info.append(dict(num_chs=dim, reduction=stride, module=f"stages_{i}"))
        return info


class RecNextStem(nn.Module):
    """M/A: two stride-2 3x3 ConvNorm with a GELU between them (total stride 4).
    L: three stride-2 3x3 ConvNorm with conv biases, out/4 -> out/2 -> out, a GELU
    after the first two and a trailing one where stage 0 is empty (``final_gelu``),
    total stride 8; the GELUs sit between the convs as in the reference's
    Sequential, so the convs are ``stem.{0,2,4}``."""

    def __init__(self, cin: int, cout: int, *, family: str = "m", final_gelu: bool = False,
                 fused: bool = False):
        super().__init__()
        kw = dict(kernel_size=3, stride=2, padding=1, fused=fused)
        if family == "l":
            layers = [conv_norm(cin, cout // 4, bias=True, **kw), GELU(),
                      conv_norm(cout // 4, cout // 2, bias=True, **kw), GELU(),
                      conv_norm(cout // 2, cout, bias=True, **kw)]
            self.stem = nn.Sequential(*layers, *([GELU()] if final_gelu else []))
        else:
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


class PartialChannel(nn.Module):
    """The reference's PartialChannelOperation: the inner mixer ``attn`` on the first
    ``split`` channels (a channel slice of x, not a copy), the rest passed through.
    Returns the mixer's output and the whole map."""

    def __init__(self, attn: nn.Module, split: int):
        super().__init__()
        self.attn = attn
        self.split = split

    def forward(self, x: torch.Tensor):
        y1 = self.attn(x[:, : self.split])
        return y1, torch.cat([y1, x[:, self.split:]], dim=1)


class MetaNeXtBlockL(nn.Module):
    """``x = rep_mixer(x)`` (RepVGGDW), then ``x + drop_path(mlp(token_mixer(x)))``:
    the token mixer is a PartialChannel over the first ``dim // split_rate``
    channels whose ``attn`` is a RecAttn2d (LA1 at stage 0, LA2 after) or, from
    ``la3_from_stage``, a LinearAttention of variant 3. Every ConvNorm has a conv bias.

    Share-channel mode: a ``"collect"`` block returns its mixer's output beside its
    own, ``(x, y1)``; a ``"share"`` block has no token mixer and takes ``shared``,
    the concatenated outputs of the ``split_rate`` blocks before it, and mixes
    ``x + shared``."""

    def __init__(self, dim: int, mlp_ratio: float, stage: int, num_heads: int = 2,
                 split_rate: int = 4, drop_path: float = 0.0, la3_from_stage: int = 3,
                 share: str = "off", attn_kernel: str = "elu", *, fused: bool = False):
        super().__init__()
        if share not in ("off", "collect", "share"):
            raise ValueError(f"share mode {share!r} is not one of off, collect, share")
        self.share = share
        self.rep_mixer = rep_vgg_dw(dim, fused=fused)
        if share != "share":
            split = dim // split_rate
            if stage >= la3_from_stage:
                attn = LinearAttention(split, num_heads, 3, attn_kernel, bias=True,
                                       fused=fused)
            else:
                attn = RecAttn2d(split, num_heads, la_variant=1 if stage == 0 else 2,
                                 kernel=attn_kernel, bias=True, fused=fused)
            self.token_mixer = PartialChannel(attn, split)
        self.channel_mixer = mlp(dim, int(dim * mlp_ratio), bias=True, fused=fused)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, shared: Optional[torch.Tensor] = None):
        x = self.rep_mixer(x)
        if self.share == "share":
            y = x + shared
        else:
            y1, y = self.token_mixer(x)
        x = x + self.drop_path(self.channel_mixer(y))
        return (x, y1) if self.share == "collect" else x


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


class DownsampleL(nn.Module):
    """L: a 5x5 stride-2 ConvNorm (groups gcd(cin, cout), a conv bias), then
    x + drop_path(mlp(x))."""

    def __init__(self, cin: int, cout: int, mlp_ratio: float, drop_path: float = 0.0, *,
                 fused: bool = False):
        super().__init__()
        self.token_mixer = conv_norm(cin, cout, 5, 2, 2, groups=math.gcd(cin, cout),
                                     bias=True, fused=fused)
        self.channel_mixer = mlp(cout, int(cout * mlp_ratio), bias=True, fused=fused)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.token_mixer(x)
        return x + self.drop_path(self.channel_mixer(x))


class Stage(nn.Module):
    def __init__(self, downsample: nn.Module | None, blocks: list):
        super().__init__()
        self.downsample = downsample if downsample is not None else nn.Identity()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``remat``: each block is recomputed in the backward (under grad). The L
        share-channel blocks carry their mixers' outputs across the stage
        (``x1s``: a share block takes their concatenation, then the list starts
        anew)."""
        x = self.downsample(x)
        remat = remat and torch.is_grad_enabled()
        x1s: List[torch.Tensor] = []
        for blk in self.blocks:
            share = getattr(blk, "share", "off")
            inputs = (x, torch.cat(x1s, dim=1)) if share == "share" else (x,)
            out = _checkpointed(blk, *inputs) if remat else blk(*inputs)
            if share == "collect":
                x, y1 = out
                x1s.append(y1)
            else:
                x = out
                if share == "share":
                    x1s = []
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


def _drop_path_rates(cfg: RecNextConfig) -> List[List[float]]:
    """Per-block drop-path rates: M/A a constant; L a linspace over the total depth,
    split by stage (``recnext_tpu/models/recnext.py:_drop_path_rates``)."""
    if cfg.family != "l":
        return [[cfg.drop_path] * d for d in cfg.depth]
    total = sum(cfg.depth)
    ramp = np.linspace(0.0, cfg.drop_path, total) if total > 1 else np.zeros(total)
    out, i = [], 0
    for d in cfg.depth:
        out.append([float(r) for r in ramp[i: i + d]])
        i += d
    return out


def _l_blocks(cfg: RecNextConfig, i: int, rates: List[float], fused: bool) -> list:
    """Stage i's MetaNeXtBlockL. The share-channel variant moves LA3 to stage 2, uses
    2 heads from stage 2 (LA3's one) and 1 before, and makes stage 3 its share stage:
    every (split_rate + 1)-th block shares, the others collect."""
    heads, la3_from, split = cfg.num_heads[i], 3, cfg.split_rates[i]
    if cfg.share_channel:
        heads, la3_from = (2 if i >= 2 else 1), 2
    blocks = []
    for j in range(cfg.depth[i]):
        share = "off"
        if cfg.share_channel and i >= 3:
            share = "share" if (j + 1) % (split + 1) == 0 else "collect"
        blocks.append(MetaNeXtBlockL(cfg.embed_dim[i], cfg.mlp_ratio[i], stage=i,
                                     num_heads=heads, split_rate=split, drop_path=rates[j],
                                     la3_from_stage=la3_from, share=share,
                                     attn_kernel=cfg.attn_kernel, fused=fused))
    return blocks


class RecNext(nn.Module):
    """Top-level backbone. ``forward`` gives logits, ``forward_features`` the final
    map, ``features`` the four stage maps [C2, C3, C4, C5] (the downstream API)."""

    def __init__(self, cfg: RecNextConfig, *, fused: bool = False):
        super().__init__()
        if cfg.family not in ("m", "a", "l"):
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        self.cfg = cfg
        self.stem = RecNextStem(cfg.in_chans, cfg.embed_dim[0], family=cfg.family,
                                final_gelu=cfg.family == "l" and cfg.depth[0] == 0,
                                fused=fused)
        rates = _drop_path_rates(cfg)
        stages = []
        for i, (dim, depth) in enumerate(zip(cfg.embed_dim, cfg.depth)):
            ratio = cfg.mlp_ratio[i]
            if i == 0:
                ds = None
            elif cfg.family == "l":
                # an empty stage's downsample takes rate 0, as the JAX package's does
                ds = DownsampleL(cfg.embed_dim[i - 1], dim, ratio,
                                 rates[i][0] if depth else 0.0, fused=fused)
            else:
                ds = Downsample(cfg.embed_dim[i - 1], ratio, fused=fused)
            if cfg.family == "l":
                blocks = _l_blocks(cfg, i, rates[i], fused)
            elif cfg.family == "m":
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
