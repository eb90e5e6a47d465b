"""The packed executor: g images folded into the channel axis of the BN-fused M and A
models, stage by stage, for inference.

Counterpart of ``recnext_tpu/models/packed_infer.py``. JAX packs g images into NHWC's
channel axis to fill the TPU's 128 lanes: ``concat([x[i::g] for i in range(g)], -1)``,
image g*b' + i in channel block i of row b'. In NCHW the same order is a free view,
``x.view(B // g, g * C, H, W)`` (``pack``; ``unpack`` is its inverse), so the port packs
and unpacks at no cost. What packing changes on the card:

* every per-channel operation does the same work in either layout: the depthwise convs
  (``groups=g*C``), K1's RecConv2d pyramid (one block per (n, c) plane), the kept
  BatchNorm, GELU and the biases take their parameters repeated g times
  (``Tensor.repeat``), built once, when the module is built;
* the 1x1 convs become g-group convs (``mlp_mode="grouped"``), or one block-diagonal
  dense conv (``"blockdiag"``, ``torch.block_diag``: the same products, summed in another
  order); the A family's qk conv becomes a 2g-group conv;
* the A family's attention runs K2 on the free (B, 2c, H, W) and (B, c, H, W) views of
  the packed qk and v, whose channels are ordered (g, 2, heads, D) per position: one
  launch over B * heads heads, the same as the unpacked model's
  (``_PackedAttention``);
* the stem, the downsamples and the head run unpacked, as JAX's (``ds_g = 1``).

``PackedRecNext`` is a ``RecNext`` whose stage i holds pack -> the blocks packed at
``groups[i]`` -> unpack, so ``RecNext.forward`` runs it; where a factor is 1 the stage's
blocks are the fused model's own. It launches K1 (M) or K2 (A) as often as the fused
model: 23 a forward for m1 and a1. The A family's attention is K2 over the batch's heads
(JAX's ``attn_impl="headbatch"``) and its upsample a gather (``ops/resize.py``); JAX's
``"blockdiag"`` attention and ``"matmul"`` upsample are TPU layouts of the same
functions, not ported (ROADMAP.md, Queue 1, "Not ported, on purpose").

``default_groups(cfg, batch)``: the per-stage factors of ``MEASURED_GROUPS``, a table of
tuples that beat the unpacked fused forward on an H100 in
``recnext_tpu_torch/tools/sweep_packing.py``'s sweep (PERF.md §6); a variant not in it
runs unpacked, (1, 1, 1, 1). A factor the batch does not divide is halved until it does.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from recnext_tpu_torch.models.mixers import LinearAttention
from recnext_tpu_torch.models.recnext import RecNext, RecNextConfig, Stage
from recnext_tpu_torch.ops.attention import feature_map, linear_attention_nchw

# per-stage factors that beat the unpacked fused forward (bf16, batch 256, 224^2) in
# tools/sweep_packing.py's sweep on an NVIDIA H100 80GB HBM3; none did for recnext_m1
# or recnext_a1 (PERF.md §6), so the table is empty and every variant runs unpacked
MEASURED_GROUPS: Dict[str, Tuple[int, ...]] = {}

MLP_MODES = ("grouped", "blockdiag")


def default_groups(cfg: RecNextConfig, batch: int) -> Tuple[int, ...]:
    """``MEASURED_GROUPS[cfg.name]``, or 1 at every stage for a variant not in it; each
    factor halved until it divides ``batch``."""
    out = []
    for g in MEASURED_GROUPS.get(cfg.name, (1,) * len(cfg.embed_dim)):
        while g > 1 and batch % g:
            g //= 2
        out.append(g)
    return tuple(out)


def pack(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, C, H, W) -> (B/g, g*C, H, W), a view: image g*b' + i in channel block i of
    row b' (JAX's ``pack`` order)."""
    if g == 1:
        return x
    b, c, h, w = x.shape
    if b % g:
        raise ValueError(f"a batch of {b} does not pack into groups of {g}")
    return x.view(b // g, g * c, h, w)


def unpack(z: torch.Tensor, g: int) -> torch.Tensor:
    """``pack``'s inverse, a view: (B/g, g*C, H, W) -> (B, C, H, W)."""
    if g == 1:
        return z
    b, c, h, w = z.shape
    return z.view(b * g, c // g, h, w)


class _Pack(nn.Module):
    def __init__(self, g: int):
        super().__init__()
        self.g = g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pack(x, self.g)


class _Unpack(_Pack):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return unpack(x, self.g)


def _tiled_conv(conv: nn.Conv2d, g: int) -> nn.Conv2d:
    """``conv`` on g packed images: g times its groups and channels, its weight and bias
    repeated g times along the output channels."""
    out = nn.utils.skip_init(
        nn.Conv2d, conv.in_channels * g, conv.out_channels * g, conv.kernel_size,
        conv.stride, conv.padding, conv.dilation, conv.groups * g, conv.bias is not None,
        device=conv.weight.device, dtype=conv.weight.dtype)
    with torch.no_grad():
        out.weight.copy_(conv.weight.repeat(g, 1, 1, 1))
        if conv.bias is not None:
            out.bias.copy_(conv.bias.repeat(g))
    return out


def _block_diagonal_conv(conv: nn.Conv2d, g: int) -> nn.Conv2d:
    """A dense 1x1 ``conv`` on g packed images as one dense conv whose weight is g
    copies of it on the diagonal (exact zeros elsewhere)."""
    if conv.groups != 1 or conv.kernel_size != (1, 1):
        raise ValueError(f"block-diagonal packing takes a dense 1x1 conv, not {conv}")
    out = nn.utils.skip_init(nn.Conv2d, conv.in_channels * g, conv.out_channels * g, 1,
                             bias=conv.bias is not None, device=conv.weight.device,
                             dtype=conv.weight.dtype)
    with torch.no_grad():
        out.weight.copy_(torch.block_diag(*[conv.weight[:, :, 0, 0]] * g)[:, :, None, None])
        if conv.bias is not None:
            out.bias.copy_(conv.bias.repeat(g))
    return out


def _tiled_norm(bn: nn.BatchNorm2d, g: int) -> nn.BatchNorm2d:
    """An eval-mode BatchNorm on g packed images: its affine and statistics repeated."""
    out = copy.deepcopy(bn)
    out.num_features = bn.num_features * g
    with torch.no_grad():
        for name in ("weight", "bias"):
            setattr(out, name, nn.Parameter(getattr(bn, name).repeat(g)))
        for name in ("running_mean", "running_var"):
            setattr(out, name, getattr(bn, name).repeat(g))
    return out


class _PackedAttention(nn.Module):
    """A ``LinearAttention`` (variant 1 or 2) on g packed images. The qk conv becomes a
    2g-group conv, so the packed qk holds, per position, image i's q and k in channel
    block i of 2c: (g, 2, heads, D). The NCHW entry splits q and k as the two halves of
    all channels, so it runs on the free views (B, 2c, H, W) and (B, c, H, W), where the
    halves are each image's q and k: one launch of K2 over B * heads heads (on a CPU
    tensor, the plain version of the attention's variant)."""

    def __init__(self, attn: LinearAttention, g: int):
        super().__init__()
        if attn.variant not in (1, 2):
            raise ValueError(f"packed attention takes variants 1 and 2, not {attn.variant}")
        self.g, self.num_heads, self.kernel = g, attn.num_heads, attn.kernel
        self.variant = attn.variant
        self.qk = _tiled_conv(attn.qk, g)
        self.pe = _tiled_conv(attn.pe, g)

    def attention(self, qk: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The attention of the feature-mapped packed ``qk`` and v = ``x``: the NCHW
        entry on the unpacked views, viewed back."""
        b, c, h, w = x.shape
        n, ci = b * self.g, c // self.g
        o = linear_attention_nchw(qk.view(n, 2 * ci, h, w), x.view(n, ci, h, w),
                                  self.num_heads, variant=self.variant)
        return o.view(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention(feature_map(self.qk(x), self.kernel), x) + self.pe(x)


def _pack_children(module: nn.Module, g: int, mlp_mode: str, in_mlp: bool = False) -> None:
    """Replace, in place, every conv, BatchNorm and LinearAttention under ``module`` by
    its form on g packed images; the channel mixer's 1x1 convs per ``mlp_mode``."""
    for name, child in module.named_children():
        mlp = in_mlp or name == "channel_mixer"
        if isinstance(child, LinearAttention):
            new = _PackedAttention(child, g)
        elif isinstance(child, nn.Conv2d):
            new = (_block_diagonal_conv if mlp and mlp_mode == "blockdiag" else _tiled_conv)(
                child, g)
        elif isinstance(child, nn.BatchNorm2d):
            new = _tiled_norm(child, g)
        else:
            _pack_children(child, g, mlp_mode, mlp)
            continue
        setattr(module, name, new)


def packed_block(block: nn.Module, g: int, mlp_mode: str = "grouped") -> nn.Module:
    """A fused MetaNeXtBlockM or MetaNeXtBlockA on g packed images: a copy whose
    forward is the block's own (``block`` itself where g is 1)."""
    if g == 1:
        return block
    out = copy.deepcopy(block)
    _pack_children(out, g, mlp_mode)
    return out


class PackedRecNext(RecNext):
    """A BN-fused M or A ``RecNext`` run with ``groups[i]`` images packed in stage i's
    blocks: stage i is pack -> ``packed_block``s -> unpack after the fused model's own
    downsample; stem and head are the fused model's. Inference only: it is built in eval
    mode (the fused model too, whose kept BatchNorms then normalise by their
    statistics), and computes the fused model's function for every batch that each
    factor divides."""

    def __init__(self, model: RecNext, groups: Sequence[int], *, mlp_mode: str = "grouped"):
        nn.Module.__init__(self)
        cfg = model.cfg
        if cfg.family not in ("m", "a"):
            raise ValueError(f"{cfg.name}: the packed executor runs the m and a families, "
                             f"not {cfg.family!r}")
        if not isinstance(model.head, (nn.Linear, nn.Identity)):
            raise ValueError(f"{cfg.name}: the packed executor takes the BN-fused model")
        if mlp_mode not in MLP_MODES:
            raise ValueError(f"mlp_mode {mlp_mode!r} is not one of {MLP_MODES}")
        groups = tuple(int(g) for g in groups)
        if len(groups) != len(cfg.embed_dim) or min(groups) < 1:
            raise ValueError(f"groups {groups}: one factor >= 1 for each of "
                             f"{len(cfg.embed_dim)} stages")
        self.cfg, self.frozen_stats, self.groups = cfg, False, groups
        self.stem, self.head = model.stem, model.head
        self.stages = nn.ModuleList(
            stage if g == 1 else Stage(stage.downsample, [
                _Pack(g), *(packed_block(b, g, mlp_mode) for b in stage.blocks), _Unpack(g)])
            for stage, g in zip(model.stages, groups))
        self.eval()


def packed_apply(model: RecNext, x: torch.Tensor, *, group: Optional[int] = None,
                 groups: Optional[Sequence[int]] = None,
                 mlp_mode: str = "grouped") -> torch.Tensor:
    """The fused ``model``'s logits on ``x`` through the packed executor: ``groups`` per
    stage, or ``group`` at every stage, or ``default_groups(model.cfg, len(x))``. Builds
    the packed weights on each call; ``PackedRecNext`` keeps them."""
    if group is not None:
        groups = (group,) * len(model.cfg.embed_dim)
    elif groups is None:
        groups = default_groups(model.cfg, x.shape[0])
    return PackedRecNext(model, groups, mlp_mode=mlp_mode)(x)
