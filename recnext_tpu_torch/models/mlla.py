"""The MLLA graft family: RecConv2d or linear attention grafted into MLLA (the
Swin-style "Demystify Mamba in Vision" network), the reference's ablation models.

Counterpart of ``recnext_tpu/models/mlla.py`` in NCHW. Six models, nano and mini x
three variants:

* ``recconv``: GELU gate, the RecConv2d aggregator in nearest mode (hidden 2.5 dim),
  K1 on a CUDA tensor (K1′ under grad);
* ``recattn``: SiLU gate, a one-level attention pyramid whose attention is the RoPE
  form, plain PyTorch in fp32 (``ops/attention.py:linear_attention_rope_plain``);
* ``recattn_simple``: SiLU gate, the same pyramid with elu+1 linear attention, one K2
  launch (K2′ under grad).

The module tree is the reference PyTorch model's, so the state dict that
``recnext_tpu/convert.py:mlla_flax_to_torch`` (and ``convert.py:jax_mlla_to_torch``
here) emits loads with ``strict=True``: ``patch_embed.conv{1,2.0,2.1,3.0,3.1}.{conv,
norm}``, ``layers.{i}.blocks.{j}``, ``layers.{i}.downsample``, ``norm``, ``head``;
in a block ``cpe1``, ``norm1``, ``i_proj``, ``agg``, ``o_proj``, ``cpe2``, ``norm2``,
``mlp.fc1``/``mlp.fc2``; the attention aggregator ``agg.down.0`` (the stride-2
depthwise conv), ``agg.down.1.{qk,pe|lepe}`` and ``agg.conv``, the RecConv2d one
``agg.down`` and ``agg.convs.{i}``. The RoPE tables are non-persistent buffers (the
converters skip the reference's ``rope.rotations``).

Layout: a block's stream is a channels-last NCHW tensor (the stem's output is made
one), whose LayerNorms and Linears run on its (B, H, W, C) view without a copy; the
aggregator's half of ``i_proj``'s output is copied once, into contiguous NCHW for K1,
or channels-last for the attention pyramid, whose attention input (a quarter of the
size) is copied to the contiguous NCHW that K2 reads; a downsampling block's strided
conv runs on a contiguous NCHW copy (each choice measured on the H100 by
``tools/mlla_layouts.py``: PERF.md). A 256-input family: the attention pyramid needs
even stage sizes. No BatchNorm past the stem, so no fused form. ``attn_impl=
"blockdiag"`` (the JAX package's TPU layout of the same attention) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from recnext_tpu_torch.device import resolve_device
from recnext_tpu_torch.models.layers import ConvLayer, DropPath, LayerNorm, gelu
from recnext_tpu_torch.models.mixers import RecConv2dMixer
from recnext_tpu_torch.models.recnext import _checkpointed, init_weights
from recnext_tpu_torch.ops.attention import (
    feature_map,
    linear_attention_nchw,
    linear_attention_nchw_plain,
    linear_attention_rope_plain,
    rope_rotations,
)
from recnext_tpu_torch.ops.resize import resize

VARIANTS = ("recconv", "recattn", "recattn_simple")


@dataclasses.dataclass(frozen=True)
class MLLAConfig:
    name: str
    variant: str  # "recconv" | "recattn" | "recattn_simple"
    embed_dim: int = 48
    depths: Tuple[int, ...] = (2, 4, 8, 4)
    num_heads: Tuple[int, ...] = (2, 4, 8, 16)
    mlp_ratio: float = 4.0
    expansion_ratio: float = 2.5  # recconv; the attention variants use 2
    drop_path: float = 0.0
    num_classes: int = 1000
    img_size: int = 256
    # the JAX package's "blockdiag" is a TPU layout of the same attention: not ported
    attn_impl: str = "headbatch"


MLLA_CONFIGS = {
    f"mlla_{size}_{var}": MLLAConfig(
        name=f"mlla_{size}_{var}", variant=var,
        embed_dim=32 if size == "nano" else 48,
        depths=(2, 2, 4, 2) if size == "nano" else (2, 4, 8, 4),
        drop_path=0.0 if size == "nano" else 0.2,
        expansion_ratio=2.5 if var == "recconv" else 2.0,
    )
    for size in ("nano", "mini")
    for var in VARIANTS
}


class MLLAStem(nn.Module):
    """conv1 (stride 2) -> a residual pair of convs -> conv3 (stride 2, 4x wide, then
    a 1x1 projection): total stride 4."""

    def __init__(self, cin: int, embed_dim: int):
        super().__init__()
        d = embed_dim
        self.conv1 = ConvLayer(cin, d // 2, stride=2)
        self.conv2 = nn.Sequential(ConvLayer(d // 2, d // 2), ConvLayer(d // 2, d // 2, act=False))
        self.conv3 = nn.Sequential(ConvLayer(d // 2, d * 4, stride=2),
                                   ConvLayer(d * 4, d, kernel_size=1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        x = x + self.conv2(x)
        return self.conv3(x)


class RoPE(nn.Module):
    """The 2-D rotary tables of an h x w map with ``dim`` channels
    (``ops/attention.py:rope_rotations``): non-persistent fp32 buffers ``cos`` and
    ``sin`` that stay fp32 when the model is cast to another dtype."""

    def __init__(self, h: int, w: int, dim: int):
        super().__init__()
        cos, sin = rope_rotations(h, w, dim)
        self.register_buffer("cos", torch.from_numpy(cos), persistent=False)
        self.register_buffer("sin", torch.from_numpy(sin), persistent=False)

    def _apply(self, fn, recurse=True):
        tables = self.cos, self.sin
        super()._apply(fn, recurse)
        self.cos, self.sin = (t.to(self.cos.device) for t in tables)  # fp32 kept
        return self

    def tables(self, h: int, w: int):
        """The tables for an h x w map: the buffers at their own size, else computed."""
        if tuple(self.cos.shape[1:]) == (h, w):
            return self.cos, self.sin
        cos, sin = rope_rotations(h, w, 2 * int(self.cos.shape[0]))
        return tuple(torch.from_numpy(t).to(self.cos.device) for t in (cos, sin))


class MLLALinearAttention(nn.Module):
    """elu+1 linear attention over ``num_heads`` channel-major heads, v = x, plus a
    3x3 depthwise positional term: ``qk`` is a 1x1 conv with 2 groups (q from the
    first half of its outputs, k from the second). The simple form (``pe``) is one
    launch of K2 on a CUDA tensor (K2 and K2′ under grad); the RoPE form (``lepe``,
    ``rope``) rotates q and k in the numerator only, in plain fp32 PyTorch. x must be
    contiguous NCHW for the kernel."""

    def __init__(self, dim: int, num_heads: int, rope: bool = False, side: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.qk = nn.Conv2d(dim, dim * 2, 1, groups=2, bias=True)
        pe = nn.Conv2d(dim, dim, 3, padding=1, groups=dim, bias=True)
        if rope:
            self.lepe = pe
            self.rope = RoPE(side, side, dim)
        else:
            self.pe = pe

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._attend(x, linear_attention_nchw)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version on any device: the reference the kernel path is
        held against (the RoPE form has no kernel: the same as ``forward``)."""
        return self._attend(x, linear_attention_nchw_plain)

    def _attend(self, x: torch.Tensor, attention) -> torch.Tensor:
        qk = feature_map(self.qk(x), "elu")
        if hasattr(self, "rope"):
            cos, sin = self.rope.tables(int(x.shape[2]), int(x.shape[3]))
            return linear_attention_rope_plain(qk, x, self.num_heads, cos, sin) + self.lepe(x)
        return attention(qk, x, self.num_heads) + self.pe(x)


class MLLARecAttnAgg(nn.Module):
    """A one-level attention pyramid with plain convs (no BN):
    ``conv(x + nearest_up2(attn(down(x))))``, ``down`` the Sequential of a 5x5
    stride-2 depthwise conv with a bias and the attention. x comes channels-last:
    the 5x5 depthwise convs run on it there (cuDNN's channels-last depthwise kernels
    took a quarter of the NCHW ones' time at mlla_mini's shapes on the H100); the
    attention reads its quarter-size input as contiguous NCHW, one copy."""

    def __init__(self, dim: int, num_heads: int, rope: bool, side: int):
        super().__init__()
        self.down = nn.Sequential(
            nn.Conv2d(dim, dim, 5, 2, 2, groups=dim, bias=True),
            MLLALinearAttention(dim, num_heads, rope=rope, side=(side + 1) // 2))
        self.conv = nn.Conv2d(dim, dim, 5, 1, 2, groups=dim, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.down[1](self.down[0](x).contiguous())
        y = resize(y, (2 * int(y.shape[2]), 2 * int(y.shape[3])), mode="nearest")
        return self.conv(x + y.contiguous(memory_format=torch.channels_last))


class MLLAMlp(nn.Module):
    """fc1 -> erf-GELU -> fc2 on the last dimension (``mlp.fc1``, ``mlp.fc2``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> its (B, H, W, C) view."""
    return x.permute(0, 2, 3, 1)


def _planes(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> its (B, C, H, W) view."""
    return t.permute(0, 3, 1, 2)


class MLLABlock(nn.Module):
    """cpe1 (a residual unless downsampling: then stride 2 and twice the channels) ->
    LayerNorm -> i_proj into a gate g and a feature half -> o_proj(act(g) * agg(half))
    residual -> cpe2 residual -> LayerNorm -> MLP residual. The aggregator is level
    ``level`` RecConv2d (nearest, K1) or the attention pyramid at the block's plane
    size ``side``."""

    def __init__(self, variant: str, cin: int, level: int, num_heads: int, side: int, *,
                 mlp_ratio: float = 4.0, expansion_ratio: float = 2.5,
                 drop_path: float = 0.0, downsample: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown MLLA variant {variant!r}; one of {VARIANTS}")
        self.variant = variant
        stride = 2 if downsample else 1
        self.downsample = downsample
        dim = cin * stride
        self.cpe1 = nn.Conv2d(cin, dim, 5, stride, 2, groups=cin, bias=True)
        hidden = int(dim * expansion_ratio) if variant == "recconv" else dim * 2
        self.g_dim = hidden // 2
        self.norm1 = LayerNorm(dim)
        self.i_proj = nn.Linear(dim, hidden)
        side = (side + 1) // 2 if downsample else side
        if variant == "recconv":
            self.agg = RecConv2dMixer(hidden - self.g_dim, level, 5, mode="nearest")
        else:
            self.agg = MLLARecAttnAgg(hidden - self.g_dim, num_heads,
                                      rope=variant == "recattn", side=side)
        self.o_proj = nn.Conv2d(self.g_dim, dim, 1, bias=True)
        self.dp1 = DropPath(drop_path)
        self.cpe2 = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=True)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLLAMlp(dim, int(dim * mlp_ratio))
        self.dp2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            # cuDNN's strided conv with two outputs a group took 5x as long on the
            # channels-last stream as on contiguous NCHW at mlla_mini's shapes (H100)
            x = self.cpe1(x.contiguous()).contiguous(memory_format=torch.channels_last)
        else:
            x = x + self.cpe1(x)
        y = self.i_proj(self.norm1(_tokens(x)))
        g, feat = y[..., : self.g_dim], y[..., self.g_dim:]
        g = gelu(g) if self.variant == "recconv" else F.silu(g)
        # K1 reads contiguous NCHW; the attention pyramid's convs take channels-last
        fmt = torch.contiguous_format if self.variant == "recconv" else torch.channels_last
        agg = self.agg(_planes(feat).contiguous(memory_format=fmt))
        o = F.linear(g * _tokens(agg), self.o_proj.weight.flatten(1), self.o_proj.bias)
        x = x + self.dp1(_planes(o))
        x = x + self.cpe2(x)
        return x + self.dp2(_planes(self.mlp(self.norm2(_tokens(x)))))


class MLLALayer(nn.Module):
    """A stage: its blocks, then (except the last stage) a downsampling block."""

    def __init__(self, blocks: list, downsample: MLLABlock | None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        remat = remat and torch.is_grad_enabled()
        for blk in [*self.blocks, *([self.downsample] if self.downsample else [])]:
            x = _checkpointed(blk, x) if remat else blk(x)
        return x


def drop_path_rates(cfg: MLLAConfig):
    """Per stage: its blocks' rates (a linspace from 0 to ``drop_path`` over every
    block) and its downsampling block's, the stage's last rate."""
    dpr = np.linspace(0, cfg.drop_path, sum(cfg.depths))
    out, idx = [], 0
    for depth in cfg.depths:
        rates = [float(r) for r in dpr[idx: idx + depth]]
        idx += depth
        out.append((rates, rates[-1] if rates else 0.0))
    return out


class MLLA(nn.Module):
    """stem -> 4 stages -> fp32 mean pool -> fp32 LayerNorm -> Linear head.
    Stage i's blocks run at level 4 - i, its downsampling block at 4 - i - 1."""

    def __init__(self, cfg: MLLAConfig):
        super().__init__()
        if cfg.attn_impl != "headbatch":
            raise NotImplementedError(
                f"attn_impl={cfg.attn_impl!r}: the JAX package's blockdiag attention is a "
                "TPU layout of the same function (head-masked dense contractions over "
                "128-wide lanes); the port computes it head-batched only")
        self.cfg = cfg
        self.patch_embed = MLLAStem(3, cfg.embed_dim)
        side = cfg.img_size // 4
        dim = cfg.embed_dim
        layers = []
        n = len(cfg.depths)
        for i, ((rates, down_rate), depth) in enumerate(zip(drop_path_rates(cfg), cfg.depths)):
            common = dict(num_heads=cfg.num_heads[i], mlp_ratio=cfg.mlp_ratio,
                          expansion_ratio=cfg.expansion_ratio)
            blocks = [MLLABlock(cfg.variant, dim, 4 - i, side=side, drop_path=rates[j],
                                **common) for j in range(depth)]
            down = None
            if i < n - 1:
                down = MLLABlock(cfg.variant, dim, 4 - i - 1, side=side, drop_path=down_rate,
                                 downsample=True, **common)
                dim, side = dim * 2, (side + 1) // 2
            layers.append(MLLALayer(blocks, down))
        self.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(dim)
        self.head = nn.Linear(dim, cfg.num_classes) if cfg.num_classes > 0 else nn.Identity()

    def forward_features(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        x = self.patch_embed(x).contiguous(memory_format=torch.channels_last)
        for layer in self.layers:
            x = layer(x, remat)
        return x

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        x = self.norm(self.forward_features(x, remat).float().mean(dim=(2, 3)))
        if isinstance(self.head, nn.Linear):
            x = self.head(x.to(self.head.weight.dtype))
        return x


def create_mlla(name: str, *, device: str | torch.device | None = None,
                dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None,
                **overrides: Any) -> MLLA:
    """Build an MLLA model on ``device`` (default: the GPU; raises without one), with
    weights drawn from ``generator`` (default: seed 0), in eval mode."""
    if name not in MLLA_CONFIGS:
        raise KeyError(f"unknown MLLA model {name!r}; known: {sorted(MLLA_CONFIGS)}")
    model = MLLA(dataclasses.replace(MLLA_CONFIGS[name], **overrides))
    dev = resolve_device(device)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(device=dev, dtype=dtype).eval()
