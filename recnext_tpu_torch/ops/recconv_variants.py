"""The RecConv alternates: research variants of RecConv2d in eager PyTorch.

Counterparts of the alternates of ``recnext_tpu/ops/recconv.py`` (each the reference's
documented dead code or a README variant), in NCHW. Depthwise weights are
``(C, 1, k, k)``, grouped ones ``(out, in // groups, k, k)``, transposed-conv ones
PyTorch's ``ConvTranspose2d`` layout ``(in, out // groups, k, k)``. No registry model
uses them, so they run no kernel: ``ops/recconv.py`` re-exports them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from recnext_tpu_torch.ops.conv import conv2d, depthwise_conv2d
from recnext_tpu_torch.ops.resize import resize


def _size(x: torch.Tensor) -> tuple[int, int]:
    return int(x.shape[2]), int(x.shape[3])


def rec_conv2d_channel_split(
    x: torch.Tensor,
    down_ws: Sequence[torch.Tensor],
    conv_ws: Sequence[torch.Tensor],
    *,
    level: int,
    mode: str = "bilinear",
) -> torch.Tensor:
    """'Channel-split': at each level the first half of the channels is carried as a
    skip and the second half downsampled; the way up resizes and concatenates the
    skips back. ``down_ws`` widths C/2, C/4, ...; ``conv_ws[0]`` applies at the
    coarsest level (width C/2^level)."""
    if len(down_ws) != level or len(conv_ws) != level + 1:
        raise ValueError(f"level {level}: expected {level} down and {level + 1} conv kernels")
    k = int((down_ws[0] if level else conv_ws[0]).shape[-1])
    pad = k // 2
    skips = []
    for lvl in range(level):
        c = int(x.shape[1])
        r, x2 = x[:, : c // 2], x[:, c // 2:]
        x = depthwise_conv2d(x2, down_ws[lvl], stride=2, padding=pad)
        skips.append((r, _size(x2)))
    for lvl, (r, size) in enumerate(reversed(skips)):
        h = depthwise_conv2d(x, conv_ws[lvl], stride=1, padding=pad)
        x = torch.cat([r, resize(h, size, mode=mode)], dim=1)
    return depthwise_conv2d(x, conv_ws[level], stride=1, padding=pad)


def depthwise_conv_transpose2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2,
                               padding: int = 2) -> torch.Tensor:
    """Depthwise ``ConvTranspose2d``: w (C, 1, kt, kt); out = (in-1)*stride - 2p + kt."""
    return F.conv_transpose2d(x, w.to(x.dtype), stride=stride, padding=padding,
                              groups=int(w.shape[0]))


def grouped_conv_transpose2d(x: torch.Tensor, w: torch.Tensor, *, groups: int,
                             stride: int = 2, padding: int = 2) -> torch.Tensor:
    """Grouped ``ConvTranspose2d``: w (in, out // groups, kt, kt), outputs group-major."""
    return F.conv_transpose2d(x, w.to(x.dtype), stride=stride, padding=padding,
                              groups=groups)


def rec_conv2d_transpose_up(
    x: torch.Tensor,
    down_w: torch.Tensor,
    conv_ws: Sequence[torch.Tensor],
    up_w: torch.Tensor,
    *,
    level: int,
) -> torch.Tensor:
    """A learned depthwise ``ConvTranspose2d`` (``up_w`` (C, 1, k+1, k+1), stride 2)
    in place of the resize; planes whose side halves evenly at every level."""
    if len(conv_ws) != level + 1:
        raise ValueError(f"level {level}: expected {level + 1} conv kernels")
    pad = int(down_w.shape[-1]) // 2
    inp = x
    feats = []
    for _ in range(level):
        x = depthwise_conv2d(x, down_w, stride=2, padding=pad)
        feats.append(x)
    acc = None
    for lvl, f in enumerate(reversed(feats)):
        h = f if acc is None else f + acc
        h = depthwise_conv2d(h, conv_ws[lvl], stride=1, padding=pad)
        acc = depthwise_conv_transpose2d(h, up_w, stride=2, padding=pad)
    out = inp if acc is None else inp + acc
    return depthwise_conv2d(out, conv_ws[level], stride=1, padding=pad)


def rec_conv2d_maxpool(
    x: torch.Tensor,
    conv_ws: Sequence[torch.Tensor],
    *,
    level: int,
) -> torch.Tensor:
    """'Maxpool/unpool': a 2x2 stride-2 max pool keeps each window's argmax, and the
    way up puts a level's output back at that position (``max_unpool2d``), zeros
    elsewhere. No down kernel; even sides at every level."""
    if len(conv_ws) != level + 1:
        raise ValueError(f"level {level}: expected {level + 1} conv kernels")
    pad = int(conv_ws[0].shape[-1]) // 2
    inp = x
    feats = []
    for _ in range(level):
        size = _size(x)
        x, idx = F.max_pool2d(x, 2, 2, return_indices=True)
        feats.append((x, idx, size))
    acc = None
    for lvl, (f, idx, size) in enumerate(reversed(feats)):
        y = f if acc is None else f + acc
        y = depthwise_conv2d(y, conv_ws[lvl], stride=1, padding=pad)
        acc = F.max_unpool2d(y, idx, 2, 2, output_size=size)
    out = inp if acc is None else inp + acc
    return depthwise_conv2d(out, conv_ws[level], stride=1, padding=pad)


def rec_conv2d_group_down(
    x: torch.Tensor,
    down_ws: Sequence[torch.Tensor],
    conv_ws: Sequence[torch.Tensor],
    up_ws: Sequence[torch.Tensor],
    *,
    level: int,
) -> torch.Tensor:
    """'Variant A': stride-2 group convs of two inputs a group halve the channels on
    the way down (``down_ws[l]`` (C/2^(l+1), 2, k, k)); grouped transposed convs of
    two outputs a group double them back (``up_ws`` coarsest-first, (c, 2, k+1, k+1)
    for an input of c channels)."""
    if len(conv_ws) != level + 1 or not len(down_ws) == level == len(up_ws):
        raise ValueError(f"level {level}: expected {level} down, {level + 1} conv and "
                         f"{level} up kernels")
    pad = int(conv_ws[0].shape[-1]) // 2
    inp = x
    feats = []
    for lvl in range(level):
        x = conv2d(x, down_ws[lvl], stride=2, padding=pad, groups=int(down_ws[lvl].shape[0]))
        feats.append(x)
    acc = None
    for lvl, f in enumerate(reversed(feats)):
        y = f if acc is None else f + acc
        y = depthwise_conv2d(y, conv_ws[lvl], stride=1, padding=pad)
        acc = grouped_conv_transpose2d(y, up_ws[lvl], groups=int(y.shape[1]), stride=2,
                                       padding=pad)
    out = inp if acc is None else inp + acc
    return depthwise_conv2d(out, conv_ws[level], stride=1, padding=pad)


def rec_conv2d_split_transpose_up(
    x: torch.Tensor,
    down_ws: Sequence[torch.Tensor],
    conv_ws: Sequence[torch.Tensor],
    up_ws: Sequence[torch.Tensor],
    *,
    level: int,
) -> torch.Tensor:
    """'Variant B': a channel-split skip and a stride-2 depthwise downsample of the
    other half on the way down; a depthwise ``ConvTranspose2d`` and the concatenation
    with the skip on the way up."""
    if len(conv_ws) != level + 1 or not len(down_ws) == level == len(up_ws):
        raise ValueError(f"level {level}: expected {level} down, {level + 1} conv and "
                         f"{level} up kernels")
    pad = int(conv_ws[0].shape[-1]) // 2
    skips = []
    for lvl in range(level):
        c = int(x.shape[1])
        r, x2 = x[:, : c // 2], x[:, c // 2:]
        x = depthwise_conv2d(x2, down_ws[lvl], stride=2, padding=pad)
        skips.append(r)
    for lvl, r in enumerate(reversed(skips)):
        y = depthwise_conv2d(x, conv_ws[lvl], stride=1, padding=pad)
        y = depthwise_conv_transpose2d(y, up_ws[lvl], stride=2, padding=pad)
        x = torch.cat([r, y], dim=1)
    return depthwise_conv2d(x, conv_ws[level], stride=1, padding=pad)


def rec_conv2d_recurrent(
    x: torch.Tensor,
    n_w: torch.Tensor,
    b_w: torch.Tensor,
    c_w: torch.Tensor,
    d_w: torch.Tensor,
    a_w: torch.Tensor | None = None,
    *,
    level: int = 1,
    mode: str = "nearest",
) -> torch.Tensor:
    """'Recurrent aggregation' (the reference README's variant): five depthwise
    kernels shared across the levels, ``n`` the stride-2 downsample, ``b`` a level's
    feature, ``a`` the running aggregate (level >= 2), ``c`` and ``d`` the output pair:
    h = resize(b(f_L)); h = resize(a(h) + b(f_i)) upward; out = c(h) + d(x)."""
    if level > 1 and a_w is None:
        raise ValueError("a_w is required for level > 1")
    pad = int(n_w.shape[-1]) // 2
    fs = [x]
    for _ in range(level):
        fs.append(depthwise_conv2d(fs[-1], n_w, stride=2, padding=pad))
    h = None
    for i, o in reversed(list(zip(fs[1:], fs[:-1]))):
        hb = depthwise_conv2d(i, b_w, stride=1, padding=pad)
        h = hb if h is None else depthwise_conv2d(h, a_w, stride=1, padding=pad) + hb
        h = resize(h, _size(o), mode=mode)
    return (depthwise_conv2d(h, c_w, stride=1, padding=pad)
            + depthwise_conv2d(x, d_w, stride=1, padding=pad))
