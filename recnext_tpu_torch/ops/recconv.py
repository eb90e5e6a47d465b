"""RecConv2d: recursive multi-frequency depthwise convolution.

Build a ``level``-deep stride-2 depthwise-conv pyramid with one shared ``down``
kernel, then from the coarsest level upward compute
``acc = resize(conv_l(f_l + acc), prev_size)`` and finally ``conv_level(x + acc)``.
The receptive field grows as k * 2^level while parameters grow only (level+2)x.

``rec_conv2d`` is the plain PyTorch version (``F.conv2d`` with groups=C and the
PyTorch-exact resize of ``ops/resize.py``): the CPU path and the reference that
the CUDA kernel is held against. ``rec_conv2d_fused`` is the entry point the model
calls: on a CPU tensor it runs the plain version, on a CUDA tensor it launches the
hand-written kernel (``ops/cuda/recconv.py``) or raises.
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch

from recnext_tpu_torch.ops.conv import depthwise_conv2d
from recnext_tpu_torch.ops.resize import resize


def rec_conv2d(
    x: torch.Tensor,
    down_w: torch.Tensor,
    conv_ws: Sequence[torch.Tensor],
    down_b: torch.Tensor | None = None,
    conv_bs: Sequence[torch.Tensor | None] | None = None,
    *,
    level: int,
    mode: str = "bilinear",
) -> torch.Tensor:
    """Apply RecConv2d. x: NCHW; down_w/conv_ws: depthwise (C, 1, k, k).

    ``conv_ws`` has ``level+1`` kernels: convs[0] applies at the coarsest pyramid
    level, convs[level] is the final full-resolution conv.
    """
    if len(conv_ws) != level + 1:
        raise ValueError(f"expected {level + 1} conv kernels, got {len(conv_ws)}")
    if conv_bs is None:
        conv_bs = (None,) * (level + 1)
    pad = int(down_w.shape[-1]) // 2

    inp = x
    features: list[tuple[torch.Tensor, tuple[int, int]]] = []
    for _ in range(level):
        size = (int(x.shape[2]), int(x.shape[3]))
        x = depthwise_conv2d(x, down_w, down_b, stride=2, padding=pad)
        features.append((x, size))

    acc = None
    for lvl, (f, size) in enumerate(reversed(features)):
        h = f if acc is None else f + acc
        h = depthwise_conv2d(h, conv_ws[lvl], conv_bs[lvl], stride=1, padding=pad)
        acc = resize(h, size, mode=mode)

    out = inp if acc is None else inp + acc
    return depthwise_conv2d(out, conv_ws[level], conv_bs[level], stride=1, padding=pad)


_launch_lock = threading.Lock()


def rec_conv2d_fused(
    x: torch.Tensor,
    down_w: torch.Tensor,
    conv_ws: Sequence[torch.Tensor],
    down_b: torch.Tensor | None = None,
    conv_bs: Sequence[torch.Tensor | None] | None = None,
    *,
    level: int,
    mode: str = "bilinear",
) -> torch.Tensor:
    """RecConv2d in one kernel launch on the GPU; the plain version on the CPU.

    The kernel takes the M-family form only: bias-free, bilinear, f32 or bf16,
    contiguous NCHW. On a CUDA tensor anything else raises; there is no fallback.
    ``rec_conv2d_fused.launches`` counts kernel launches (and nothing else).
    """
    if x.device.type == "cpu":
        return rec_conv2d(x, down_w, conv_ws, down_b, conv_bs, level=level, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"rec_conv2d_fused: unsupported device {x.device}")
    if down_b is not None or any(b is not None for b in (conv_bs or ())):
        raise ValueError("rec_conv2d_fused: the CUDA kernel is bias-free")
    if mode != "bilinear":
        raise ValueError(f"rec_conv2d_fused: the CUDA kernel is bilinear only, got {mode!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, down_w, *conv_ws)):
        raise ValueError("rec_conv2d_fused: the CUDA kernel is forward-only: run the plain "
                         "version (the mixer's forward_plain) where a gradient is needed")
    from recnext_tpu_torch.ops.cuda.recconv import recconv_cuda

    y = recconv_cuda(x, down_w, conv_ws, level=level)
    with _launch_lock:
        rec_conv2d_fused.launches += 1
    return y


rec_conv2d_fused.launches = 0
