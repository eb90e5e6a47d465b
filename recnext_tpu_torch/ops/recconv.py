"""RecConv2d: recursive multi-frequency depthwise convolution.

Build a ``level``-deep stride-2 depthwise-conv pyramid with one shared ``down``
kernel, then from the coarsest level upward compute
``acc = resize(conv_l(f_l + acc), prev_size)`` and finally ``conv_level(x + acc)``.
The receptive field grows as k * 2^level while parameters grow only (level+2)x.

``rec_conv2d`` is the plain PyTorch version (``F.conv2d`` with groups=C and the
PyTorch-exact resize of ``ops/resize.py``): the CPU path and the reference that
the CUDA kernel is held against. ``rec_conv2d_fused`` is the entry point the model
calls: on a CPU tensor it runs the plain version, on a CUDA tensor it launches the
hand-written kernel (``ops/cuda/recconv.py``) or raises. Where a plane's pyramid
does not fit in the kernel's shared memory, it peels outer levels first
(``rec_conv2d_peeled``), chosen by shape before any launch; each peeled level runs
through the source's second kernel (``rec_conv2d_level``).

Training goes through ``RecConv2dFunction``: its forward is ``rec_conv2d_fused``,
its backward ``rec_conv2d_backward`` (the backward kernel, ``ops/cuda/
recconv_bwd.py``, on a CUDA tensor; ``rec_conv2d_backward_plain``, autograd over
``rec_conv2d`` in fp32, on a CPU tensor).
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

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


def rec_conv2d_level_plain(x, w, *, stride=1, up=None, mode="bilinear"):
    """``rec_conv2d_level``'s plain version, on any device."""
    z = x.float()
    if up is not None:
        z = z + resize(up.float(), (int(x.shape[2]), int(x.shape[3])), mode=mode)
    pad = int(w.shape[-1]) // 2
    y = depthwise_conv2d(z, w.float(), stride=stride, padding=pad)
    return y if stride == 2 else y.to(x.dtype)


_launch_lock = threading.Lock()


def rec_conv2d_level(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    up: torch.Tensor | None = None,
    mode: str = "bilinear",
) -> torch.Tensor:
    """One level of a peeled pyramid: ``conv(x + resize(up, size(x)), w)`` at
    ``stride`` (depthwise, bias-free, zero padding k/2), in fp32. Stride 2 (the down
    conv, whose result feeds the inner pyramid) returns fp32; stride 1 rounds once
    to x's dtype. On a CUDA tensor it launches the level kernel
    (``ops/cuda/recconv.py:recconv_level_cuda``; ``rec_conv2d_level.launches``
    counts it) or raises; on a CPU tensor it runs the plain ops."""
    if x.device.type == "cpu":
        return rec_conv2d_level_plain(x, w, stride=stride, up=up, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"rec_conv2d_level: unsupported device {x.device}")
    from recnext_tpu_torch.ops.cuda.recconv import recconv_level_cuda

    y = recconv_level_cuda(x, w, stride=stride, up=up, mode=mode)
    with _launch_lock:
        rec_conv2d_level.launches += 1
    return y


rec_conv2d_level.launches = 0


def rec_conv2d_peeled(
    x: torch.Tensor,
    down_w: torch.Tensor,
    conv_ws: Sequence[torch.Tensor],
    *,
    level: int,
    peel: int,
    mode: str = "bilinear",
    inner: Callable[..., torch.Tensor] | None = None,
) -> torch.Tensor:
    """Bias-free RecConv2d with its ``peel`` outer levels unrolled, by the recursion

        RecConv_L(x) = conv_L(x + up(RecConv_{L-1}(down(x)), size(x)))

    where RecConv_{L-1} takes convs[0 .. L-1] and RecConv_0 is conv_0 alone. Each
    peeled level is two ``rec_conv2d_level`` calls: the stride-2 conv into fp32, and,
    after the inner step, the resize, add and the level's conv, rounded once to x's
    dtype. The inner step at level ``level - peel`` is ``inner`` (the plain
    ``rec_conv2d`` by default, the kernel on the GPU) while that level is > 0. The
    same function as ``rec_conv2d``, in the same order of operations."""
    if len(conv_ws) != level + 1:
        raise ValueError(f"expected {level + 1} conv kernels, got {len(conv_ws)}")
    if not 0 <= peel <= level:
        raise ValueError(f"peel {peel} not in 0..{level}")
    if level == 0:
        return rec_conv2d_level(x, conv_ws[0])
    if peel == 0:
        return (inner or rec_conv2d)(x, down_w, conv_ws, level=level, mode=mode)
    d = rec_conv2d_level(x, down_w, stride=2)
    y = rec_conv2d_peeled(d, down_w, conv_ws[:level], level=level - 1, peel=peel - 1,
                          mode=mode, inner=inner)
    return rec_conv2d_level(x, conv_ws[level], up=y, mode=mode)


def _launch(x, down_w, conv_ws, *, level, mode):
    from recnext_tpu_torch.ops.cuda.recconv import recconv_cuda

    y = recconv_cuda(x, down_w, conv_ws, level=level, mode=mode)
    with _launch_lock:
        rec_conv2d_fused.launches += 1
    return y


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

    The kernel takes the M-family form: bias-free, bilinear or nearest, f32 or bf16,
    contiguous NCHW. On a CUDA tensor anything else raises; there is no fallback.
    Where a gradient is needed, the call goes through ``RecConv2dFunction`` (this
    kernel forward, the backward kernel's gradient). A
    plane whose pyramid does not fit in shared memory runs ``rec_conv2d_peeled``
    with the fewest peeled levels that let the kernel take the rest
    (``ops/cuda/recconv.py:levels_to_peel``), each peeled level two launches of the
    level kernel (``rec_conv2d_level``). ``rec_conv2d_fused.launches`` counts the
    pyramid kernel's launches (and nothing else), ``rec_conv2d_fused.peeled`` the
    calls that peeled levels.
    """
    if x.device.type == "cpu":
        return rec_conv2d(x, down_w, conv_ws, down_b, conv_bs, level=level, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"rec_conv2d_fused: unsupported device {x.device}")
    if down_b is not None or any(b is not None for b in (conv_bs or ())):
        raise ValueError("rec_conv2d_fused: the CUDA kernel is bias-free")
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"rec_conv2d_fused: the CUDA kernel is bilinear or nearest, "
                         f"got {mode!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, down_w, *conv_ws)):
        return RecConv2dFunction.apply(level, mode, x, down_w, *conv_ws)
    from recnext_tpu_torch.ops.cuda.recconv import levels_to_peel

    h, w, k = int(x.shape[2]), int(x.shape[3]), int(down_w.shape[-1])
    if levels_to_peel(h, w, level, k, x.element_size()) == 0:
        return _launch(x, down_w, conv_ws, level=level, mode=mode)
    # the peeled route computes in fp32 (the kernel's inner plane too) and rounds once
    peel = levels_to_peel(h, w, level, k, 4)
    with _launch_lock:
        rec_conv2d_fused.peeled += 1
    return rec_conv2d_peeled(x, down_w.float(), [c.float() for c in conv_ws], level=level,
                             peel=peel, mode=mode, inner=_launch)


rec_conv2d_fused.launches = 0
rec_conv2d_fused.peeled = 0


def rec_conv2d_backward_plain(x, down_w, conv_ws, g, *, level, mode="bilinear"):
    """``rec_conv2d_backward``'s plain version, on any device: ``torch.autograd.grad``
    over the plain ``rec_conv2d`` in fp32. Returns (dx in x's dtype, d down_w fp32,
    [d conv_ws[i] fp32])."""
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_()
        ws = [w.detach().float().requires_grad_() for w in (down_w, *conv_ws)]
        y = rec_conv2d(xf, ws[0], ws[1:], level=level, mode=mode)
        grads = torch.autograd.grad(y, [xf, *ws], g.float())
    return grads[0].to(x.dtype), grads[1], list(grads[2:])


def rec_conv2d_backward(x, down_w, conv_ws, g, *, level, mode="bilinear"):
    """The gradient of bias-free ``rec_conv2d`` at x: given g = dL/dy, returns (dx in
    x's dtype, d down_w fp32, [d conv_ws[i] fp32]). On a CUDA tensor it launches the
    backward kernel (``ops/cuda/recconv_bwd.py``; ``rec_conv2d_backward.launches``
    counts its calls) or raises, also for planes too large for its shared memory;
    on a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return rec_conv2d_backward_plain(x, down_w, conv_ws, g, level=level, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"rec_conv2d_backward: unsupported device {x.device}")
    from recnext_tpu_torch.ops.cuda.recconv_bwd import recconv_backward_cuda

    out = recconv_backward_cuda(x, down_w, conv_ws, g.contiguous(), level=level, mode=mode)
    with _launch_lock:
        rec_conv2d_backward.launches += 1
    return out


rec_conv2d_backward.launches = 0


class RecConv2dFunction(torch.autograd.Function):
    """Bias-free RecConv2d with the kernels on both passes: the forward is
    ``rec_conv2d_fused`` (K1), the backward ``rec_conv2d_backward``. It saves only x
    and the weights; the backward recomputes the pyramid. The weights come in x's
    dtype: the Function does not cast them. The train step casts the fp32
    parameters to the compute dtype (``train/step.py:compute_params``), as the JAX
    model does; their gradients, computed in fp32, are rounded to that dtype,
    so they flow back through the caller's cast as JAX's autodiff does.

    ``apply(level, mode, x, down_w, *conv_ws)``."""

    @staticmethod
    def forward(ctx, level, mode, x, down_w, *conv_ws):
        if x.device.type == "cuda":
            from recnext_tpu_torch.ops.cuda.recconv_bwd import check_fits

            # a plane the backward cannot take raises before any launch
            check_fits(int(x.shape[2]), int(x.shape[3]), level, int(down_w.shape[-1]))
        ctx.level, ctx.mode = level, mode
        ctx.save_for_backward(x, down_w, *conv_ws)
        return rec_conv2d_fused(x, down_w, list(conv_ws), level=level, mode=mode)

    @staticmethod
    def backward(ctx, g):
        x, down_w, *conv_ws = ctx.saved_tensors
        dx, dd, dcs = rec_conv2d_backward(x, down_w, conv_ws, g, level=ctx.level,
                                          mode=ctx.mode)
        return (None, None, dx, dd.to(down_w.dtype),
                *(d.to(w.dtype) for d, w in zip(dcs, conv_ws)))
