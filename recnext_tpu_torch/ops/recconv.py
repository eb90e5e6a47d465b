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
through the level kernel (``rec_conv2d_level``: ``csrc/recconv_level_bwd.cu:
recconv_level_kernel``, the peeled level's library beside its backward kernels).

Training goes through ``RecConv2dFunction``: its forward is ``rec_conv2d_fused``,
its backward ``rec_conv2d_backward`` (the backward kernel, ``ops/cuda/
recconv_bwd.py``, on a CUDA tensor; ``rec_conv2d_backward_plain``, autograd over
``rec_conv2d`` in fp32, on a CPU tensor). Where a plane's backward does not fit in
that kernel's shared memory, it peels outer levels first
(``rec_conv2d_peeled_backward``), chosen by shape before any launch; each peeled
level's gradient runs through three kernels of ``ops/cuda/recconv_level_bwd.py``
(``rec_conv2d_level_dgrad``, ``rec_conv2d_level_wgrad``, ``rec_conv2d_up_adjoint``).
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
    (``csrc/recconv_level_bwd.cu:recconv_level_kernel`` through
    ``ops/cuda/recconv.py:recconv_level_cuda``; ``rec_conv2d_level.launches`` counts
    it) or raises; on a CPU tensor it runs the plain ops."""
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
    counts its calls) or raises; a plane whose backward does not fit in the kernel's
    shared memory runs ``rec_conv2d_peeled_backward`` with the fewest peeled levels
    that let the kernel take the rest (``ops/cuda/recconv_bwd.py:
    levels_to_peel_backward``; ``rec_conv2d_backward.peeled`` counts those calls). On
    a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return rec_conv2d_backward_plain(x, down_w, conv_ws, g, level=level, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"rec_conv2d_backward: unsupported device {x.device}")
    from recnext_tpu_torch.ops.cuda.recconv_bwd import (
        levels_to_peel_backward,
        recconv_backward_cuda,
    )

    peel = levels_to_peel_backward(int(x.shape[2]), int(x.shape[3]), level,
                                   int(down_w.shape[-1]))
    if peel:
        with _launch_lock:
            rec_conv2d_backward.peeled += 1
        return rec_conv2d_peeled_backward(x, down_w, conv_ws, g, level=level, peel=peel,
                                          mode=mode)
    out = recconv_backward_cuda(x, down_w, conv_ws, g.contiguous(), level=level, mode=mode)
    with _launch_lock:
        rec_conv2d_backward.launches += 1
    return out


rec_conv2d_backward.launches = 0
rec_conv2d_backward.peeled = 0


def rec_conv2d_level_dgrad_plain(g, w, *, size, stride=1, add=None, out_dtype=torch.float32):
    """``rec_conv2d_level_dgrad``'s plain version, on any device: autograd over the
    depthwise conv in fp32."""
    n, c = int(g.shape[0]), int(g.shape[1])
    with torch.enable_grad():
        z = torch.zeros(n, c, *size, dtype=torch.float32, device=g.device, requires_grad=True)
        y = depthwise_conv2d(z, w.detach().float(), stride=stride,
                             padding=int(w.shape[-1]) // 2)
        (dz,) = torch.autograd.grad(y, [z], g.float())
    return (dz if add is None else dz + add.float()).to(out_dtype)


def rec_conv2d_level_dgrad(g, w, *, size, stride=1, add=None, out_dtype=torch.float32):
    """The input gradient of a peeled level's depthwise conv at ``stride`` (zero
    padding k/2) whose input is ``size`` = (H, W): conv^T(g), plus the fp32 fine-grid
    gradient ``add`` where given, in ``out_dtype``. On a CUDA tensor it launches
    ``recconv_level_dgrad_kernel`` (``rec_conv2d_level_dgrad.launches`` counts it) or
    raises; on a CPU tensor it runs the plain version."""
    if g.device.type == "cpu":
        return rec_conv2d_level_dgrad_plain(g, w, size=size, stride=stride, add=add,
                                            out_dtype=out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"rec_conv2d_level_dgrad: unsupported device {g.device}")
    from recnext_tpu_torch.ops.cuda.recconv_level_bwd import level_dgrad_cuda

    y = level_dgrad_cuda(g.contiguous(), w.float().contiguous(), size=size, stride=stride,
                         add=add, out_dtype=out_dtype)
    with _launch_lock:
        rec_conv2d_level_dgrad.launches += 1
    return y


rec_conv2d_level_dgrad.launches = 0


def rec_conv2d_level_wgrad_plain(x, g, *, k, stride=1, up=None, mode="bilinear"):
    """``rec_conv2d_level_wgrad``'s plain version, on any device: autograd over
    ``rec_conv2d_level_plain`` in fp32."""
    c = int(x.shape[1])
    with torch.enable_grad():
        w = torch.zeros(c, 1, k, k, dtype=torch.float32, device=x.device, requires_grad=True)
        y = rec_conv2d_level_plain(x.detach().float(), w, stride=stride, up=up, mode=mode)
        (dw,) = torch.autograd.grad(y, [w], g.float())
    return dw


def rec_conv2d_level_wgrad(x, g, *, k, stride=1, up=None, mode="bilinear"):
    """The weight gradient (C, 1, k, k) fp32 of a peeled level
    ``conv(x + resize(up, size(x)), w)`` at ``stride`` for its output gradient g. On a
    CUDA tensor it launches ``recconv_level_wgrad_kernel`` and the sum over its tiles
    (``rec_conv2d_level_wgrad.launches`` counts one a call) or raises; on a CPU tensor
    it runs the plain version."""
    if x.device.type == "cpu":
        return rec_conv2d_level_wgrad_plain(x, g, k=k, stride=stride, up=up, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"rec_conv2d_level_wgrad: unsupported device {x.device}")
    from recnext_tpu_torch.ops.cuda.recconv_level_bwd import level_wgrad_cuda

    dw = level_wgrad_cuda(x.contiguous(), g.contiguous(), k=k, stride=stride, up=up,
                          mode=mode)
    with _launch_lock:
        rec_conv2d_level_wgrad.launches += 1
    return dw


rec_conv2d_level_wgrad.launches = 0


def rec_conv2d_up_adjoint_plain(dz, *, mode="bilinear"):
    """``rec_conv2d_up_adjoint``'s plain version, on any device: autograd over
    ``ops/resize.py:resize`` in fp32."""
    n, c, h, w = (int(s) for s in dz.shape)
    with torch.enable_grad():
        u = torch.zeros(n, c, (h + 1) // 2, (w + 1) // 2, dtype=torch.float32,
                        device=dz.device, requires_grad=True)
        (du,) = torch.autograd.grad(resize(u, (h, w), mode=mode), [u], dz.float())
    return du


def rec_conv2d_up_adjoint(dz, *, mode="bilinear"):
    """The adjoint of the up-step (ceil(H/2), ceil(W/2)) -> (H, W) at dz, fp32. On a
    CUDA tensor it launches ``recconv_up_adjoint_kernel``
    (``rec_conv2d_up_adjoint.launches`` counts it) or raises; on a CPU tensor it runs
    the plain version."""
    if dz.device.type == "cpu":
        return rec_conv2d_up_adjoint_plain(dz, mode=mode)
    if dz.device.type != "cuda":
        raise ValueError(f"rec_conv2d_up_adjoint: unsupported device {dz.device}")
    from recnext_tpu_torch.ops.cuda.recconv_level_bwd import up_adjoint_cuda

    du = up_adjoint_cuda(dz.contiguous(), mode=mode)
    with _launch_lock:
        rec_conv2d_up_adjoint.launches += 1
    return du


rec_conv2d_up_adjoint.launches = 0


def rec_conv2d_level_backward_plain(x, w, g, *, stride=1, up=None, mode="bilinear",
                                    add=None, out_dtype=torch.float32):
    """``rec_conv2d_level_backward``'s plain version, on any device: autograd over
    ``rec_conv2d_level_plain`` in fp32."""
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_()
        wf = w.detach().float().requires_grad_()
        inputs = [xf, wf]
        if up is not None:
            inputs.append(up.detach().float().requires_grad_())
        y = rec_conv2d_level_plain(xf, wf, stride=stride, up=inputs[2] if up is not None
                                   else None, mode=mode)
        grads = torch.autograd.grad(y, inputs, g.float())
    dx = grads[0] if add is None else grads[0] + add.float()
    return dx.to(out_dtype), grads[1], grads[2] if up is not None else None


def rec_conv2d_level_backward(x, w, g, *, stride=1, up=None, mode="bilinear", add=None,
                              out_dtype=torch.float32):
    """The gradient of one peeled level ``y = conv(x + resize(up, size(x)), w)`` at
    ``stride``, given g = dL/dy: (dx in ``out_dtype``, plus ``add`` where given; dw
    fp32; d up fp32, or None without ``up``). On a CUDA tensor: dx by
    ``rec_conv2d_level_dgrad``, dw by ``rec_conv2d_level_wgrad``, d up by
    ``rec_conv2d_up_adjoint`` of dx (which must then be fp32); on a CPU tensor the plain
    version."""
    if x.device.type == "cpu":
        return rec_conv2d_level_backward_plain(x, w, g, stride=stride, up=up, mode=mode,
                                               add=add, out_dtype=out_dtype)
    k = int(w.shape[-1])
    size = (int(x.shape[2]), int(x.shape[3]))
    dx = rec_conv2d_level_dgrad(g, w, size=size, stride=stride, add=add, out_dtype=out_dtype)
    dw = rec_conv2d_level_wgrad(x, g, k=k, stride=stride, up=up, mode=mode)
    du = None if up is None else rec_conv2d_up_adjoint(dx, mode=mode)
    return dx, dw, du


def rec_conv2d_peeled_backward(x, down_w, conv_ws, g, *, level, peel, mode="bilinear"):
    """The gradient of ``rec_conv2d_peeled`` (bias-free RecConv2d) with its ``peel``
    outer levels unrolled, given g = dL/d out: (dx in x's dtype, d down_w fp32,
    [d conv_ws[i] fp32]). For the outer level, with d = down(x) and y =
    RecConv_{L-1}(d) recomputed in fp32 (``rec_conv2d_level``, ``rec_conv2d_fused``):

        dz = conv_L^T(g), dW_L = sum (x + up(y)) * g, dy = up^T(dz);
        (dd, dW_down, dW_0 .. dW_{L-1}) = the inner gradient at (d, dy);
        dx = dz + down^T(dd), dW_down += sum x *_2 dd.

    The inner gradient is this function one level in while levels stay to peel, then
    ``rec_conv2d_backward`` (the kernel on a CUDA tensor, the plain version on a CPU
    one) while the inner level is >= 1, and the level backward alone at level 0. Each
    step runs through its kernel on a CUDA tensor, its plain version on a CPU one."""
    if len(conv_ws) != level + 1:
        raise ValueError(f"expected {level + 1} conv kernels, got {len(conv_ws)}")
    if not 0 <= peel <= level:
        raise ValueError(f"peel {peel} not in 0..{level}")
    if level == 0:
        dx, dw, _ = rec_conv2d_level_backward(x, conv_ws[0], g, out_dtype=x.dtype)
        return dx, torch.zeros_like(down_w, dtype=torch.float32), [dw]
    if peel == 0:
        return rec_conv2d_backward(x, down_w, conv_ws, g, level=level, mode=mode)
    down_f = down_w.float()
    inner_ws = [c.float() for c in conv_ws[:level]]
    with torch.no_grad():
        d = rec_conv2d_level(x, down_f, stride=2)
        y = (rec_conv2d_level(d, inner_ws[0]) if level == 1 else
             rec_conv2d_fused(d, down_f, inner_ws, level=level - 1, mode=mode))
    dz, dw_l, dy = rec_conv2d_level_backward(x, conv_ws[level], g, up=y, mode=mode)
    dd, dw_down, dws = rec_conv2d_peeled_backward(d, down_f, inner_ws, dy, level=level - 1,
                                                  peel=peel - 1, mode=mode)
    dx, dw_down2, _ = rec_conv2d_level_backward(x, down_f, dd, stride=2, add=dz,
                                                out_dtype=x.dtype)
    return dx, dw_down + dw_down2, [*dws, dw_l]


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
