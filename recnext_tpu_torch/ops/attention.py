"""Linear attention (positive feature map, mean-normalised), the A and L families' core.

Counterpart of ``recnext_tpu/ops/attention.py``. With q, k = feature_map(qk) and v:

* kv-first (O(n d^2)):  out = q @ ((k*s)^T (v*s)) / (q @ mean_n(k) + eps)
* qk-first (O(n^2 d)):  A = q k^T;  out = (A / (mean_row(A) + eps) * s) @ (v * s)

with s = n^-0.5. The two are the same function; the normaliser is computed in
fp32 (it is unstable in bf16). ``linear_attention_kv_first`` and ``_qk_first`` are
the plain versions in the JAX package's (BH, N, D) layout.

Two entry points launch the CUDA kernel (``ops/cuda/linear_attention.py``) on a
CUDA tensor and run the plain version on a CPU one:

* ``linear_attention_fused(q, k, v)``: the (BH, N, D) layout;
* ``linear_attention_nchw(qk, v, num_heads)``: the model's NCHW layout, qk
  (B, 2*nh*D, H, W) with q in the first half and k in the second, head h at
  channels [h*D, (h+1)*D) of each (the channel order of the JAX package's
  ``_split_qk_nhwc``), v (B, nh*DV, H, W), giving (B, nh*DV, H, W). The kernel
  reads these tensors in place.

The kernel takes each head's q, k, v and out as one contiguous span (a head's
channels of contiguous planes, or a (BH, N, D) head's rows) and raises on others.

``linear_attention_fused.launches`` counts the kernel's launches through either.
Under ``torch.export`` each entry is one node of a custom op
(``recnext::linear_attention``, ``recnext::linear_attention_nchw``) whose CUDA
kernel is the entry itself (the same launch, counted) and whose CPU kernel is the
plain version; eager calls do not pass through the ops' dispatch.
``linear_attention_blockdiag`` and ``linear_attention_blockdiag_rope`` (TPU
formulations of the same functions) are not ported.

The MLLA family's RoPE form (``recnext_tpu/models/mlla.py:MLLALinearAttention`` with
``rope=True``) is plain PyTorch in fp32 on every device, as the JAX package computes
it with einsums outside any Pallas kernel: ``rope_rotations`` (the tables),
``apply_rope`` and ``linear_attention_rope_plain``.

Training on the card goes through ``LinearAttentionFunction``: where a CUDA input
requires a gradient, both entries run it, its forward one launch of the kernel and
its backward one launch of the backward kernel (``linear_attention_backward``,
``ops/cuda/linear_attention_bwd.py``; its plain version
``linear_attention_backward_plain`` is autograd over ``linear_attention_kv_first`` in
fp32). On CPU tensors the entries return the plain version, which autograd
differentiates.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6


def linear_attention_kv_first(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              eps: float = EPS) -> torch.Tensor:
    """q, k: (B, n, d); v: (B, n, dv) -> (B, n, dv). B folds batch*heads. Products
    accumulate in fp32; kv is rounded to q's dtype for the second product."""
    n = q.shape[-2]
    s = float(n) ** -0.5
    kv = torch.einsum("bnd,bne->bde", (k * s).float(), (v * s).float())
    k_mean = k.float().mean(dim=-2)  # (B, d)
    denom = torch.einsum("bnd,bd->bn", q.float(), k_mean) + eps
    num = torch.einsum("bnd,bde->bne", q.float(), kv.to(q.dtype).float())
    return (num / denom[..., None]).to(v.dtype)


def linear_attention_qk_first(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              eps: float = EPS) -> torch.Tensor:
    """The quadratic-in-n form (the A family's last stage, where n is tiny)."""
    n = q.shape[-2]
    s = float(n) ** -0.5
    a = torch.einsum("bnd,bmd->bnm", q.float(), k.float())
    a = a / (a.mean(dim=-1, keepdim=True) + eps)
    out = torch.einsum("bnm,bme->bne", (a * s).to(v.dtype).float(), (v * s).float())
    return out.to(v.dtype)


def feature_map(x: torch.Tensor, kind: str = "elu") -> torch.Tensor:
    """Positive feature maps: elu(x)+1, softplus(beta=3.5), relu."""
    if kind == "elu":
        return F.elu(x) + 1.0
    if kind == "softplus":
        beta = 3.5
        return F.softplus(x * beta) / beta
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown feature map {kind!r}")


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, nh*D, H, W) -> (B*nh, N, D), a copy-free view where x's planes allow."""
    b, c, h, w = x.shape
    return x.reshape(b * num_heads, c // num_heads, h * w).transpose(1, 2)


def _split_qk(qk: torch.Tensor, v: torch.Tensor, num_heads: int):
    c2, cv = int(qk.shape[1]), int(v.shape[1])
    if qk.dim() != 4 or v.dim() != 4 or c2 % (2 * num_heads) or cv % num_heads:
        raise ValueError(f"qk {tuple(qk.shape)} and v {tuple(v.shape)} do not split into "
                         f"{num_heads} heads")
    if qk.shape[0] != v.shape[0] or qk.shape[2:] != v.shape[2:]:
        raise ValueError(f"qk {tuple(qk.shape)} and v {tuple(v.shape)} differ in batch or size")
    return qk[:, : c2 // 2], qk[:, c2 // 2:]


def linear_attention_nchw_plain(qk: torch.Tensor, v: torch.Tensor, num_heads: int, *,
                                variant: int = 1, eps: float = EPS) -> torch.Tensor:
    """The plain version of the NCHW entry, on any device: variant 1 runs the
    kv-first form, variant 2 the qk-first form, as the JAX mixer does."""
    q, k = _split_qk(qk, v, num_heads)
    if variant not in (1, 2):
        raise ValueError(f"linear attention variant {variant}: the entry takes 1 "
                         "(kv-first) or 2 (qk-first; LinearAttention's variant 3 runs it)")
    fn = linear_attention_kv_first if variant == 1 else linear_attention_qk_first
    o = fn(_heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads), eps)
    return o.transpose(1, 2).reshape(v.shape)


def rope_rotations(h: int, w: int, dim: int, base: float = 10000.0):
    """2-D rotary tables of an h x w map with ``dim`` channels: (cos, sin), each
    (dim/2, h, w) float32, the angles computed in float64 and rounded once (the port's
    copy of ``recnext_tpu/models/mlla.py:rope_rotations``, channel-major). Pair j
    rotates by y * theta_j for j < dim/4 and by x * theta_{j - dim/4} above."""
    k_max = dim // 4
    theta = 1.0 / (base ** (np.arange(k_max) / k_max))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    angles = np.concatenate([ys[..., None] * theta, xs[..., None] * theta], axis=-1)
    angles = np.ascontiguousarray(angles.transpose(2, 0, 1))
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) rotated in fp32 as complex numbers on the channel pairs (2j,
    2j+1), by the (C/2, H, W) tables; returns fp32."""
    xf = x.float()
    re, im = xf[:, 0::2], xf[:, 1::2]
    out = torch.stack([re * cos - im * sin, re * sin + im * cos], dim=2)
    return out.reshape(xf.shape)


def linear_attention_rope_plain(qk: torch.Tensor, v: torch.Tensor, num_heads: int,
                                cos: torch.Tensor, sin: torch.Tensor,
                                eps: float = EPS) -> torch.Tensor:
    """MLLA's RoPE linear attention (``recnext_tpu/models/mlla.py:160-170``) on the
    NCHW entry's layout: qk (B, 2C, H, W) after the feature map, q its first half, k
    its second; v (B, C, H, W); channel-major heads. The rotated q and k enter the
    numerator, the un-rotated ones the normaliser; all in fp32, the output in v's
    dtype."""
    q, k = _split_qk(qk, v, num_heads)
    n = int(v.shape[2]) * int(v.shape[3])
    s = float(n) ** -0.5
    qrh, krh = (_heads(apply_rope(t, cos, sin), num_heads) for t in (q, k))
    qh, kh, vh = (_heads(t.float(), num_heads) for t in (q, k, v))
    kv = torch.einsum("bnd,bne->bde", krh * s, vh * s)
    num = torch.einsum("bnd,bde->bne", qrh, kv)
    denom = torch.einsum("bnd,bd->bn", qh, kh.mean(dim=-2)) + eps
    o = (num / denom[..., None]).to(v.dtype)
    return o.transpose(1, 2).reshape(v.shape)


_launch_lock = threading.Lock()


def _launch(q4, k4, v4, out4, eps):
    from recnext_tpu_torch.ops.cuda.linear_attention import linear_attention_cuda

    linear_attention_cuda(q4, k4, v4, out4, eps=eps)
    with _launch_lock:
        linear_attention_fused.launches += 1


def _check_device(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one (kernel)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _bh_views(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("linear_attention_fused: q, k, v must be (BH, N, D)")
    return q[:, None], k[:, None], v[:, None]


def _nchw_views(qk, v, num_heads):
    """(q, k, v) as (B, nh, N, D) views of the NCHW tensors (never a copy), and the
    function that views another (B, nh*R, H, W) tensor so."""
    q, k = _split_qk(qk, v, num_heads)
    b, _, h, w = v.shape

    def view(x):  # a dimension of size 1 may carry any stride
        if (w > 1 and x.stride(3) != 1) or (h > 1 and x.stride(2) != w):
            raise ValueError("linear_attention_nchw: each (H, W) plane must be contiguous")
        return x.view(b, num_heads, x.shape[1] // num_heads, h * w).transpose(2, 3)

    return view(q), view(k), view(v), view


def _bh_kernel(q, k, v, eps):
    q4, k4, v4 = _bh_views(q, k, v)
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(q4, k4, v4, out[:, None], eps)
    return out


def _nchw_kernel(qk, v, num_heads, eps):
    q4, k4, v4, view = _nchw_views(qk, v, num_heads)
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(q4, k4, v4, view(out), eps)
    return out


def linear_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           eps: float = EPS) -> torch.Tensor:
    """q, k: (BH, N, D); v: (BH, N, DV) -> (BH, N, DV). On a CUDA tensor one launch
    of the kernel (or a raise: there is no fallback), through
    ``LinearAttentionFunction`` where an input requires a gradient; on a CPU tensor
    the plain kv-first version. Each head's rows must be one contiguous span."""
    if torch.compiler.is_exporting():  # one graph node, recnext::linear_attention
        return torch.ops.recnext.linear_attention(q, k, v, eps)
    if _check_device(q, "linear_attention_fused"):
        return linear_attention_kv_first(q, k, v, eps)
    if _needs_grad(q, k, v):
        return LinearAttentionFunction.apply(0, eps, q, k, v)
    return _bh_kernel(q, k, v, eps)


linear_attention_fused.launches = 0


def linear_attention_nchw(qk: torch.Tensor, v: torch.Tensor, num_heads: int, *,
                          variant: int = 1, eps: float = EPS) -> torch.Tensor:
    """qk: (B, 2*nh*D, H, W) after the feature map; v: (B, nh*DV, H, W) ->
    (B, nh*DV, H, W). On a CUDA tensor both variants are one launch of the kernel,
    which reads q, k and v in place (each head's channels must be one contiguous
    span of planes) and writes a contiguous output, through
    ``LinearAttentionFunction`` where an input requires a gradient; on a CPU tensor
    the plain version of ``variant``."""
    if torch.compiler.is_exporting():  # one graph node, recnext::linear_attention_nchw
        return torch.ops.recnext.linear_attention_nchw(qk, v, num_heads, variant, eps)
    if _check_device(qk, "linear_attention_nchw"):
        return linear_attention_nchw_plain(qk, v, num_heads, variant=variant, eps=eps)
    if variant not in (1, 2):
        raise ValueError(f"linear attention variant {variant}: the entry takes 1 "
                         "(kv-first) or 2 (qk-first; LinearAttention's variant 3 runs it)")
    if _needs_grad(qk, v):
        return LinearAttentionFunction.apply(num_heads, eps, qk, v)
    return _nchw_kernel(qk, v, num_heads, eps)


def linear_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    g: torch.Tensor, eps: float = EPS):
    """``linear_attention_backward``'s plain version, on any device:
    ``torch.autograd.grad`` over ``linear_attention_kv_first`` in fp32 (where kv is
    not rounded, as in the kernel). Returns (dq, dk, dv) in the inputs' dtypes."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = linear_attention_kv_first(qf, kf, vf, eps)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), g.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_backward(q4, k4, v4, g4, dq4, dk4, dv4, eps):
    from recnext_tpu_torch.ops.cuda.linear_attention_bwd import linear_attention_backward_cuda

    linear_attention_backward_cuda(q4, k4, v4, g4, dq4, dk4, dv4, eps=eps)
    with _launch_lock:
        linear_attention_backward.launches += 1


def _one_span_per_head(views) -> bool:
    """Whether every head of each of ``views()``'s (B, H, N, R) views is one span,
    all in one order (False also where a view cannot be taken)."""
    from recnext_tpu_torch.ops.cuda.linear_attention import head_layout

    try:
        head_layout(*views())
    except ValueError:
        return False
    return True


def linear_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              g: torch.Tensor, eps: float = EPS):
    """The gradient of the kv-first function at q, k: (BH, N, D), v: (BH, N, DV),
    given g = dL/dout (BH, N, DV): (dq, dk, dv) in the inputs' dtype. On a CUDA tensor
    one launch of the backward kernel (``linear_attention_backward.launches`` counts
    them) or a raise; on a CPU tensor the plain version."""
    if _check_device(q, "linear_attention_backward"):
        return linear_attention_backward_plain(q, k, v, g, eps)
    if not _one_span_per_head(lambda: [t[:, None] for t in (q, k, v, g)]):
        g = torch.empty_like(v).copy_(g)  # the kernel reads each head of g as one span
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))  # in the inputs' order
    _launch_backward(*(t[:, None] for t in (q, k, v, g, dq, dk, dv)), eps)
    return dq, dk, dv


linear_attention_backward.launches = 0


def linear_attention_nchw_backward(qk: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                                   num_heads: int, eps: float = EPS):
    """The gradient of ``linear_attention_nchw`` at (qk, v) given g = dL/dout (B,
    nh*DV, H, W): (dqk, dv), dqk one (B, 2*nh*D, H, W) tensor holding dq and dk. One
    launch of the backward kernel on CUDA tensors; anything else raises."""
    q4, k4, v4, view = _nchw_views(qk, v, num_heads)
    dqk = torch.empty(qk.shape, dtype=qk.dtype, device=qk.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dq4, dk4, dv4, _ = _nchw_views(dqk, dv, num_heads)
    if not _one_span_per_head(lambda: (q4, k4, v4, view(g))):
        g = g.contiguous()  # the kernel reads each head of g as one span of planes
    _launch_backward(q4, k4, v4, view(g), dq4, dk4, dv4, eps)
    return dqk, dv


class LinearAttentionFunction(torch.autograd.Function):
    """Linear attention with a kernel on both passes: the forward is one launch of
    K2 and the backward one launch of the backward kernel, which recomputes kv and
    the normaliser from the saved q, k, v (nothing else is saved). Both variants are
    the same function, so one Function serves them. It takes CUDA tensors only: the
    entries give CPU tensors the plain version, which autograd differentiates.

    ``apply(num_heads, eps, qk, v)`` for the NCHW entry (``linear_attention_nchw``;
    the gradient of qk is one tensor holding dq and dk), ``apply(0, eps, q, k, v)``
    for the (BH, N, D) entry (``linear_attention_fused``). The inputs come in one
    dtype, f32 or bf16; the gradients take it."""

    @staticmethod
    def forward(ctx, num_heads, eps, *ts):
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.save_for_backward(*ts)
        return _nchw_kernel(*ts, num_heads, eps) if num_heads else _bh_kernel(*ts, eps)

    @staticmethod
    def backward(ctx, g):
        ts = ctx.saved_tensors
        if ctx.num_heads:
            grads = linear_attention_nchw_backward(*ts, g, ctx.num_heads, ctx.eps)
        else:
            grads = linear_attention_backward(*ts, g, ctx.eps)
        return (None, None, *(d if need else None
                              for d, need in zip(grads, ctx.needs_input_grad[2:])))


# The two entries as custom ops, one node each of an exported program
# (``torch.export`` cannot trace a ctypes launch on raw pointers): the CUDA kernel is
# the entry (its launch counted), the CPU kernel the plain version. Each fake gives
# the output's shape, dtype and strides: a new contiguous tensor of v's shape, as the
# kernels write, whatever the strides of the inputs (the L family's v is a channel
# slice read in place).
@torch.library.custom_op("recnext::linear_attention", mutates_args=(), device_types="cuda",
                         schema="(Tensor q, Tensor k, Tensor v, float eps) -> Tensor")
def _linear_attention_op(q, k, v, eps):
    with torch.no_grad():  # the op has no gradient: never LinearAttentionFunction's
        return linear_attention_fused(q, k, v, eps)


@_linear_attention_op.register_kernel("cpu")
def _(q, k, v, eps):
    return linear_attention_kv_first(q, k, v, eps)


@_linear_attention_op.register_fake
def _(q, k, v, eps):
    return v.new_empty(v.shape)


@torch.library.custom_op("recnext::linear_attention_nchw", mutates_args=(),
                         device_types="cuda",
                         schema="(Tensor qk, Tensor v, int num_heads, int variant, float eps)"
                                " -> Tensor")
def _linear_attention_nchw_op(qk, v, num_heads, variant, eps):
    with torch.no_grad():
        return linear_attention_nchw(qk, v, num_heads, variant=variant, eps=eps)


@_linear_attention_nchw_op.register_kernel("cpu")
def _(qk, v, num_heads, variant, eps):
    return linear_attention_nchw_plain(qk, v, num_heads, variant=variant, eps=eps)


@_linear_attention_nchw_op.register_fake
def _(qk, v, num_heads, variant, eps):
    return v.new_empty(v.shape)
