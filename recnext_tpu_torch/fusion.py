"""BatchNorm fusion as a pure transform of a torch state dict.

``fuse_params(state_dict)`` of an unfused model returns the ``state_dict`` of the
same model built with ``fused=True``. The math is ``recnext_tpu/fusion.py``'s:

* ConvNorm ``X.conv`` + ``X.norm`` -> conv ``X``:
  w' = gamma/sqrt(var+eps) * w, b' = beta - gamma*mu/sqrt(var+eps) (+ folded conv bias);
* RepVGGDW ``X.lk`` + ``X.sk`` + identity -> one 3x3 depthwise conv ``X``: lk's
  fused kernel, plus sk's at the centre tap, plus 1 at the centre tap; bias
  lk's + sk's;
* NormLinear ``X.norm`` + ``X.linear``: the input-side BN folded into the linear;
* classifier ``P.head`` + ``P.head_dist``: both folded, then averaged into ``P``;
* a standalone BN (block and downsample ``norm``) is kept as a BN with the folded
  affine and identity statistics (mean 0, var 1-eps), as
  ``recnext_tpu/convert.py:flax_fused_to_torch`` writes it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

EPS = 1e-5  # torch.nn.BatchNorm default

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _bn_coeffs(sd: Mapping[str, torch.Tensor], p: str):
    # the square root in float64, rounded once: correctly rounded, as numpy's float32
    # one is (torch's vectorised float32 sqrt on the CPU is not, for ~1% of values),
    # so the fold gives the JAX package's bits
    w = sd[f"{p}.weight"] / torch.sqrt((sd[f"{p}.running_var"] + EPS).double()).float()
    return w, sd[f"{p}.bias"] - w * sd[f"{p}.running_mean"]


def _fold_linear(sd: Mapping[str, torch.Tensor], p: str):
    """NormLinear at prefix p -> (weight, bias) of one Linear."""
    w, b = _bn_coeffs(sd, f"{p}.norm")
    lin = sd[f"{p}.linear.weight"]  # (out, in)
    if lin.device.type == "cpu":  # numpy's product, so the bits are the JAX package's
        bias = torch.from_numpy(b.numpy() @ np.ascontiguousarray(lin.numpy().T))
    else:
        bias = lin @ b
    if f"{p}.linear.bias" in sd:
        bias = bias + sd[f"{p}.linear.bias"]
    return lin * w[None, :], bias


def fuse_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Unfused model state dict -> the fused model's state dict (fp32)."""
    sd = {k: (v.detach().float() if v.is_floating_point() else v.detach())
          for k, v in state_dict.items()}
    bns = sorted({k[: -len(".running_mean")] for k in sd if k.endswith(".running_mean")})
    out: Dict[str, torch.Tensor] = {}
    done = set()
    linears = []
    for bn in bns:
        parent = bn.rsplit(".", 1)[0] if bn.endswith(".norm") else None
        done.update(f"{bn}.{leaf}" for leaf in _BN_LEAVES)
        if parent is not None and f"{parent}.conv.weight" in sd:
            w, b = _bn_coeffs(sd, bn)
            out[f"{parent}.weight"] = sd[f"{parent}.conv.weight"] * w[:, None, None, None]
            if f"{parent}.conv.bias" in sd:
                b = b + w * sd[f"{parent}.conv.bias"]
            out[f"{parent}.bias"] = b
            done.update({f"{parent}.conv.weight", f"{parent}.conv.bias"})
        elif parent is not None and f"{parent}.linear.weight" in sd:
            linears.append(parent)
            done.update({f"{parent}.linear.weight", f"{parent}.linear.bias"})
        else:
            w, b = _bn_coeffs(sd, bn)
            out[f"{bn}.weight"], out[f"{bn}.bias"] = w, b
            out[f"{bn}.running_mean"] = torch.zeros_like(w)
            out[f"{bn}.running_var"] = torch.full_like(w, 1.0 - EPS)
            out[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    for p in linears:
        if p.endswith("_dist") and p[: -len("_dist")] in linears:
            continue  # averaged with its sibling below
        w, b = _fold_linear(sd, p)
        if f"{p}_dist" in linears:
            # dual classifier heads P.head + P.head_dist -> one averaged Linear P
            w2, b2 = _fold_linear(sd, f"{p}_dist")
            w, b = (w + w2) / 2, (b + b2) / 2
            p = p.rsplit(".", 1)[0]
        out[f"{p}.weight"], out[f"{p}.bias"] = w, b
    for k, v in sd.items():
        if k not in done:
            out[k] = v
    for p in sorted(k[: -len(".lk.weight")] for k in out if k.endswith(".lk.weight")):
        _fuse_repvggdw(out, p)
    return out


def _fuse_repvggdw(out: Dict[str, torch.Tensor], p: str) -> None:
    """RepVGGDW at prefix p, its lk (3x3) and sk (1x1) ConvNorms already folded:
    into one depthwise 3x3 conv p (``recnext_tpu/fusion.py:_fuse_repvggdw``)."""
    lk_w, lk_b = out.pop(f"{p}.lk.weight"), out.pop(f"{p}.lk.bias")
    sk_w, sk_b = out.pop(f"{p}.sk.weight"), out.pop(f"{p}.sk.bias")
    kernel = lk_w.clone()  # (C, 1, 3, 3)
    kernel[:, :, 1, 1] += sk_w[:, :, 0, 0]
    kernel[:, 0, 1, 1] += 1.0  # the identity branch
    out[f"{p}.weight"], out[f"{p}.bias"] = kernel, lk_b + sk_b


def _identity_bn(out: Dict[str, torch.Tensor], p: str, scale: torch.Tensor,
                 shift: torch.Tensor) -> None:
    """A BN at prefix p that computes scale * x + shift: running statistics mean 0,
    var 1 - eps, so that weight / sqrt(var + eps) is the weight exactly."""
    out[f"{p}.weight"], out[f"{p}.bias"] = scale, shift
    out[f"{p}.running_mean"] = torch.zeros_like(scale)
    out[f"{p}.running_var"] = torch.full_like(scale, 1.0 - EPS)
    out[f"{p}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def defuse_params(fused: Mapping[str, torch.Tensor],
                  template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse embedding of ``fuse_params``: a fused state dict -> the unfused
    model's, every folded BatchNorm back as an identity BN (weight 1, bias the fused
    bias, mean 0, var 1 - eps), so ``fuse_params(defuse_params(f, t)) == f`` and the
    unfused model computes the fused one's function: the warm start from a published
    fused archive (``recnext_tpu/fusion.py:defuse_params``). ``template`` (an unfused
    state dict) gives the structure only; values and shapes come from ``fused``, so a
    classifier whose class count changed is left for the warm start to drop. A key the
    fused dict lacks keeps the template's value."""
    fd = {k: (v.detach().float() if v.is_floating_point() else v.detach())
          for k, v in fused.items()}
    out: Dict[str, torch.Tensor] = {}
    for k, v in template.items():
        if k.endswith(".lk.norm.running_mean"):
            p = k[: -len(".lk.norm.running_mean")]
            if f"{p}.weight" in fd:
                _defuse_repvggdw(out, fd, template, p)
        elif k.endswith(".norm.running_mean"):
            parent = k[: -len(".norm.running_mean")]
            if f"{parent}.conv.weight" in template and f"{parent}.weight" in fd:
                # ConvNorm -> conv X.conv and an identity BN carrying the fused bias
                out[f"{parent}.conv.weight"] = fd[f"{parent}.weight"]
                if f"{parent}.conv.bias" in template:
                    out[f"{parent}.conv.bias"] = torch.zeros_like(fd[f"{parent}.bias"])
                bias = fd[f"{parent}.bias"]
                _identity_bn(out, f"{parent}.norm", torch.ones_like(bias), bias)
            elif f"{parent}.linear.weight" in template:
                # NormLinear; the dual heads P.head + P.head_dist both take the averaged
                # fused Linear P, which keeps the deployed function exactly
                src = parent if f"{parent}.weight" in fd else parent.rsplit(".", 1)[0]
                if f"{src}.weight" in fd:
                    w, b = fd[f"{src}.weight"], fd[f"{src}.bias"]
                    out[f"{parent}.linear.weight"], out[f"{parent}.linear.bias"] = w, b
                    feat = torch.zeros(w.shape[1], dtype=w.dtype)
                    _identity_bn(out, f"{parent}.norm", feat + 1.0, feat)
    for k, v in template.items():
        if k not in out:
            # a standalone BN (fused: already an identity-statistics affine), the
            # mixers' convs and every other leaf of the same name; else the template's
            out[k] = fd.get(k, v)
    return out


def _defuse_repvggdw(out: Dict[str, torch.Tensor], fd: Mapping[str, torch.Tensor],
                     template: Mapping[str, torch.Tensor], p: str) -> None:
    """A fused RepVGGDW conv p -> its lk and sk ConvNorms
    (``recnext_tpu/fusion.py:_defuse``): lk takes the kernel less the identity at the
    centre tap and an identity BN carrying the bias, sk a zero kernel and an
    identity BN with bias 0, both conv biases 0."""
    kernel, bias = fd[f"{p}.weight"].clone(), fd[f"{p}.bias"]
    kernel[:, 0, 1, 1] -= 1.0  # peel the identity branch back off
    zero = torch.zeros_like(bias)
    out[f"{p}.lk.conv.weight"] = kernel
    out[f"{p}.sk.conv.weight"] = torch.zeros_like(kernel[:, :, :1, :1])
    for br, shift in (("lk", bias), ("sk", zero)):
        if f"{p}.{br}.conv.bias" in template:
            out[f"{p}.{br}.conv.bias"] = zero
        _identity_bn(out, f"{p}.{br}.norm", zero + 1.0, shift)
