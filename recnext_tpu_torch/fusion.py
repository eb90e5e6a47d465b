"""BatchNorm fusion as a pure transform of a torch state dict.

``fuse_params(state_dict)`` of an unfused model returns the ``state_dict`` of the
same model built with ``fused=True``. The math is ``recnext_tpu/fusion.py``'s:

* ConvNorm ``X.conv`` + ``X.norm`` -> conv ``X``:
  w' = gamma/sqrt(var+eps) * w, b' = beta - gamma*mu/sqrt(var+eps) (+ folded conv bias);
* NormLinear ``X.norm`` + ``X.linear``: the input-side BN folded into the linear;
* classifier ``P.head`` + ``P.head_dist``: both folded, then averaged into ``P``;
* a standalone BN (block and downsample ``norm``) is kept as a BN with the folded
  affine and identity statistics (mean 0, var 1-eps), as
  ``recnext_tpu/convert.py:flax_fused_to_torch`` writes it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

EPS = 1e-5  # torch.nn.BatchNorm default

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _bn_coeffs(sd: Mapping[str, torch.Tensor], p: str):
    w = sd[f"{p}.weight"] / torch.sqrt(sd[f"{p}.running_var"] + EPS)
    return w, sd[f"{p}.bias"] - w * sd[f"{p}.running_mean"]


def _fold_linear(sd: Mapping[str, torch.Tensor], p: str):
    """NormLinear at prefix p -> (weight, bias) of one Linear."""
    w, b = _bn_coeffs(sd, f"{p}.norm")
    lin = sd[f"{p}.linear.weight"]  # (out, in)
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
    return out
