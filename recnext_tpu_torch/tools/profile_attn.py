"""Attention similarity and timing: the linear-attention forms (kv-first, qk-first;
elu, softplus, relu feature maps) against each other and against softmax attention
(SDPA), by MSE, MAE, cosine, max difference and an allclose verdict, with
``--time`` each form's time on the card.

Counterpart of ``recnext_tpu/benchmark/profile_attn.py`` (the reference's
``lsnet/model/profile.py``). With ``--time`` it runs on the GPU unless
``--device cpu`` (K2, ``linear_attention_fused``, timed beside the plain forms);
the similarity runs on the CPU in fp32.

  python -m recnext_tpu_torch.tools.profile_attn --resolution 16 --dim 256 --heads 4 --time
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F


def similarity(a: np.ndarray, b: np.ndarray) -> dict:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    return {"mse": float(np.mean((a - b) ** 2)), "mae": float(np.mean(np.abs(a - b))),
            "cosine": cos, "max_diff": float(np.max(np.abs(a - b))),
            "allclose_1e-3": bool(np.allclose(a, b, atol=1e-3))}


def main(argv=None):
    from recnext_tpu_torch.ops.attention import (feature_map, linear_attention_fused,
                                                 linear_attention_kv_first,
                                                 linear_attention_qk_first)

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--resolution", type=int, default=16)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--time", action="store_true", help="also time each form")
    p.add_argument("--device", default=None, help="--time: default the GPU (cuda)")
    args = p.parse_args(argv)
    n = args.resolution ** 2
    d = args.dim // args.heads
    bh = args.batch * args.heads
    rng = np.random.default_rng(args.seed)
    x = rng.normal(size=(bh, n, d)).astype(np.float32)
    qk_raw = rng.normal(size=(bh, n, 2 * d)).astype(np.float32)
    v = torch.from_numpy(x)
    qr, kr = torch.from_numpy(qk_raw[..., :d]), torch.from_numpy(qk_raw[..., d:])
    results = {}
    with torch.no_grad():
        sdpa = F.scaled_dot_product_attention(qr, kr, v).numpy()  # the softmax baseline
        for kind in ("elu", "softplus", "relu"):
            q, k = feature_map(qr, kind), feature_map(kr, kind)
            kv = linear_attention_kv_first(q, k, v).numpy()
            results[f"kv_vs_qk[{kind}]"] = similarity(kv, linear_attention_qk_first(q, k, v))
            results[f"linear[{kind}]_vs_sdpa"] = similarity(kv, sdpa)
    if args.time:
        from recnext_tpu_torch.tools.micro import _device, card, timeit

        dev = _device(args.device)
        q, k = feature_map(qr, "elu").to(dev), feature_map(kr, "elu").to(dev)
        vd = v.to(dev)
        forms = [("kv_first", linear_attention_kv_first), ("qk_first", linear_attention_qk_first),
                 ("sdpa", F.scaled_dot_product_attention)]
        if dev.type == "cuda":
            forms.append(("kernel", linear_attention_fused))
        with torch.no_grad():
            for name, fn in forms:
                results[f"time_ms[{name}]"] = timeit(fn, q, k, vd, device=dev)
        results["device"] = card() if dev.type == "cuda" else "cpu"
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
