"""The MAC crossover of the two linear-attention forms.

Counterpart of ``recnext_tpu/benchmark/flops_attn.py`` (the reference's
``mlla/flops_attn.py``): over the reference's five (dim, heads, resolution) combos,
the kv-first O(n·d²) and the qk-first O(n²·d) forms agree numerically, and the
kv-first form is the cheaper exactly where the sequence is longer than a head. MACs
come from the port's counter (``tools/roofline.py:analyze``: the matmuls' MACs; JAX
took XLA's cost analysis, which adds the elementwise ops). On the CPU, fp32.

  python -m recnext_tpu_torch.tools.flops_attn
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

# dim, num_heads, resolution: the reference's mlla/flops_attn.py
COMBOS = [(16, 2, 32), (64, 4, 16), (1024, 8, 8), (1024, 16, 8), (2048, 4, 4)]


def analyze(dim: int, num_heads: int, resolution: int, seed: int = 0) -> dict:
    from recnext_tpu_torch.ops.attention import (feature_map, linear_attention_kv_first,
                                                 linear_attention_qk_first)
    from recnext_tpu_torch.tools.roofline import analyze as count

    head_dim = dim // num_heads
    n = resolution * resolution
    rng = np.random.default_rng(seed)
    q = feature_map(torch.from_numpy(rng.standard_normal((num_heads, n, head_dim))).float())
    k = feature_map(torch.from_numpy(rng.standard_normal((num_heads, n, head_dim))).float())
    v = torch.from_numpy(rng.standard_normal((num_heads, n, head_dim))).float()
    with torch.no_grad():
        out1 = linear_attention_kv_first(q, k, v).numpy()
        out2 = linear_attention_qk_first(q, k, v).numpy()
        c1 = count(linear_attention_kv_first, q, k, v)
        c2 = count(linear_attention_qk_first, q, k, v)
    m1, m2 = c1["dense_macs"], c2["dense_macs"]
    return {"dim": dim, "num_heads": num_heads, "seq_len": n, "head_dim": head_dim,
            "kv_first_gmacs": m1 / 1e9, "qk_first_gmacs": m2 / 1e9,
            "allclose_1e-4": bool(np.allclose(out1, out2, atol=1e-4)),
            "kv_first_cheaper": bool(m1 <= m2)}


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    ok = True
    recs = []
    for dim, num_heads, resolution in COMBOS:
        rec = analyze(dim, num_heads, resolution)
        rec["crossover_ok"] = rec["kv_first_cheaper"] == (rec["seq_len"] > rec["head_dim"])
        ok &= rec["crossover_ok"] and rec["allclose_1e-4"]
        print(json.dumps(rec))
        recs.append(rec)
    if not ok:
        raise SystemExit("crossover or numeric-equivalence assertion failed")
    return recs


if __name__ == "__main__":
    main()
