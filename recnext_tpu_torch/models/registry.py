"""Model registry: named variants -> RecNextConfig, and create_model().

The table is a copy of ``recnext_tpu/models/registry.py:MODEL_CONFIGS``. Drop-path
defaults apply only without distillation (the L family ramps them over its depth).
Every family of the table builds in this port: M, A and L.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from recnext_tpu_torch.device import resolve_device
from recnext_tpu_torch.models.recnext import RecNext, RecNextConfig, init_weights


def _m(name, embed_dim, depth, drop_path=0.0):
    return RecNextConfig(name=name, family="m", embed_dim=embed_dim, depth=depth,
                         mlp_ratio=(2, 2, 2, 2), drop_path=drop_path)


def _a(name, embed_dim, depth, mlp_ratio=2.0, drop_path=0.0):
    return RecNextConfig(name=name, family="a", embed_dim=embed_dim, depth=depth,
                         mlp_ratio=(mlp_ratio,) * 4, drop_path=drop_path)


def _l(name, embed_dim, depth, drop_path=0.0, share_channel=False):
    return RecNextConfig(name=name, family="l", embed_dim=embed_dim, depth=depth,
                         mlp_ratio=(2, 2, 2, 1.5), num_heads=(1, 1, 1, 2),
                         split_rates=(4, 4, 4, 4), drop_path=drop_path,
                         share_channel=share_channel)


# drop_path values are the *without-distillation* defaults; get_config zeroes them
# when distillation=True.
MODEL_CONFIGS = {
    "recnext_m0": _m("recnext_m0", (40, 80, 160, 320), (2, 2, 9, 1)),
    "recnext_m1": _m("recnext_m1", (48, 96, 192, 384), (3, 3, 15, 2)),
    "recnext_m2": _m("recnext_m2", (56, 112, 224, 448), (3, 3, 15, 2)),
    "recnext_m3": _m("recnext_m3", (64, 128, 256, 512), (3, 3, 13, 2)),
    "recnext_m4": _m("recnext_m4", (64, 128, 256, 512), (5, 5, 25, 4), drop_path=0.2),
    "recnext_m5": _m("recnext_m5", (80, 160, 320, 640), (7, 7, 35, 2), drop_path=0.3),
    "recnext_a0": _a("recnext_a0", (40, 80, 160, 320), (2, 2, 9, 1)),
    "recnext_a1": _a("recnext_a1", (48, 96, 192, 384), (3, 3, 15, 2)),
    "recnext_a2": _a("recnext_a2", (56, 112, 224, 448), (3, 3, 15, 2)),
    "recnext_a3": _a("recnext_a3", (64, 128, 256, 512), (3, 3, 13, 2), mlp_ratio=1.875),
    "recnext_a4": _a("recnext_a4", (64, 128, 256, 512), (5, 5, 25, 4), mlp_ratio=1.875, drop_path=0.2),
    "recnext_a5": _a("recnext_a5", (80, 160, 320, 640), (7, 7, 35, 2), mlp_ratio=1.875, drop_path=0.3),
    "recnext_t": _l("recnext_t", (64, 128, 256, 512), (0, 2, 8, 10)),
    "recnext_s": _l("recnext_s", (128, 256, 384, 512), (0, 2, 8, 10), drop_path=0.1),
    "recnext_b": _l("recnext_b", (128, 256, 384, 512), (2, 8, 8, 12), drop_path=0.2),
    "recnext_t_share_channel": _l("recnext_t_share_channel", (64, 128, 256, 512),
                                  (0, 2, 8, 10), share_channel=True),
    "recnext_s_share_channel": _l("recnext_s_share_channel", (128, 256, 384, 512),
                                  (0, 2, 8, 10), drop_path=0.1, share_channel=True),
    "recnext_b_share_channel": _l("recnext_b_share_channel", (128, 256, 384, 512),
                                  (2, 8, 8, 12), drop_path=0.2, share_channel=True),
}


def get_config(name: str, **overrides: Any) -> RecNextConfig:
    if name not in MODEL_CONFIGS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}")
    cfg = MODEL_CONFIGS[name]
    if overrides.get("distillation") and "drop_path" not in overrides:
        overrides["drop_path"] = 0.0
    return dataclasses.replace(cfg, **overrides)


def create_model(
    name: str,
    *,
    fused: bool = False,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
    generator: torch.Generator | None = None,
    **overrides: Any,
) -> RecNext:
    """Build a model on ``device`` (default: the GPU; raises without one), with
    weights drawn from ``generator`` (default: seed 0), in eval mode."""
    model = RecNext(get_config(name, **overrides), fused=fused)
    dev = resolve_device(device)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(device=dev, dtype=dtype).eval()


def list_models():
    return sorted(MODEL_CONFIGS)


def parse_kv_overrides(spec: str) -> dict:
    """CLI ``k=v,k2=v2`` RecNextConfig overrides (``recnext_tpu/models/registry.py``'s
    rule: values coerced int -> float -> bool -> str), and tuples written with ``:``
    (``embed_dim=16:32:64:128``). Unknown keys fail inside ``dataclasses.replace``."""
    def coerce(v: str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                continue
        return {"true": True, "false": False}.get(v.lower(), v)

    out: dict = {}
    for pair in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in pair:
            raise ValueError(f"--model-kwargs entry {pair!r} is not key=value")
        k, v = pair.split("=", 1)
        out[k] = tuple(coerce(x) for x in v.split(":")) if ":" in v else coerce(v)
    return out
