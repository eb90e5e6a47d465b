"""Publishing: the BN-fused archive the server loads.

An archive is a directory holding ``<model>_fused.pt``, a ``torch.save`` of the
fused torch-layout state dict, and ``<model>_meta.json``. That is the layout
``python -m recnext_tpu.export --to-torch`` writes (a ``{"model": state_dict}``
wrapping is accepted too), so a model trained with the JAX package is served by
the port unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping

import torch

from recnext_tpu_torch.fusion import fuse_params
from recnext_tpu_torch.models.registry import get_config


def publish_fused(model_name: str, state_dict: Mapping[str, torch.Tensor],
                  out_path: str) -> Path:
    """Fuse an unfused model's state dict and write <out>/<model>_fused.pt + meta.json."""
    fused = {k: v.cpu() for k, v in fuse_params(state_dict).items()}
    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    f = out / f"{model_name}_fused.pt"
    torch.save(fused, f)
    cfg = get_config(model_name)
    (out / f"{model_name}_meta.json").write_text(json.dumps({
        "model": model_name, "family": cfg.family, "embed_dim": cfg.embed_dim,
        "depth": cfg.depth, "num_classes": cfg.num_classes, "fused": True,
    }, indent=2))
    return f


def resolve_published_path(model_name: str, path: str) -> Path:
    """Resolve an archive dir (or direct file path) to the published file, falling
    back to the newest sha-stamped ``<model>_fused-<sha8>.pt``."""
    p = Path(path)
    if p.is_dir():
        f = p / f"{model_name}_fused.pt"
        if not f.exists():
            # newest by mtime: the sha8 infix is content-derived, so a
            # lexicographic sort would pick an arbitrary one
            stamped = sorted(p.glob(f"{model_name}_fused-*.pt"),
                             key=lambda q: q.stat().st_mtime)
            if stamped:
                f = stamped[-1]
        p = f
    return p


def load_published(model_name: str, path: str) -> Dict[str, torch.Tensor]:
    """The fused state dict for ``create_model(model_name, fused=True)``, on the CPU."""
    state = torch.load(resolve_published_path(model_name, path), map_location="cpu",
                       weights_only=True)
    if set(state) == {"model"}:
        state = state["model"]
    return state
