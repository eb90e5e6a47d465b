"""Finetune warm start: load the model weights only from a checkpoint.

Counterpart of ``recnext_tpu/train/finetune.py``: the reference's ``--finetune``
loads only the model weights (no optimizer, schedule or epoch), drops each leaf
whose shape differs from the new model's (the classifier on a class-count change),
keeps missing leaves at their init and ignores unexpected ones. It is the entry of
the 384^2 finetune recipe and of transfer learning.

Formats ``load_pretrained`` reads, all ``torch.load`` files (``.pth``, ``.pt``,
``.bin``):

* a raw reference state dict, bare or inside ``{"model": ...}``;
* this trainer's checkpoint (``{"epoch", "state": {"model", "ema", ...}}``): its
  EMA weights where it keeps them, as the JAX package takes a TrainState's;
* a BN-fused state dict (a published archive, ``export.py``): no ConvNorm keeps its
  BN, so it is embedded back through ``fusion.defuse_params``;
* the JAX package's ``.msgpack`` files (flax's ``msgpack_serialize``, read by the
  port's own decoder, ``utils/msgpack.py``): a ``{"params", "batch_stats"}`` tree, a
  JAX TrainState's tree (its EMA weights where it keeps them and ``ema``) or a fused
  ``{"params"}`` tree, converted by ``convert.py`` (the RecNext, MLLA or RegNetY
  rules, told apart by the tree's top-level module names).

Orbax directories raise, naming their ROADMAP item.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Dict, Mapping

import torch

from recnext_tpu_torch.fusion import defuse_params

CKPT_ITEM = "ROADMAP.md Queue 1 item 18 (orbax checkpoint directories)"


def warm_start(template: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor],
               log: Callable[[str], None] = print) -> Dict[str, torch.Tensor]:
    """``loaded`` merged into the keys and shapes of ``template`` (a state dict):
    leaves of the same shape come from ``loaded`` (in the template's dtype), leaves of
    another shape are dropped and keep the template's, missing leaves keep the
    template's, unexpected ones are ignored. Raises (SystemExit) where no leaf is
    shared."""
    merged: Dict[str, torch.Tensor] = {}
    dropped, missing = [], []
    for k, t in template.items():
        v = loaded.get(k)
        if v is None:
            missing.append(k)
            merged[k] = t
        elif tuple(v.shape) != tuple(t.shape):
            dropped.append(k)
            merged[k] = t
        else:
            merged[k] = v.detach().to(device=t.device, dtype=t.dtype)
    unexpected = [k for k in loaded if k not in template]
    for k in dropped:
        log(f"Removing key {k} from pretrained checkpoint (shape mismatch)")
    if missing:
        log(f"missing keys (kept at init): {missing[:8]}"
            + (f" ... +{len(missing) - 8} more" if len(missing) > 8 else ""))
    if unexpected:
        log(f"unexpected checkpoint keys (ignored): {unexpected[:8]}"
            + (f" ... +{len(unexpected) - 8} more" if len(unexpected) > 8 else ""))
    if not len(template) - len(dropped) - len(missing):
        raise SystemExit("--finetune checkpoint shares NO leaf with the model: wrong "
                         "model family or corrupted checkpoint")
    return merged


def is_raw_state_dict(sd: Mapping[str, torch.Tensor]) -> bool:
    """True for an unfused state dict: some BN named ``norm`` still sits beside its
    ``conv`` or ``linear`` (a ConvNorm or NormLinear). A fused one keeps only the
    standalone BNs, which have no such sibling."""
    for k in sd:
        if k.endswith(".norm.running_mean"):
            parent = k[: -len(".norm.running_mean")]
            if f"{parent}.conv.weight" in sd or f"{parent}.linear.weight" in sd:
                return True
    return False


def _jax_tree_to_state_dict(tree, path: str, log: Callable[[str], None],
                            ema: bool) -> Dict[str, torch.Tensor]:
    """A decoded JAX ``.msgpack`` tree -> the torch state dict (fused where the tree
    keeps no BatchNorm statistics), by ``recnext_tpu/train/finetune.py``'s reading of
    the same trees."""
    from recnext_tpu_torch.convert import (jax_fused_to_torch, jax_mlla_to_torch,
                                           jax_regnet_to_torch, jax_to_torch)

    if isinstance(tree, dict) and "params" not in tree and "model" in tree:
        tree = tree["model"]
    if not isinstance(tree, dict):
        raise SystemExit(f"unrecognized checkpoint layout at {path}")
    if ema and tree.get("ema_params") is not None:
        log("finetune checkpoint is a JAX train state: using EMA weights")
        variables = {"params": tree["ema_params"],
                     "batch_stats": tree.get("ema_batch_stats") or {}}
    elif "params" in tree:
        variables = {"params": tree["params"], "batch_stats": tree.get("batch_stats") or {}}
    else:
        raise SystemExit(f"unrecognized checkpoint layout at {path}")
    if not variables["batch_stats"]:
        return jax_fused_to_torch(variables["params"])
    top = set(variables["params"])
    if any(re.fullmatch(r"s\d+_b\d+|head_fc", k) for k in top):
        return jax_regnet_to_torch(variables)
    if any(re.fullmatch(r"layer\d+_(block\d+|down)", k) for k in top):
        return jax_mlla_to_torch(variables)
    return jax_to_torch(variables)


def read_weights(path: str, log: Callable[[str], None] = print,
                 ema: bool = True) -> Dict[str, torch.Tensor]:
    """The model weights a checkpoint file holds, as a flat state dict (fused or not):
    a bare state dict, ``{"model": ...}``, this trainer's checkpoint (its EMA
    weights where present and ``ema``), or a JAX ``.msgpack`` tree."""
    p = Path(path)
    if p.is_dir():
        raise NotImplementedError(f"checkpoint {path!r}: the JAX package's orbax "
                                  f"directories are not read by the port; see {CKPT_ITEM}")
    if p.suffix == ".msgpack":
        from recnext_tpu_torch.utils.msgpack import read_msgpack

        return _jax_tree_to_state_dict(read_msgpack(p), path, log, ema)
    if p.suffix not in (".pth", ".pt", ".bin"):
        raise SystemExit(f"unrecognized checkpoint {path}")
    ckpt = torch.load(p, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("state"), dict):
        state = ckpt["state"]
        sd = dict(state["model"])
        if ema and state.get("ema"):
            log("finetune checkpoint is a train state: using EMA weights")
            sd.update(state["ema"])
        return sd
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        return dict(ckpt["model"])
    if isinstance(ckpt, dict):
        return dict(ckpt)
    raise SystemExit(f"unrecognized checkpoint layout at {path}")


def load_pretrained(path: str, template: Mapping[str, torch.Tensor],
                    log: Callable[[str], None] = print) -> Dict[str, torch.Tensor]:
    """Read a weights-only checkpoint (the formats of the module docstring) and warm
    start ``template`` (the new model's state dict) from it."""
    sd = read_weights(path, log)
    if is_raw_state_dict(template) and not is_raw_state_dict(sd):
        log("finetune checkpoint is BN-fused: inverse-embedding (defuse_params)")
        sd = defuse_params(sd, template)
    return warm_start(template, sd, log=log)
