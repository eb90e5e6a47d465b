"""Weights carried across from the JAX package: its ``{params, batch_stats}``
trees (nested dicts of numpy arrays) -> the port's torch state dicts.

The port's own copy of the reverse converter in ``recnext_tpu/convert.py``
(``_flatten_tree``, ``_inv_path``, ``_inv_leaf``, ``_inv_transform``,
``flax_to_torch``, ``flax_fused_to_torch``), for the M, A and L families: flax
HWIO kernels become OIHW, Dense (in, out) kernels become Linear (out, in), and
paths are renamed to the reference module tree the port's models share.
``jax_regnet_to_torch`` does the same for the RegNetY teacher, into timm's names:
the inverse of ``recnext_tpu/convert.py:regnety_torch_to_flax``. ``jax_mlla_to_torch``
does it for the MLLA family, into the reference MLLA models' names: the port's copy
of the rules of ``recnext_tpu/convert.py:mlla_flax_to_torch`` (whose output it equals
key for key), written as a forward rewrite of each flax path. ``jax_task_to_torch``
does it for the downstream tasks' models (Semantic FPN, RetinaNet): their backbone
by the rules above, their neck and heads into the port's module names.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from recnext_tpu_torch.fusion import EPS

_STEM_INV = {"conv1": "0", "conv2": "2", "conv3": "4"}  # conv3: the L stem's
_BLOCK_RE = re.compile(r"stage(\d+)_block(\d+)")
_DS_RE = re.compile(r"downsample_(\d+)")
_CONVK_RE = re.compile(r"conv(\d+)_(kernel|bias)")
_DOWNKB_RE = re.compile(r"down_(kernel|bias)")
_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _inv_path(path: Tuple[str, ...]) -> Tuple[list, str]:
    """flax path tuple -> torch dotted tokens, plus the transform for the leaves
    the token rewrite itself resolves (RecConv ``convK_`` and ``down_`` leaves)."""
    toks: list = []
    tr = "id"
    for i, t in enumerate(path):
        prev = path[i - 1] if i else ""
        m = _BLOCK_RE.fullmatch(t)
        if m:
            toks += ["stages", m.group(1), "blocks", m.group(2)]
            continue
        m = _DS_RE.fullmatch(t)
        if m:
            toks += ["stages", m.group(1), "downsample"]
            continue
        if t == "stem" and i == 0:
            toks += ["stem", "stem"]
            continue
        if prev == "stem" and i == 1 and t in _STEM_INV:
            toks.append(_STEM_INV[t])
            continue
        if prev == "channel_mixer" and t in ("fc1", "fc2"):
            toks.append("0" if t == "fc1" else "2")
            continue
        m = _CONVK_RE.fullmatch(t)
        if m:
            toks += ["convs", m.group(1), "weight" if m.group(2) == "kernel" else "bias"]
            tr = "conv" if m.group(2) == "kernel" else "id"
            continue
        m = _DOWNKB_RE.fullmatch(t)
        if m:
            toks += ["down", "weight" if m.group(1) == "kernel" else "bias"]
            tr = "conv" if m.group(1) == "kernel" else "id"
            continue
        if t == "attn":
            # block-scope attn = L-series PartialChannelOperation(attn);
            # nested attn = LinearAttention at RecAttn2d down.1
            toks += (["token_mixer", "attn"] if _BLOCK_RE.fullmatch(prev)
                     else ["down", "1"])
            continue
        if t == "down":  # RecAttn2d's stride-2 ConvNorm
            toks += ["down", "0"]
            continue
        toks.append(t)
    return toks, tr


def _inv_leaf(path: Tuple[str, ...], fused: bool) -> Tuple[str, str]:
    """flax leaf path -> (torch key, transform)."""
    toks, tr = _inv_path(path)
    leaf, parent = path[-1], path[-2] if len(path) >= 2 else ""
    if _CONVK_RE.fullmatch(leaf) or _DOWNKB_RE.fullmatch(leaf):
        return ".".join(toks), tr
    if parent == "norm" and leaf in _NORM_LEAF:
        toks[-1] = _NORM_LEAF[leaf]
        return ".".join(toks), "id"
    if parent == "conv" and leaf in ("kernel", "bias"):
        name = "weight" if leaf == "kernel" else "bias"
        if fused:  # ConvNorm -> plain Conv2d: no inner .conv module
            toks[-2:] = [name]
        else:
            toks[-1] = name
        return ".".join(toks), "conv" if leaf == "kernel" else "id"
    if parent == "linear" and leaf in ("kernel", "bias"):
        name = "weight" if leaf == "kernel" else "bias"
        if fused and path[0] == "head":
            # fused single averaged classifier head -> plain Linear "head"
            return f"head.{name}", "linear" if leaf == "kernel" else "id"
        toks[-1] = name
        return ".".join(toks), "linear" if leaf == "kernel" else "id"
    if parent == "token_mixer" and leaf in ("kernel", "bias"):
        # Downsample's raw depthwise conv token mixer
        toks[-1] = "weight" if leaf == "kernel" else "bias"
        return ".".join(toks), "conv" if leaf == "kernel" else "id"
    raise KeyError(f"unmapped flax path: {'/'.join(path)}")


def _inv_transform(v: np.ndarray, tr: str) -> np.ndarray:
    if tr == "conv":
        return np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
    if tr == "linear":
        return np.transpose(v, (1, 0))
    return v


def _to_torch(out: Dict[str, np.ndarray], model: torch.nn.Module | None) -> Dict[str, torch.Tensor]:
    state = {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}
    if model is not None:
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in state.items()}
        if want != got:
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
            raise ValueError(f"state dict does not match the model: missing={missing[:5]} "
                             f"extra={extra[:5]} shape mismatch={shapes[:5]}")
    return state


def jax_to_torch(variables: Mapping[str, Any], model: torch.nn.Module | None = None
                 ) -> Dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` -> unfused torch state dict (fp32). With
    ``model``, check that keys and shapes are exactly its ``state_dict()``'s."""
    params = dict(variables.get("params", {}))
    stats = dict(variables.get("batch_stats", {}))
    if not params:
        raise ValueError("jax_to_torch expects {'params': ..., 'batch_stats': ...} "
                         "(got no 'params' collection)")
    out: Dict[str, np.ndarray] = {}
    for path, v in _flatten_tree(params).items():
        key, tr = _inv_leaf(path, fused=False)
        out[key] = _inv_transform(v.astype(np.float32), tr)
    for path, v in _flatten_tree(stats).items():
        key, _ = _inv_leaf(path, fused=False)
        out[key] = v.astype(np.float32)
        if path[-1] == "mean":  # torch BN buffers include num_batches_tracked
            out[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = np.zeros((), np.int64)
    return _to_torch(out, model)


def jax_fused_to_torch(params: Mapping[str, Any], model: torch.nn.Module | None = None
                       ) -> Dict[str, torch.Tensor]:
    """Fused JAX params (``recnext_tpu.fusion.fuse_params`` output) -> the fused
    torch state dict: plain convs and Linear, one classifier head, and each
    FusedAffine(scale, shift) as a standalone BN with weight=scale, bias=shift,
    running_mean=0, running_var=1-eps (exact under torch's eps=1e-5)."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    if not params:
        raise ValueError("jax_fused_to_torch got an empty params tree")
    flat = _flatten_tree(dict(params))
    out: Dict[str, np.ndarray] = {}
    for path, v in flat.items():
        if path[-2:] == ("norm", "shift"):
            continue  # handled with its scale sibling
        if path[-2:] == ("norm", "scale"):
            prefix = ".".join(_inv_path(path[:-1])[0])
            scale = v.astype(np.float32)
            out[f"{prefix}.weight"] = scale
            out[f"{prefix}.bias"] = flat[path[:-1] + ("shift",)].astype(np.float32)
            out[f"{prefix}.running_mean"] = np.zeros_like(scale)
            out[f"{prefix}.running_var"] = np.full_like(scale, 1.0 - EPS)
            out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
            continue
        key, tr = _inv_leaf(path, fused=True)
        out[key] = _inv_transform(v.astype(np.float32), tr)
    return _to_torch(out, model)


_REGNET_BLOCK_RE = re.compile(r"s(\d+)_b(\d+)")
_REGNET_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                   "var": "running_var"}


def _regnet_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """A JAX RegNetY leaf path -> (timm key, transform): ``s{i}_b{j}`` becomes
    ``s{i}.b{j}``, ``norm`` becomes ``bn``, ``head_fc`` becomes ``head.fc``."""
    toks: list = []
    for t in path[:-1]:
        m = _REGNET_BLOCK_RE.fullmatch(t)
        if m:
            toks += [f"s{m.group(1)}", f"b{m.group(2)}"]
        elif t == "norm":
            toks.append("bn")
        elif t == "head_fc":
            toks += ["head", "fc"]
        else:
            toks.append(t)
    leaf = path[-1]
    if toks[-1] == "bn" and leaf in _REGNET_BN_LEAF:
        return ".".join(toks + [_REGNET_BN_LEAF[leaf]]), "id"
    if leaf in ("kernel", "bias"):
        name = "weight" if leaf == "kernel" else "bias"
        tr = "id" if leaf == "bias" else ("linear" if path[0] == "head_fc" else "conv")
        return ".".join(toks + [name]), tr
    raise KeyError(f"unmapped RegNetY flax path: {'/'.join(path)}")


def jax_regnet_to_torch(variables: Mapping[str, Any], model: torch.nn.Module | None = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX RegNetY ``{params, batch_stats}`` -> the port's RegNetY state dict (fp32,
    timm's names). With ``model``, check that keys and shapes are exactly its
    ``state_dict()``'s."""
    params = dict(variables.get("params", {}))
    if not params:
        raise ValueError("jax_regnet_to_torch expects {'params': ..., 'batch_stats': ...} "
                         "(got no 'params' collection)")
    out: Dict[str, np.ndarray] = {}
    for path, v in _flatten_tree(params).items():
        key, tr = _regnet_key(path)
        out[key] = _inv_transform(v.astype(np.float32), tr)
    for path, v in _flatten_tree(dict(variables.get("batch_stats", {}))).items():
        key, _ = _regnet_key(path)
        out[key] = v.astype(np.float32)
        if path[-1] == "mean":  # torch BN buffers include num_batches_tracked
            out[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = np.zeros((), np.int64)
    return _to_torch(out, model)


_MLLA_BLOCK_RE = re.compile(r"layer(\d+)_(block(\d+)|down)")
_MLLA_STEM = {"conv1": "conv1", "conv2_0": "conv2.0", "conv2_1": "conv2.1",
              "conv3_0": "conv3.0", "conv3_1": "conv3.1"}
_MLLA_LINEAR = {"i_proj", "mlp_fc1", "mlp_fc2", "head"}
_LN_LEAF = {"scale": "weight", "bias": "bias"}


def _mlla_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """A JAX MLLA leaf path -> (the reference's torch key, transform)."""
    toks: list = []
    leaf = path[-1]
    for i, t in enumerate(path[:-1]):
        m = _MLLA_BLOCK_RE.fullmatch(t)
        if m:
            toks += ["layers", m.group(1)] + (["blocks", m.group(3)] if m.group(3)
                                              else ["downsample"])
        elif i == 0 and t == "stem":
            toks.append("patch_embed")
        elif path[0] == "stem" and i == 1:
            toks.append(_MLLA_STEM[t])
        elif t == "bn":  # a stem ConvLayer's BatchNorm
            toks.append("norm")
        elif t == "mlp_fc1" or t == "mlp_fc2":
            toks += ["mlp", t[4:]]
        elif t == "down" and path[i - 1] == "agg":  # the attention pyramid's s2 conv
            toks += ["down", "0"]
        elif t == "attn":
            toks += ["down", "1"]
        else:
            toks.append(t)
    m = _CONVK_RE.fullmatch(leaf)
    if m:  # the RecConv2d aggregator's level kernels
        return ".".join(toks + ["convs", m.group(1), "weight"]), "conv"
    if leaf == "down_kernel":
        return ".".join(toks + ["down", "weight"]), "conv"
    if path[-2] == "bn":
        return ".".join(toks + [_NORM_LEAF[leaf]]), "id"
    if path[-2] in ("norm1", "norm2", "norm"):
        return ".".join(toks + [_LN_LEAF[leaf]]), "id"
    name = {"kernel": "weight", "bias": "bias"}[leaf]
    tr = "id" if leaf == "bias" else ("linear" if path[-2] in _MLLA_LINEAR else "conv")
    return ".".join(toks + [name]), tr


def jax_mlla_to_torch(variables: Mapping[str, Any], model: torch.nn.Module | None = None
                      ) -> Dict[str, torch.Tensor]:
    """JAX MLLA ``{params, batch_stats}`` -> the reference's state dict (fp32), without
    the RoPE tables (the port's are non-persistent buffers). With ``model``, check that
    keys and shapes are exactly its ``state_dict()``'s."""
    params = dict(variables.get("params", {}))
    if not params:
        raise ValueError("jax_mlla_to_torch expects {'params': ..., 'batch_stats': ...} "
                         "(got no 'params' collection)")
    out: Dict[str, np.ndarray] = {}
    for path, v in _flatten_tree(params).items():
        key, tr = _mlla_key(path)
        out[key] = _inv_transform(v.astype(np.float32), tr)
    for path, v in _flatten_tree(dict(variables.get("batch_stats", {}))).items():
        key, _ = _mlla_key(path)
        out[key] = v.astype(np.float32)
        if path[-1] == "mean":  # torch BN buffers include num_batches_tracked
            out[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = np.zeros((), np.int64)
    return _to_torch(out, model)


_TASK_RULES = (  # a task model's flax module path -> the port's module path
    (re.compile(r"neck/lateral_(\d+)"), r"neck.lateral_convs.\1"),
    (re.compile(r"neck/fpn_(\d+)"), r"neck.fpn_convs.\1"),
    (re.compile(r"decode_head/scale(\d+)_conv(\d+)"), r"decode_head.scale_heads.\1.\2.conv"),
    (re.compile(r"decode_head/scale(\d+)_bn(\d+)"), r"decode_head.scale_heads.\1.\2.bn"),
    (re.compile(r"decode_head/conv_seg"), "decode_head.conv_seg"),
    (re.compile(r"head/cls_conv(\d+)"), r"head.cls_convs.\1"),
    (re.compile(r"head/reg_conv(\d+)"), r"head.reg_convs.\1"),
    (re.compile(r"head/cls_out"), "head.retina_cls"),
    (re.compile(r"head/reg_out"), "head.retina_reg"),
    (re.compile(r"rpn/(conv|cls|reg)"), r"rpn.\1"),
    (re.compile(r"box_head/(fc1|fc2|cls|reg)"), r"box_head.\1"),
    (re.compile(r"mask_head/conv(\d+)"), r"mask_head.convs.\1"),
    (re.compile(r"mask_head/(up|logits)"), r"mask_head.\1"),
)
_TASK_DENSE = re.compile(r"box_head/.*")  # flax Dense: (in, out) kernels
_TASK_LEAF = {"kernel": "weight", "bias": "bias"} | _NORM_LEAF


def _task_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """A task model's flax leaf path outside the backbone -> (torch key, transform)."""
    module = "/".join(p for p in path[:-1] if p != "extractor")
    prefix = "extractor." if path[0] == "extractor" else ""
    for pattern, repl in _TASK_RULES:
        if pattern.fullmatch(module):
            key = f"{prefix}{pattern.sub(repl, module)}.{_TASK_LEAF[path[-1]]}"
            if path[-1] != "kernel":
                return key, "id"
            return key, "linear" if _TASK_DENSE.fullmatch(module) else "conv"
    raise KeyError(f"unmapped task flax path: {'/'.join(path)}")


def jax_task_to_torch(variables: Mapping[str, Any], model: torch.nn.Module | None = None
                      ) -> Dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` of a ``SemanticFPN``, a ``RetinaNet`` or a
    ``MaskRCNN`` (``recnext_tpu/tasks/``) -> the port's state dict (fp32): the backbone
    subtree (``backbone`` or ``extractor/backbone``) through ``jax_to_torch``'s rules,
    under ``backbone.`` or ``extractor.backbone.``; the FPN's ``lateral_i``/``fpn_i``,
    the FPNHead's ``scale{i}_conv{r}``/``scale{i}_bn{r}``/``conv_seg``, the RetinaHead's
    ``cls_conv{i}``/``reg_conv{i}``/``cls_out``/``reg_out``, the RPN's
    ``conv``/``cls``/``reg`` and the mask head's ``conv{i}``/``up``/``logits`` (HWIO
    kernels to OIHW), and the box head's Dense ``fc1``/``fc2``/``cls``/``reg`` ((in,
    out) to (out, in): its RoIs are flattened channels-last on both sides) into the
    port's module names. With ``model``, check that keys and shapes are exactly its
    ``state_dict()``'s."""
    params = dict(variables.get("params", {}))
    stats = dict(variables.get("batch_stats", {}))
    if not params:
        raise ValueError("jax_task_to_torch expects {'params': ..., 'batch_stats': ...} "
                         "(got no 'params' collection)")
    inner = "extractor" if "extractor" in params else None

    def subtree(tree):
        return dict(tree.get(inner, {})).get("backbone", {}) if inner else tree.get("backbone", {})

    prefix = "extractor.backbone." if inner else "backbone."
    out: Dict[str, np.ndarray] = {}
    if subtree(params):
        backbone = jax_to_torch({"params": subtree(params), "batch_stats": subtree(stats)})
        out.update({prefix + k: v.numpy() for k, v in backbone.items()})
    for collection in (params, stats):
        for path, v in _flatten_tree(collection).items():
            if "backbone" in path:
                continue
            key, tr = _task_key(path)
            out[key] = _inv_transform(v.astype(np.float32), tr)
            if path[-1] == "mean":  # torch BN buffers include num_batches_tracked
                out[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = np.zeros((), np.int64)
    return _to_torch(out, model)
