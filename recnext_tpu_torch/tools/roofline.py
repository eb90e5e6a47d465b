"""Roofline of a model on the H100: how close a measured forward or train step comes
to the least time the card could take for the same work.

Counterpart of ``recnext_tpu/benchmark/roofline.py``. The JAX tool traced a jaxpr and
put every primitive on a TPU v5e engine (MXU, VPU); that engine model does not
transfer. Here the work is counted from the port's own aten ops, by a
``TorchDispatchMode`` (``OpCounter``, the counterpart of ``analyze_jaxpr``) around
the model's forward (or train step) on the CPU, on the plain path (every mixer
through ``forward_plain``: the same ops whatever implements them on the card), and
each op is put on an H100 engine:

* tensor cores (``tensor_*``; JAX's ``mxu_*``): dense contractions. ``mm``, ``addmm``,
  ``bmm``, ``baddbmm`` (einsums lower to these), and convolutions with more than one
  input channel a group: MACs = prod(out) * kh * kw * cin_per_group (``_conv_macs``).
  bf16 989 TFLOP/s dense = 494.5 T MAC/s; fp32 models run TF32, 495 TFLOP/s.
* CUDA cores (``cuda_core_*``; JAX's ``vpu_*``): depthwise convolutions (one input
  channel a group) and their input and filter gradients, plus every elementwise op:
  one op an output element (``_COSTLY`` weights for transcendentals and divides), a
  reduction one op an input element. fp32 67 TFLOP/s = 33.5 T FMA/s, one FMA or one
  elementwise op an issue slot: the port's depthwise kernels sum in fp32.
* HBM (``hbm_*``): the compulsory traffic, the input, the parameters and the output
  once each (the parameters once a batch; a train step: the parameters, their gradients, AdamW's two moments and
  the EMA copy read and written once, and the batch read), over 3.35 TB/s.

Data movement (views, copies, gathers, pads, concatenations) is free, as JAX's
``_FREE``. The bound is the largest of the three terms: each is a lower bound on the
work whatever fuses, so ``roofline_utilization_pct`` = bound / measured can never
read over 100. Two rules differ from JAX's: a depthwise conv's filter gradient stays
on the CUDA cores (JAX's ``_conv_macs`` reads it as dense once the batch exceeds 1,
because XLA lowers it to a conv whose input channels a group are the batch); a
composite aten op (GELU, ELU, BatchNorm, LayerNorm, softmax) counts the elementwise
ops of its JAX decomposition (``_COMPOSITE``).

Counts are taken at batch 1 (a train step at batches 2 and 4, extrapolated to
``batch``: the step's ops are affine in the batch), so they do not depend on the
device a model serves on, or on which kernel runs an op.

  python -m recnext_tpu_torch.tools.roofline --models recnext_m1 recnext_a1
  python -m recnext_tpu_torch.tools.roofline --results runs/bench_all.json
  python -m recnext_tpu_torch.tools.roofline --train --models recnext_m1 --batch 128
"""

from __future__ import annotations

import argparse
import contextlib
import json
from math import prod
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 SXM, 700 W, published peaks (dense)
TENSOR_BF16_MAC_PER_S = 494.5e12   # 989 TFLOP/s bf16
TENSOR_TF32_MAC_PER_S = 247.5e12   # 495 TFLOP/s TF32 (fp32 models)
CUDA_CORE_OP_PER_S = 33.5e12       # 67 TFLOP/s fp32 = 33.5 T FMA/s
HBM_BYTES_PER_S = 3.35e12

# data movement and bookkeeping: no arithmetic
_FREE = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand", "slice",
    "select", "index_select", "gather", "index", "cat", "stack", "constant_pad_nd", "pad",
    "clone", "copy", "copy_", "_to_copy", "to", "contiguous", "detach", "alias", "lift_fresh",
    "lift_fresh_copy", "unsqueeze", "squeeze", "split", "split_with_sizes", "unbind",
    "as_strided", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones",
    "new_full", "fill", "fill_", "zero_", "scalar_tensor", "arange", "where", "masked_fill",
    "masked_fill_", "flip", "roll", "repeat", "narrow", "unfold", "_reshape_alias",
    "upsample_nearest2d", "max_unpool2d", "scatter", "_local_scalar_dense", "set_",
    "randperm", "bernoulli", "bernoulli_", "uniform_", "normal_", "rand", "randn",
    "randint", "item", "is_nonzero", "resize_", "_index_put_impl_", "detach_",
    "diagonal", "tril", "triu", "one_hot", "eye", "linspace", "sort", "topk", "argsort",
}
# JAX's weights: transcendentals cost several ops, a divide or root two
_COSTLY = {"erf": 4, "erfc": 4, "exp": 4, "log": 4, "tanh": 4, "sigmoid": 4,
           "rsqrt": 2, "sqrt": 2, "div": 2, "reciprocal": 2, "pow": 8, "expm1": 4,
           "log1p": 4, "sin": 4, "cos": 4, "atan2": 4}
# composite aten ops: the ops of their JAX decomposition, per element of the tensor
# named by the rule ("out": the first output, "in": the first input)
_COMPOSITE = {
    "gelu": (7, "out"),                 # x * erfc(-x / sqrt2) / 2: neg, erfc, 2 mul
    "gelu_backward": (12, "out"),
    "elu": (3, "out"),                  # where(x > 0, x, expm1(x))
    "elu_backward": (3, "out"),
    "silu": (5, "out"), "silu_backward": (7, "out"),
    "hardswish": (4, "out"),
    "_softmax": (9, "in"), "_log_softmax": (8, "in"),
    "_softmax_backward_data": (4, "out"), "_log_softmax_backward_data": (6, "out"),
    "_native_batch_norm_legit_no_training": (2, "out"),  # a scale and a shift
    "_native_batch_norm_legit": (6, "in"),              # statistics, normalise, affine
    "native_batch_norm": (6, "in"),
    "native_batch_norm_backward": (8, "in"),
    "native_layer_norm": (7, "in"), "native_layer_norm_backward": (9, "in"),
    "max_pool2d_with_indices": (2, "in"),               # the max and its argmax
    "max_pool2d_with_indices_backward": (1, "out"),
    "linalg_vector_norm": (2, "in"),
    "var_mean": (3, "in"), "var": (3, "in"), "std": (3, "in"),
    "addcmul": (2, "out"), "addcmul_": (2, "out"), "addcdiv": (3, "out"), "addcdiv_": (3, "out"),
    "lerp": (2, "out"), "lerp_": (2, "out"),
    "mse_loss": (3, "in"), "smooth_l1_loss": (4, "in"),
    "binary_cross_entropy_with_logits": (12, "in"),
    "nll_loss_forward": (1, "out"), "nll_loss_backward": (1, "out"),
    "upsample_bilinear2d": (6, "out"), "upsample_bilinear2d_backward": (6, "in"),
    "upsample_nearest2d_backward": (1, "in"),
    "index_add": (1, "out"), "index_add_": (1, "out"), "scatter_add": (1, "out"),
    "scatter_add_": (1, "out"), "index_put": (1, "out"), "index_put_": (1, "out"),
    "embedding_bag": (2, "out"), "_embedding_bag": (2, "out"),
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
               "any", "all", "logsumexp", "cumsum", "norm", "count_nonzero"}
_MATMULS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "addmv", "addbmm", "_addmm_activation"}


def _numel(t) -> int:
    return int(t.numel()) if isinstance(t, torch.Tensor) else 0


def _conv_macs(out_numel: int, weight: torch.Tensor, transposed: bool,
               groups: int) -> tuple[float, bool]:
    """(MACs, is_depthwise) of a convolution: prod(out) * kh * kw * cin_per_group, as
    JAX's ``_conv_macs`` counts XLA's (a transposed conv as a conv of the stride-dilated
    input, zeros included)."""
    cin_pg = int(weight.shape[0]) // groups if transposed else int(weight.shape[1])
    k = prod(int(s) for s in weight.shape[2:])
    return float(out_numel * k * cin_pg), cin_pg == 1


class OpCounter(TorchDispatchMode):
    """Counts the work of the aten ops run under it: ``dense_macs`` (tensor cores),
    ``depthwise_macs`` and ``elementwise_ops`` (CUDA cores)."""

    def __init__(self):
        super().__init__()
        self.totals = {"dense_macs": 0.0, "depthwise_macs": 0.0, "elementwise_ops": 0.0}

    def _add(self, key, value):
        self.totals[key] += float(value)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count(func.overloadpacket.__name__, args, out)
        return out

    def count(self, name: str, args, out) -> None:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if name.startswith("_foreach_"):  # one op an element of every tensor of the list
            base = name[len("_foreach_"):].rstrip("_")
            weight = 0 if base in _FREE else _COSTLY.get(base, _COMPOSITE.get(base, (1,))[0])
            lists = outs or [t for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor)]
            self._add("elementwise_ops", weight * sum(_numel(t) for t in lists))
            return
        if name == "convolution":
            weight, bias, transposed, groups = args[1], args[2], args[6], args[8]
            macs, dw = _conv_macs(_numel(outs[0]), weight, bool(transposed), int(groups))
            self._add("depthwise_macs" if dw else "dense_macs", macs)
            if bias is not None:  # JAX adds the bias after the conv
                self._add("elementwise_ops", _numel(outs[0]))
            return
        if name == "convolution_backward":
            g, x, weight = args[0], args[1], args[2]
            transposed, groups, mask = bool(args[7]), int(args[9]), args[10]
            # a transposed conv's gradients are those of the conv it transposes, with
            # the roles of g and x exchanged
            fwd_out, fwd_in = (x, g) if transposed else (g, x)
            cin_pg = int(weight.shape[0]) // groups if transposed else int(weight.shape[1])
            cout_pg = int(weight.shape[1]) if transposed else int(weight.shape[0]) // groups
            k = prod(int(s) for s in weight.shape[2:])
            if mask[0]:  # input gradient: a conv of g (stride-dilated) producing x
                self._add("depthwise_macs" if cout_pg == 1 else "dense_macs",
                          _numel(fwd_in) * k * cout_pg)
            if mask[1]:  # filter gradient: the forward's MACs, on the forward's engine
                self._add("depthwise_macs" if cin_pg == 1 else "dense_macs",
                          _numel(fwd_out) * k * cin_pg)
            if mask[2]:
                self._add("elementwise_ops", _numel(g))
            return
        if name in _MATMULS:
            self._add("dense_macs", _matmul_macs(name, args))
            if name in ("addmm", "baddbmm", "addmv", "addbmm") and outs:
                self._add("elementwise_ops", _numel(outs[0]))
            return
        if not outs or name in _FREE:
            return
        if name in _COMPOSITE:
            weight, which = _COMPOSITE[name]
            ref = args[0] if which == "in" else outs[0]
            self._add("elementwise_ops", weight * _numel(ref))
            return
        if name in _REDUCTIONS or name.startswith("reduce"):
            self._add("elementwise_ops", _numel(args[0]))
            return
        # any other op: elementwise, one op an output element unless _COSTLY says more
        self._add("elementwise_ops", _numel(outs[0]) * _COSTLY.get(name.rstrip("_"), 1))


def _matmul_macs(name: str, args) -> float:
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm", "addmv", "addbmm", "_addmm_activation"):
        a, b = args[1], args[2]
    else:  # mv, dot
        a, b = args[0], args[1]
    if name in ("bmm", "baddbmm"):
        return float(a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2])
    if name == "addbmm":
        return float(a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2])
    if name in ("mv", "addmv"):
        return float(a.shape[0] * a.shape[1])
    if name == "dot":
        return float(a.shape[0])
    return float(a.shape[0] * a.shape[1] * b.shape[1])


def analyze(fn, *args, **kwargs) -> dict:
    """{dense_macs, depthwise_macs, elementwise_ops} of ``fn(*args, **kwargs)``: the
    counterpart of JAX's ``analyze_jaxpr``, over the aten ops the call runs."""
    counter = OpCounter()
    with counter:
        fn(*args, **kwargs)
    return dict(counter.totals)


@contextlib.contextmanager
def plain_mixers(model: torch.nn.Module):
    """Every mixer that has a kernel runs its plain version (``forward_plain``) inside:
    plain autograd in training, so a backward counts the gradient's own ops and not a
    kernel's recomputed forward."""
    mixers = [m for m in model.modules() if hasattr(m, "forward_plain")]
    for m in mixers:
        m.forward = m.forward_plain
    try:
        yield model
    finally:
        for m in mixers:
            m.__dict__.pop("forward", None)


def _engines(dense, depthwise, elementwise, hbm_bytes, tensor_rate):
    ms = {"tensor": dense / tensor_rate * 1e3,
          "cuda_core": (depthwise + elementwise) / CUDA_CORE_OP_PER_S * 1e3,
          "hbm": hbm_bytes / HBM_BYTES_PER_S * 1e3}
    engine = max(ms, key=ms.get)
    return ms, engine


def _tensor_rate(dtype: torch.dtype) -> float:
    return TENSOR_BF16_MAC_PER_S if dtype in (torch.bfloat16, torch.float16) \
        else TENSOR_TF32_MAC_PER_S


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float32": torch.float32,
            "f32": torch.float32, "fp32": torch.float32}[name]


def model_roofline(model_name: str, image_size: int = 0, batch: int = 256,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """Per-image engine times and the bound of the deployed forward (BN-fused for the
    RecNeXt families; the eval-mode unfused model for MLLA, which has no fused form)
    in ``dtype``, and the bound of a batch of ``batch``. image_size 0: the family's
    native side (224; MLLA 256). Counted on the CPU at batch 1 (``forward_counts``)."""
    from recnext_tpu_torch.tools.flops import forward_counts

    c = forward_counts(model_name, image_size)
    size = c["image_size"]
    elem = torch.tensor([], dtype=dtype).element_size()
    # an image's input and logits, and its share of one read of the weights a batch
    hbm = (3 * size * size + c["logits"] + c["params"] / batch) * elem
    ms, engine = _engines(c["dense_macs"], c["depthwise_macs"], c["elementwise_ops"], hbm,
                          _tensor_rate(dtype))
    bound = max(ms.values())
    return {
        "model": model_name, "image_size": size, "dtype": str(dtype).replace("torch.", ""),
        "params": c["params"],
        "tensor_gmacs_per_img": c["dense_macs"] / 1e9,
        "cuda_core_gmacs_per_img": c["depthwise_macs"] / 1e9,
        "cuda_core_gops_elementwise_per_img": c["elementwise_ops"] / 1e9,
        "hbm_mb_per_img": hbm / 1e6,
        "tensor_bound_ms": ms["tensor"], "cuda_core_bound_ms": ms["cuda_core"],
        "hbm_bound_ms": ms["hbm"],
        "bound_ms_per_img": bound, "bound_engine": engine,
        "batch": batch, "bound_ms_at_batch": bound * batch,
    }


def train_roofline(model_name: str, image_size: int = 0, batch: int = 128,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The roofline of the full train step (mixup, forward, backward, AGC + AdamW or
    the norm clip, EMA: ``bench.train_throughput``'s step) at ``batch``: per-image
    work and bounds, the train-mode forward's share (``fwd_*``) and the backward's
    MACs over the forward's. Counted on the CPU at batches 2 and 4 and extrapolated
    (``step_counts``)."""
    from recnext_tpu_torch.tools.flops import step_counts

    tot, fwd, meta = step_counts(model_name, image_size, batch)
    size = meta["image_size"]
    # compulsory traffic: the fp32 batch read once; parameters, gradients, the two
    # moments and the EMA copy each read and written once
    hbm = batch * 3 * size * size * 4 + meta["params"] * 4 * 2 * 5
    ms, engine = _engines(tot["dense_macs"], tot["depthwise_macs"], tot["elementwise_ops"],
                          hbm, _tensor_rate(dtype))
    per = {k: v / batch for k, v in ms.items()}
    g = 1e9 * batch
    return {
        "model": model_name, "image_size": size, "batch": batch,
        "dtype": str(dtype).replace("torch.", ""),
        "train_tensor_gmacs_per_img": tot["dense_macs"] / g,
        "train_cuda_core_gmacs_per_img": tot["depthwise_macs"] / g,
        "train_cuda_core_gops_elementwise_per_img": tot["elementwise_ops"] / g,
        "fwd_tensor_gmacs_per_img": fwd["dense_macs"] / g,
        "fwd_cuda_core_gmacs_per_img": fwd["depthwise_macs"] / g,
        "bwd_over_fwd_macs": (tot["dense_macs"] + tot["depthwise_macs"])
        / max(fwd["dense_macs"] + fwd["depthwise_macs"], 1.0) - 1.0,
        "hbm_mb_per_img": hbm / batch / 1e6,
        "tensor_bound_ms": per["tensor"], "cuda_core_bound_ms": per["cuda_core"],
        "hbm_bound_ms": per["hbm"],
        "bound_ms_per_img": max(per.values()), "bound_engine": engine,
        "bound_ms_at_batch": max(ms.values()),
    }


def with_measured(row: dict, images_per_sec: float) -> dict:
    """``row`` with the measured ms an image and the share of the bound it reaches."""
    meas_ms = 1e3 / images_per_sec
    return {**row, "measured_ms_per_img": meas_ms,
            "roofline_utilization_pct": 100 * row["bound_ms_per_img"] / meas_ms}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", nargs="*", default=None,
                   help="default: every model in --results (or the registry)")
    p.add_argument("--results", default=None,
                   help="a bench_all output: adds the measured ms an image and the share")
    p.add_argument("--train", action="store_true",
                   help="the full train step instead of the fused inference forward; "
                        "--results rows then give train_images_per_sec")
    p.add_argument("--image-size", type=int, default=0,
                   help="0 = the family's native side (224; MLLA 256)")
    p.add_argument("--batch", type=int, default=0,
                   help="the batch of the bound (default 256 forward, 128 train, or the "
                        "--results row's)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--out", default=None, help="write the rows as JSON")
    args = p.parse_args(argv)

    measured = {}
    if args.results:
        key = "train_images_per_sec" if args.train else "images_per_sec"
        for r in json.loads(Path(args.results).read_text()):
            if key in r:
                measured[r["model"]] = r
    names = args.models
    if not names:
        if measured:
            names = list(measured)
        else:
            from recnext_tpu_torch.models.mlla import MLLA_CONFIGS
            from recnext_tpu_torch.models.registry import list_models

            names = list_models() + sorted(MLLA_CONFIGS)
    dtype = _dtype(args.dtype)
    rows = []
    for name in names:
        m = measured.get(name, {})
        batch = args.batch or m.get("batch") or (128 if args.train else 256)
        if args.train:
            row = train_roofline(name, image_size=args.image_size, batch=batch, dtype=dtype)
        else:
            row = model_roofline(name, image_size=args.image_size, batch=batch, dtype=dtype)
        ips = m.get("train_images_per_sec" if args.train else "images_per_sec")
        if ips:
            row = with_measured(row, ips)
            row["measured_on"] = m.get("device")
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
