"""Parameter and MAC counts of the port's models.

Counterpart of ``recnext_tpu/benchmark/flops.py`` (itself the counterpart of the
reference's fvcore ``FlopCountAnalysis`` on the fused model). MACs follow fvcore's
convention: the multiply-adds of convolutions and matmuls. JAX took XLA's compiled
cost analysis and halved its FLOPs (which also counts each elementwise op as a FLOP);
the port counts from the model's aten ops (``tools/roofline.py:OpCounter``), so a
count here is the tensor-core plus the depthwise MACs of ``tools/roofline.py``.

The count does not depend on what implements an op: whatever device a model serves
on, it is taken on the CPU, on the plain path (``roofline.plain_mixers``), at batch 1
(a train step at batches 2 and 4, extrapolated), so K1's kernel and its plain version
count the same work. The forward is the deployed one: BN-fused for the RecNeXt
families (``--unfused`` for the trained form), the eval-mode model for MLLA.

  python -m recnext_tpu_torch.tools.flops --model recnext_m1
  python -m recnext_tpu_torch.tools.flops --model mlla_mini_recconv
  python -m recnext_tpu_torch.tools.flops --task seg --model recnext_m3
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Tuple

import torch

from recnext_tpu_torch.tools.roofline import analyze, plain_mixers


def count_params(module_or_tensors) -> int:
    """Parameters of a module (its ``parameters()``; BN running statistics are buffers,
    as they are JAX's ``batch_stats``), or the elements of an iterable of tensors."""
    if isinstance(module_or_tensors, torch.nn.Module):
        module_or_tensors = module_or_tensors.parameters()
    return sum(int(p.numel()) for p in module_or_tensors)


def build_model(model_name: str, fused: bool = True, dtype=torch.float32):
    """``model_name`` on the CPU with seeded weights, in eval mode: BN-fused (``fused``)
    for the RecNeXt families, the unfused eval-mode model for MLLA."""
    from recnext_tpu_torch.models.mlla import create_mlla
    from recnext_tpu_torch.models.registry import create_model

    gen = torch.Generator().manual_seed(0)
    if model_name.startswith("mlla"):
        return create_mlla(model_name, device="cpu", dtype=dtype, generator=gen)
    return create_model(model_name, fused=fused, device="cpu", dtype=dtype, generator=gen)


def native_size(model_name: str) -> int:
    return 256 if model_name.startswith("mlla") else 224


def forward_counts(model_name: str, image_size: int = 0, fused: bool = True) -> dict:
    """Work of one image's forward (batch 1, CPU, the plain path, fp32: the ops do not
    depend on the dtype) and the model's parameters and logits; image_size 0 is the
    model's native side. Counted once a model, side and form."""
    return _forward_counts(model_name, image_size or native_size(model_name),
                           fused and not model_name.startswith("mlla"))


@functools.lru_cache(maxsize=None)
def _forward_counts(model_name: str, size: int, fused: bool) -> dict:
    model = build_model(model_name, fused=fused)
    x = torch.zeros(1, 3, size, size)
    with torch.no_grad(), plain_mixers(model):
        totals = analyze(model, x)
        logits = model(x)
    return {**totals, "params": count_params(model), "image_size": size,
            "logits": int(logits.numel())}


def model_flops(model_name: str, input_size: int = 224, fused: bool = True,
                batch: int = 1) -> Tuple[int, float]:
    """(params, MACs an image) of a registry model at ``input_size``. ``batch`` is
    accepted for the JAX signature; the count is per image."""
    c = forward_counts(model_name, input_size, fused)
    return c["params"], c["dense_macs"] + c["depthwise_macs"]


def mlla_flops(model_name: str, input_size: int = 0, batch: int = 1) -> Tuple[int, float]:
    """(params, MACs an image) of an MLLA graft variant at its native side (256)."""
    c = forward_counts(model_name, input_size, False)
    return c["params"], c["dense_macs"] + c["depthwise_macs"]


def task_model(task: str, backbone: str, num_classes: int):
    """The downstream model of ``task`` ("seg", "retinanet", "mask_rcnn") on a
    ``backbone``, on the CPU, in eval mode."""
    from recnext_tpu_torch.models.registry import get_config

    cfg = get_config(backbone, num_classes=0)
    if task == "seg":
        from recnext_tpu_torch.tasks.segmentation import SemanticFPN

        model = SemanticFPN(backbone_cfg=cfg, num_classes=num_classes)
    elif task == "retinanet":
        from recnext_tpu_torch.tasks.detection import RetinaNet

        model = RetinaNet(backbone_cfg=cfg, num_classes=num_classes)
    elif task == "mask_rcnn":
        from recnext_tpu_torch.tasks.mask_rcnn import MaskRCNN

        model = MaskRCNN(backbone_cfg=cfg, num_classes=num_classes)
    else:
        raise ValueError(f"unknown task {task!r}")
    return model.eval()


def task_flops(task: str, backbone: str, input_size: int,
               num_classes: int) -> Tuple[int, float]:
    """(params, MACs) of a downstream model's inference forward at a square input:
    the counterpart of the mm harnesses' FLOP counters (backbone + FPN + heads; Mask
    R-CNN's RoI heads on its fixed number of proposals)."""
    model = task_model(task, backbone, num_classes)
    x = torch.zeros(1, 3, input_size, input_size)
    with torch.no_grad(), plain_mixers(model):
        t = analyze(model, x)
    return count_params(model), t["dense_macs"] + t["depthwise_macs"]


def _step_work(model_name: str, image_size: int, batch: int, dtype):
    """Work of one train step and of its train-mode forward at ``batch`` on the CPU."""
    from recnext_tpu_torch.bench import train_bench_step
    from recnext_tpu_torch.train.step import forward_model

    torch.manual_seed(0)
    fn, _ = train_bench_step(model_name, batch, dtype=dtype, image_size=image_size,
                             device="cpu")
    model = fn.state.model
    with plain_mixers(model):
        step = analyze(fn)
        x = torch.zeros(batch, 3, image_size, image_size)
        model.train()
        with torch.no_grad():
            fwd = analyze(forward_model, model, x, dtype)
    return step, fwd, count_params(model)


def step_counts(model_name: str, image_size: int = 0, batch: int = 128):
    """(step totals, train-mode forward totals, meta) at ``batch``: counted at batches
    2 and 4 and extrapolated, since a step's work is affine in its batch (the
    per-parameter optimizer and EMA work is the constant). Counted in fp32: the step
    runs the same ops in any compute dtype, casts aside."""
    size = image_size or native_size(model_name)
    s2, f2, params = _step_work(model_name, size, 2, torch.float32)
    s4, f4, _ = _step_work(model_name, size, 4, torch.float32)

    def at(a, b):
        return {k: a[k] + (b[k] - a[k]) * (batch - 2) / 2 for k in a}

    return at(s2, s4), at(f2, f4), {"image_size": size, "params": params}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="recnext_m1")
    p.add_argument("--input-size", type=int, default=0,
                   help="default: 224 (cls; MLLA 256) / 512 (seg, det)")
    p.add_argument("--unfused", action="store_true")
    p.add_argument("--task", default="cls", choices=["cls", "seg", "retinanet", "mask_rcnn"],
                   help="seg/det: the mm harnesses' get_flops counterpart")
    p.add_argument("--num-classes", type=int, default=0,
                   help="default: 1000 (cls) / 150 (seg) / 80 (det)")
    args = p.parse_args(argv)
    if args.task == "cls":
        size = args.input_size or native_size(args.model)
        if args.model.startswith("mlla"):
            n, macs = mlla_flops(args.model, size)
        else:
            n, macs = model_flops(args.model, size, fused=not args.unfused)
    else:
        size = args.input_size or 512
        nc = args.num_classes or (150 if args.task == "seg" else 80)
        n, macs = task_flops(args.task, args.model, size, nc)
    rec = {"model": args.model, "task": args.task, "input_size": size,
           "params_M": n / 1e6, "macs_G": macs / 1e9, "counted_on": "cpu, plain path"}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
