"""Benchmark of the port on one GPU: ``python -m recnext_tpu_torch.bench``.

Counterpart of the repository's ``bench.py`` (the JAX package's scoreboard). Prints
one JSON line ``{"metric", "value", "unit", "vs_baseline", ...}``; ``vs_baseline``
divides by the reference RTX3090 fused throughput (``BASELINES``, from the
reference's upload.py), at 224^2 only. Three modes:

* default: BN-fused inference throughput in bf16 (recnext_m1, batch 256): a warm-up
  of ``--warmup`` seconds, then a timed window of about ``--timed`` seconds, timed
  with CUDA events;
* ``--latency``: the fused model at batch 1, device time per forward (CUDA events
  around ``--latency-iters`` forwards);
* ``--train``: training throughput (``train_throughput``): the port's train step
  (mixup/cutmix, forward and backward through the kernels, AGC + AdamW, EMA) at
  ``--batch``, ``--repeats`` timed windows, the median and the spread; with
  ``--teacher regnety_160`` (or another RegNetY or registry model, seeded weights)
  the distilled step of the reference recipe (``--distillation`` hard or soft), the
  teacher's eval forward included. ``train_throughput``'s ``grad_accum``, ``remat``
  and ``mesa`` time the finetune recipe's step (a call is one micro-step; MESA
  active from the start), as ``chip_smoke.py``'s finetune phase does.

Weights are random, from a seeded generator; the inputs are random, made on the
device. Every mode runs on the GPU unless ``--device cpu``, and names the device it
ran on.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from recnext_tpu_torch.models.registry import parse_kv_overrides

BASELINES = {  # reference RTX3090 fused img/s (the repository's bench.py)
    "recnext_m0": 750, "recnext_m1": 384, "recnext_m2": 325, "recnext_m3": 314,
    "recnext_m4": 169, "recnext_m5": 104,
    "recnext_a0": 4891, "recnext_a1": 2730, "recnext_a2": 2331, "recnext_a3": 2151,
    "recnext_a4": 1265, "recnext_a5": 733,
    "recnext_t": 13878, "recnext_s": 7989, "recnext_b": 4450,
    "recnext_t_share_channel": 13957, "recnext_s_share_channel": 8034,
    "recnext_b_share_channel": 4472,
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_loop(fn, device: torch.device, iters: int) -> float:
    """Seconds for ``iters`` calls: CUDA events on the GPU, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def _calibrated_iters(fn, device: torch.device, warmup_s: float, timed_s: float,
                      most: int = 2000) -> int:
    """Run ``fn`` for ``warmup_s`` seconds, then return the number of calls that
    fill about ``timed_s`` seconds."""
    t0 = time.perf_counter()
    while True:
        fn()
        _sync(device)
        if time.perf_counter() - t0 >= warmup_s:
            break
    est = _timed_loop(fn, device, 3) / 3
    return max(3, min(most, int(timed_s / max(est, 1e-4))))


def _fused_model(model_name: str, dtype, device, **overrides):
    from recnext_tpu_torch.models.registry import create_model

    return create_model(model_name, fused=True, device=device, dtype=dtype,
                        generator=torch.Generator().manual_seed(0), **overrides)


def throughput(model_name: str, batch: int, *, dtype=torch.bfloat16, warmup_s: float = 5.0,
               timed_s: float = 10.0, image_size: int = 224, device=None,
               **overrides) -> float:
    """Fused inference images per second at ``batch``."""
    from recnext_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    model = _fused_model(model_name, dtype, dev, **overrides)
    x = torch.randn(batch, 3, image_size, image_size, device=dev,
                    generator=torch.Generator(dev).manual_seed(0)).to(dtype)
    with torch.inference_mode():
        fn = lambda: model(x)  # noqa: E731
        iters = _calibrated_iters(fn, dev, warmup_s, timed_s)
        return iters * batch / _timed_loop(fn, dev, iters)


def latency_ms(model_name: str, *, dtype=torch.bfloat16, iters: int = 200,
               image_size: int = 224, device=None, **overrides) -> float:
    """Fused forward at batch 1: milliseconds per forward over ``iters`` forwards
    after a warm-up (the host's launch time is part of it)."""
    from recnext_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    model = _fused_model(model_name, dtype, dev, **overrides)
    x = torch.randn(1, 3, image_size, image_size, device=dev,
                    generator=torch.Generator(dev).manual_seed(0)).to(dtype)
    with torch.inference_mode():
        for _ in range(10):
            model(x)
        _sync(dev)
        return _timed_loop(lambda: model(x), dev, iters) / iters * 1e3


def train_bench_step(model_name: str, batch: int, *, dtype=torch.bfloat16,
                     image_size: int = 224, device=None, teacher: str | None = None,
                     distillation: str = "hard", grad_accum: int = 1, remat: bool = False,
                     mesa: float = 0.0, **overrides):
    """One training step of ``model_name`` at ``batch`` as a function of no arguments
    (mixup/cutmix, forward, backward, AGC + AdamW, EMA), on random inputs made on the
    device, and the device it runs on. With ``teacher`` (a RegNetY or registry model
    name, seeded weights), the dual-head student learns from its logits
    (``distillation``: "hard" or "soft"). ``grad_accum``, ``remat`` and ``mesa`` are
    the train step's options (MESA from step 0); with ``grad_accum`` k a call is one
    micro-step, every k-th updating."""
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.registry import create_model
    from recnext_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import (create_teacher, make_teacher_apply,
                                              make_train_step)

    dev = resolve_device(device)
    model = create_model(model_name, device=dev, generator=torch.Generator().manual_seed(0),
                         distillation=teacher is not None, **overrides)
    opt = make_optimizer(model.named_parameters(), cosine_schedule(1e-3, 1000),
                         grad_accum=grad_accum)
    state = TrainState.create(model, opt)
    num_classes = model.cfg.num_classes
    teacher_apply = None
    if teacher is not None:
        teacher_apply = make_teacher_apply(
            create_teacher(teacher, num_classes=num_classes, device=dev), dtype)
    step = make_train_step(num_classes=num_classes, mixup=True, dtype=dtype,
                           teacher_apply=teacher_apply,
                           distillation=distillation if teacher is not None else "none",
                           grad_accum=grad_accum, remat=remat, mesa=mesa)
    g = torch.Generator(dev).manual_seed(0)
    data = {"image": torch.randn(batch, 3, image_size, image_size, device=dev, generator=g),
            "label": torch.randint(0, num_classes, (batch,), device=dev, generator=g)}
    mix = torch.Generator().manual_seed(0)
    return (lambda: step(state, data, mix)), dev


def train_throughput(model_name: str, batch: int, *, dtype=torch.bfloat16,
                     timed_s: float = 6.0, image_size: int = 224, repeats: int = 1,
                     device=None, teacher: str | None = None, distillation: str = "hard",
                     grad_accum: int = 1, remat: bool = False, mesa: float = 0.0,
                     **overrides):
    """Training-step images per second (``train_bench_step``, distilled from
    ``teacher`` where given, with its step options) at ``batch``: (median over
    ``repeats`` timed windows, batch, spread) with spread = {"min", "max", "runs"}."""
    fn, dev = train_bench_step(model_name, batch, dtype=dtype, image_size=image_size,
                               device=device, teacher=teacher, distillation=distillation,
                               grad_accum=grad_accum, remat=remat, mesa=mesa, **overrides)
    iters = _calibrated_iters(fn, dev, 0.0, timed_s, most=500)
    runs = [iters * batch / _timed_loop(fn, dev, iters) for _ in range(max(repeats, 1))]
    med = statistics.median(runs)
    spread = {"min": min(runs), "max": max(runs), "runs": runs}
    return med, batch, spread


def _device_name(device) -> str:
    dev = torch.device(device or "cuda")
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    p = argparse.ArgumentParser("RecNext benchmark (PyTorch/CUDA port)")
    p.add_argument("--model", default="recnext_m1")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--latency", action="store_true", help="batch-1 latency mode")
    p.add_argument("--latency-iters", type=int, default=200)
    p.add_argument("--train", action="store_true", help="training-step throughput mode")
    p.add_argument("--repeats", type=int, default=1,
                   help="--train only: independent timed windows; the median and spread")
    p.add_argument("--teacher", default="",
                   help="--train only: distil from this teacher (regnety_160, ...; seeded)")
    p.add_argument("--distillation", default="hard", choices=["hard", "soft"],
                   help="--train --teacher only: the distillation loss")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--timed", type=float, default=10.0)
    p.add_argument("--warmup", type=float, default=5.0)
    p.add_argument("--model-kwargs", default="",
                   help="RecNextConfig overrides, e.g. embed_dim=16:32:64:128,depth=1:1:2:1")
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    kw = parse_kv_overrides(args.model_kwargs)
    size = args.image_size
    if args.latency:
        ms = latency_ms(args.model, iters=args.latency_iters, image_size=size,
                        device=args.device, **kw)
        rec = {"metric": f"{args.model}_fused_bf16_{size}_batch1_ms", "value": round(ms, 4),
               "unit": "ms", "vs_baseline": None}
    elif args.train:
        ips, batch, spread = train_throughput(args.model, args.batch,
                                              timed_s=args.timed, image_size=size,
                                              repeats=args.repeats, device=args.device,
                                              teacher=args.teacher or None,
                                              distillation=args.distillation, **kw)
        rec = {"metric": f"{args.model}_train_bf16_{size}_images_per_sec",
               "value": round(ips, 2), "unit": "images/sec", "vs_baseline": None,
               "batch": batch, "step_ms": round(batch / ips * 1e3, 3),
               "teacher": args.teacher or None,
               "distillation": args.distillation if args.teacher else "none",
               "spread": {k: (round(v, 1) if not isinstance(v, list)
                              else [round(r, 1) for r in v]) for k, v in spread.items()}}
    else:
        ips = throughput(args.model, args.batch, warmup_s=args.warmup,
                         timed_s=args.timed, image_size=size, device=args.device, **kw)
        base = BASELINES.get(args.model) if size == 224 else None
        rec = {"metric": f"{args.model}_fused_bf16_{size}_images_per_sec",
               "value": round(ips, 2), "unit": "images/sec",
               "vs_baseline": round(ips / base, 3) if base else None, "batch": args.batch}
    rec["device"] = _device_name(args.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
