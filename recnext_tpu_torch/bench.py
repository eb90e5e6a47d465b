"""Benchmark of the port on one GPU: ``python -m recnext_tpu_torch.bench``.

Counterpart of the repository's ``bench.py`` (the JAX package's scoreboard). Prints
one JSON line ``{"metric", "value", "unit", "vs_baseline", ...}``; ``vs_baseline``
divides by the reference RTX3090 fused throughput (``BASELINES``, from the
reference's upload.py), at 224^2 only. Three modes:

* default: BN-fused inference throughput in bf16 (recnext_m1, batch 256): a warm-up
  of ``--warmup`` seconds, then a timed window of about ``--timed`` seconds, timed
  with CUDA events. The M and A families run through the packed executor
  (``models/packed_infer.py`` at ``default_groups``), as the JAX scoreboard does,
  unless ``--no-packed``; ``--attn-impl`` takes ``headbatch`` only (JAX's
  ``blockdiag`` forms are TPU layouts, not ported). The JSON line says which ran
  (``packed``, ``groups``);
* ``--latency``: the fused model at batch 1, device time per forward (CUDA events
  around ``--latency-iters`` forwards);
* ``--train``: training throughput (``train_throughput``): the port's train step
  (mixup/cutmix, forward and backward through the kernels, AGC + AdamW, EMA) at
  ``--batch``, ``--repeats`` timed windows, the median and the spread; with
  ``--teacher regnety_160`` (or another RegNetY or registry model, seeded weights)
  the distilled step of the reference recipe (``--distillation`` hard or soft), the
  teacher's eval forward included. ``train_throughput``'s ``grad_accum``, ``remat``
  and ``mesa`` time the finetune recipe's step (a call is one micro-step; MESA
  active from the start), as ``chip_smoke.py``'s finetune phase does;
* the MLLA graft family (``--model mlla_*``): the eval-mode unfused model (it has no
  fused form) in bf16 at 256^2 by default, as ``recnext_tpu/benchmark/bench_mlla.py``
  times it; ``--train`` runs the MLLA recipe's step (global-norm clip 5.0, weight
  decay 0.05; ``--mesa`` adds MESA's EMA-model forward from the first step);
* ``--loader``: the host's input pipeline (``loader_bench``, the counterpart of
  ``recnext_tpu/benchmark/bench_loader.py``): a folder of ``--images`` 500x375 JPEGs
  (``make_folder``), then the train loader's images per second for PIL and the
  native decoder, each with the full and the simple train transform, at workers 0
  and ``--workers``, batches of ``--batch`` (32) at ``--image-size``; one JSON line
  a pipeline with the host's ``os.cpu_count()`` and CPU affinity. A native pipeline
  whose decoder cannot be built prints why, in place of a rate. Batches are pinned
  on the GPU's host, as the trainer's are.

Weights are random, from a seeded generator; the inputs are random, made on the
device. Every mode runs on the GPU unless ``--device cpu``, and names the device it
ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
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


def is_mlla(model_name: str) -> bool:
    return model_name.startswith("mlla")


def native_size(model_name: str) -> int:
    """The input side a model is timed at by default: 256 for MLLA (its recattn grafts
    need even stage sizes), 224 for the RecNeXt families."""
    return 256 if is_mlla(model_name) else 224


def inference_model(model_name: str, dtype, device, **overrides):
    """The model that serves ``model_name``: BN-fused for the RecNeXt families, the
    eval-mode unfused model for MLLA (which has no fused form); seeded weights."""
    from recnext_tpu_torch.models.mlla import create_mlla
    from recnext_tpu_torch.models.registry import create_model

    gen = torch.Generator().manual_seed(0)
    if is_mlla(model_name):
        return create_mlla(model_name, device=device, dtype=dtype, generator=gen, **overrides)
    return create_model(model_name, fused=True, device=device, dtype=dtype, generator=gen,
                        **overrides)


def packed_groups(model_name: str, batch: int, packed: bool = True, **overrides):
    """The packed executor's per-stage factors for ``model_name`` at ``batch``
    (``default_groups``), or None where it does not run: not ``packed``, MLLA, the L
    family."""
    from recnext_tpu_torch.models.packed_infer import default_groups
    from recnext_tpu_torch.models.registry import get_config

    if not packed or is_mlla(model_name):
        return None
    cfg = get_config(model_name, **overrides)
    return default_groups(cfg, batch) if cfg.family in ("m", "a") else None


def throughput(model_name: str, batch: int, *, dtype=torch.bfloat16, warmup_s: float = 5.0,
               timed_s: float = 10.0, image_size: int | None = None, device=None,
               packed: bool = True, **overrides) -> float:
    """Inference images per second at ``batch`` (``inference_model``, through the
    packed executor at ``packed_groups``), at ``image_size`` (default
    ``native_size``)."""
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.packed_infer import PackedRecNext

    dev = resolve_device(device)
    image_size = image_size or native_size(model_name)
    model = inference_model(model_name, dtype, dev, **overrides)
    groups = packed_groups(model_name, batch, packed, **overrides)
    if groups:
        model = PackedRecNext(model, groups)
    x = torch.randn(batch, 3, image_size, image_size, device=dev,
                    generator=torch.Generator(dev).manual_seed(0)).to(dtype)
    with torch.inference_mode():
        fn = lambda: model(x)  # noqa: E731
        iters = _calibrated_iters(fn, dev, warmup_s, timed_s)
        return iters * batch / _timed_loop(fn, dev, iters)


def latency_ms(model_name: str, *, dtype=torch.bfloat16, iters: int = 200,
               image_size: int | None = None, device=None, **overrides) -> float:
    """``inference_model``'s forward at batch 1: milliseconds per forward over
    ``iters`` forwards after a warm-up (the host's launch time is part of it)."""
    from recnext_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    image_size = image_size or native_size(model_name)
    model = inference_model(model_name, dtype, dev, **overrides)
    x = torch.randn(1, 3, image_size, image_size, device=dev,
                    generator=torch.Generator(dev).manual_seed(0)).to(dtype)
    with torch.inference_mode():
        for _ in range(10):
            model(x)
        _sync(dev)
        return _timed_loop(lambda: model(x), dev, iters) / iters * 1e3


def train_bench_step(model_name: str, batch: int, *, dtype=torch.bfloat16,
                     image_size: int | None = None, device=None, teacher: str | None = None,
                     distillation: str = "hard", grad_accum: int = 1, remat: bool = False,
                     mesa: float = 0.0, ema: bool = True, **overrides):
    """One training step of ``model_name`` at ``batch`` as a function of no arguments
    (mixup/cutmix, forward, backward, AGC + AdamW, EMA; for MLLA its recipe's
    global-norm clip 5.0 and weight decay 0.05), on random inputs made on the device,
    and the device it runs on. With ``teacher`` (a RegNetY or registry model name,
    seeded weights), the dual-head student learns from its logits (``distillation``:
    "hard" or "soft"). ``grad_accum``, ``remat`` and ``mesa`` are the train step's
    options (MESA from step 0); with ``grad_accum`` k a call is one micro-step, every
    k-th updating; ``ema=False`` keeps no EMA copy. The function carries the step's
    ``state`` and ``data``."""
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.mlla import create_mlla
    from recnext_tpu_torch.models.registry import create_model
    from recnext_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import (create_teacher, make_teacher_apply,
                                              make_train_step)

    dev = resolve_device(device)
    image_size = image_size or native_size(model_name)
    gen = torch.Generator().manual_seed(0)
    if is_mlla(model_name):
        if teacher is not None:
            raise ValueError("mlla models have no distillation head")
        model = create_mlla(model_name, device=dev, generator=gen, **overrides)
        opt = make_optimizer(model.named_parameters(), cosine_schedule(1e-3, 1000),
                             weight_decay=0.05, agc_clip=5.0, clip_mode="norm",
                             grad_accum=grad_accum)
    else:
        model = create_model(model_name, device=dev, generator=gen,
                             distillation=teacher is not None, **overrides)
        opt = make_optimizer(model.named_parameters(), cosine_schedule(1e-3, 1000),
                             grad_accum=grad_accum)
    state = TrainState.create(model, opt, ema=ema)
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

    def run():
        return step(state, data, mix)

    run.state, run.data = state, data  # for the tools that take the step apart
    return run, dev


def train_throughput(model_name: str, batch: int, *, dtype=torch.bfloat16,
                     timed_s: float = 6.0, image_size: int | None = None, repeats: int = 1,
                     device=None, teacher: str | None = None, distillation: str = "hard",
                     grad_accum: int = 1, remat: bool = False, mesa: float = 0.0,
                     step=None, **overrides):
    """Training-step images per second (``train_bench_step``, distilled from
    ``teacher`` where given, with its step options) at ``batch``: (median over
    ``repeats`` timed windows, batch, spread) with spread = {"min", "max", "runs"}.
    ``step``: a ``train_bench_step`` result to time in place of a new one."""
    fn, dev = step or train_bench_step(model_name, batch, dtype=dtype, image_size=image_size,
                                       device=device, teacher=teacher,
                                       distillation=distillation, grad_accum=grad_accum,
                                       remat=remat, mesa=mesa, **overrides)
    iters = _calibrated_iters(fn, dev, 0.0, timed_s, most=500)
    runs = [iters * batch / _timed_loop(fn, dev, iters) for _ in range(max(repeats, 1))]
    med = statistics.median(runs)
    spread = {"min": min(runs), "max": max(runs), "runs": runs}
    return med, batch, spread


def make_folder(root: Path, n: int, *, classes: int = 1, w: int = 500, h: int = 375) -> None:
    """``n`` photo-like images (smooth gradients and noise, the size of a real JPEG) in
    ``root``/c<k>/, image i in class i % ``classes``: bench_loader.py's content. The
    noise is drawn in order here; threads encode and write."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    for c in range(min(classes, n)):
        (root / f"c{c}").mkdir(parents=True, exist_ok=True)

    def write(i, noise):
        arr = np.stack([(xx * 2 + i * 17) % 256, (yy * 3 + 50 * np.sin(xx / 40 + i)) % 256,
                        noise], -1).astype(np.uint8)
        Image.fromarray(arr).save(root / f"c{i % classes}" / f"{i:04d}.jpg", "JPEG",
                                  quality=90)

    threads = min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(threads) as pool:
        for start in range(0, n, 4 * threads):  # a bounded number of images in flight
            futures = [pool.submit(write, i, rng.integers(0, 256, (h, w)).astype(np.uint8))
                       for i in range(start, min(n, start + 4 * threads))]
            for f in futures:
                f.result()


def host_cpus() -> dict:
    return {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))}


def loader_throughput(loader, warm_batches: int) -> float:
    """Images per second of ``loader`` after its first ``warm_batches`` batches (at
    most half of them)."""
    it = iter(loader)
    for _ in range(min(warm_batches, len(loader) // 2)):
        next(it)
    t0 = time.perf_counter()
    seen = sum(int(b["label"].shape[0]) for b in it)
    return seen / (time.perf_counter() - t0)


LOADER_PIPELINES = ("pil_full_aug", "pil_simple", "native_full_aug", "native_simple")


def loader_bench(dataset, *, size: int = 224, batch: int = 32, workers=(0,),
                 pin_memory: bool = False) -> list:
    """The train loader's images per second over ``dataset`` for each pipeline of
    ``LOADER_PIPELINES`` at each worker count, after a batch a worker (at least 2):
    one record each."""
    from recnext_tpu_torch.data.loader import train_loader
    from recnext_tpu_torch.data.native import NativeBuildError
    from recnext_tpu_torch.data.transforms import SimpleTrainTransform, TrainTransform

    records = []
    for name in LOADER_PIPELINES:
        tf = TrainTransform(size) if name.endswith("full_aug") else SimpleTrainTransform(size)
        for w in workers:
            rec = {"metric": "loader_images_per_sec", "pipeline": name, "workers": w,
                   "batch": batch, "size": size, "images": len(dataset), **host_cpus()}
            try:
                loader = train_loader(dataset, tf, batch_size=batch, epoch=0,
                                      native=name.startswith("native"), workers=w,
                                      pin_memory=pin_memory)
            except NativeBuildError as e:
                records.append({**rec, "value": None, "native_unavailable": str(e)[:300]})
                continue
            ips = loader_throughput(loader, warm_batches=max(2, w))
            records.append({**rec, "value": ips, "unit": "images/sec",
                            "route": loader.route,
                            "native_fallback_batches": loader.native_fallback_batches})
    return records


def _device_name(device) -> str:
    dev = torch.device(device or "cuda")
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    p = argparse.ArgumentParser("RecNext benchmark (PyTorch/CUDA port)")
    p.add_argument("--model", default="recnext_m1")
    p.add_argument("--batch", type=int, default=None,
                   help="default: 256 (model modes), 32 (--loader)")
    p.add_argument("--latency", action="store_true", help="batch-1 latency mode")
    p.add_argument("--latency-iters", type=int, default=200)
    p.add_argument("--train", action="store_true", help="training-step throughput mode")
    p.add_argument("--repeats", type=int, default=1,
                   help="--train only: independent timed windows; the median and spread")
    p.add_argument("--teacher", default="",
                   help="--train only: distil from this teacher (regnety_160, ...; seeded)")
    p.add_argument("--distillation", default="hard", choices=["hard", "soft"],
                   help="--train --teacher only: the distillation loss")
    p.add_argument("--mesa", type=float, default=0.0,
                   help="--train only: MESA's weight, active from the first step (the MLLA "
                        "recipe's 1.0 adds the EMA model's forward to each step)")
    p.add_argument("--loader", action="store_true", help="input pipeline throughput mode")
    p.add_argument("--images", type=int, default=256,
                   help="--loader only: JPEGs in the generated folder")
    p.add_argument("--workers", type=int, default=min(16, os.cpu_count() or 1),
                   help="--loader only: the worker count timed beside 0")
    p.add_argument("--image-size", type=int, default=None,
                   help="default: 256 for MLLA, 224 otherwise (--loader: 224)")
    p.add_argument("--timed", type=float, default=10.0)
    p.add_argument("--warmup", type=float, default=5.0)
    p.add_argument("--no-packed", action="store_true",
                   help="the M and A families' fused model as it is, not packed")
    p.add_argument("--model-kwargs", default="",
                   help="RecNextConfig overrides, e.g. embed_dim=16:32:64:128,depth=1:1:2:1")
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    args = p.parse_args(argv)
    if torch.device(args.device or "cuda").type == "cuda":
        from recnext_tpu_torch.utils.watchdog import require_devices

        require_devices(metric="bench")  # a deadline on the first touch of the GPU
    kw = parse_kv_overrides(args.model_kwargs)
    if args.loader:
        size = args.image_size or 224
        from recnext_tpu_torch.data.datasets import ImageFolder
        from recnext_tpu_torch.device import resolve_device

        pin = resolve_device(args.device).type == "cuda"
        with tempfile.TemporaryDirectory() as td:
            make_folder(Path(td), args.images)
            records = loader_bench(ImageFolder(td), size=size, batch=args.batch or 32,
                                   workers=(0, args.workers), pin_memory=pin)
        for rec in records:
            print(json.dumps(rec), flush=True)
        return records
    args.batch = args.batch or 256
    size = args.image_size or native_size(args.model)
    form = "bf16" if is_mlla(args.model) else "fused_bf16"  # MLLA has no fused form
    if args.latency:
        ms = latency_ms(args.model, iters=args.latency_iters, image_size=size,
                        device=args.device, **kw)
        rec = {"metric": f"{args.model}_{form}_{size}_batch1_ms", "value": round(ms, 4),
               "unit": "ms", "vs_baseline": None}
    elif args.train:
        ips, batch, spread = train_throughput(args.model, args.batch,
                                              timed_s=args.timed, image_size=size,
                                              repeats=args.repeats, device=args.device,
                                              teacher=args.teacher or None,
                                              distillation=args.distillation, mesa=args.mesa,
                                              **kw)
        rec = {"metric": f"{args.model}_train_bf16_{size}_images_per_sec",
               "value": round(ips, 2), "unit": "images/sec", "vs_baseline": None,
               "batch": batch, "step_ms": round(batch / ips * 1e3, 3),
               "teacher": args.teacher or None, "mesa": args.mesa,
               "clip": "norm 5.0" if is_mlla(args.model) else "agc 0.02",
               "distillation": args.distillation if args.teacher else "none",
               "spread": {k: (round(v, 1) if not isinstance(v, list)
                              else [round(r, 1) for r in v]) for k, v in spread.items()}}
    else:
        ips = throughput(args.model, args.batch, warmup_s=args.warmup,
                         timed_s=args.timed, image_size=size, device=args.device,
                         packed=not args.no_packed, **kw)
        groups = packed_groups(args.model, args.batch, not args.no_packed, **kw)
        base = BASELINES.get(args.model) if size == 224 else None
        rec = {"metric": f"{args.model}_{form}_{size}_images_per_sec",
               "value": round(ips, 2), "unit": "images/sec",
               "vs_baseline": round(ips / base, 3) if base else None, "batch": args.batch,
               "packed": groups is not None, "groups": list(groups) if groups else None}
    rec["device"] = _device_name(args.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
