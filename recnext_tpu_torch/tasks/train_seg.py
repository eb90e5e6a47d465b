"""Semantic-segmentation training CLI: ``python -m recnext_tpu_torch.tasks.train_seg``.

Counterpart of ``recnext_tpu/tasks/train_seg.py`` (the reference's mmseg harness with
its Semantic FPN configs: AdamW lr 1e-4, weight decay 0.05 on every parameter, the
poly schedule of power 0.9 down to 1e-6, 40k iterations, mIoU every 8k, the
backbone's BN frozen and initialised from a classification checkpoint), with the
same flags and defaults, on the GPU unless ``--device cpu``:

* ``--preset`` takes a recipe of ``tasks/configs.py`` as the defaults;
* ``--data-set FAKE`` (class-coloured discs on noise) or ``FOLDER`` (ADE20K's layout,
  ``data/datasets.py:SegFolder``, sampled by ``seg_train_sample``; the validation
  split's mIoU at each eval, its tail batch padded with ignore labels);
* ``--init-ckpt`` loads a classification checkpoint (``train/finetune.py:read_weights``:
  a ``.pth``/``.pt`` state dict or the trainer's checkpoint) into the backbone;
* a ``torch.save`` checkpoint every ``--ckpt-every`` iterations (default: at every
  eval), the last 3 kept; ``--resume`` continues from the newest, ``--eval-only``
  reports its mIoU, ``--benchmark N`` the inference images per second over N
  batches (one JSON line);
* ``--dtype bfloat16`` computes in bf16 through ``train/step.py:compute_params``, the
  parameters staying fp32.

The JAX CLI's ``--compile-cache`` (XLA's compilation cache) has no counterpart.

The recipe on the card with FAKE data, 3 iterations, from a classification
checkpoint (the recipe starts from a pretrained backbone: with its frozen BN at the
init's identity statistics the backbone's activations grow without bound):
  python -m recnext_tpu_torch.tasks.train_seg --preset seg_recnext_m3_fpn_ade20k_40k \\
      --init-ckpt runs/m3/ckpt/epoch_0299.pt --iters 3 --eval-every 3 --output-dir runs/seg_m3
A small run on the CPU:
  python -m recnext_tpu_torch.tasks.train_seg --device cpu --backbone recnext_m0 \\
      --num-classes 8 --iters 4 --eval-every 2 --crop 64 --batch-size 2 \\
      --output-dir runs/seg_small
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

F32 = np.float32


def poly_schedule(base_lr: float, total_iters: int, power: float = 0.9,
                  min_lr: float = 1e-6):
    """(base - min) * (1 - t)^power + min at t = clip(step / total, 0, 1), in float32
    as the JAX package computes it."""
    def sched(step: int) -> float:
        t = np.clip(F32(step) / F32(total_iters), F32(0.0), F32(1.0))
        return float(F32(base_lr - min_lr) * (F32(1.0) - t) ** F32(power) + F32(min_lr))

    return sched


def synthetic_seg_batch(rng: np.random.Generator, batch: int, crop: int, num_classes: int):
    """The JAX package's learnable synthetic scenes from the same draws: a disc of a
    class's colour on noise. Returns {"image" (N, 3, crop, crop) float32, "label"
    (N, crop, crop) int32}."""
    img = rng.normal(scale=0.3, size=(batch, crop, crop, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:crop, 0:crop]
    masks = []
    for b in range(batch):
        cx, cy = rng.integers(0, crop, 2)
        r = rng.integers(crop // 8, crop // 2)
        cls = int(rng.integers(1, num_classes))
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        color = np.random.default_rng(cls).uniform(-1.5, 1.5, 3)
        img[b][inside] = color + rng.normal(scale=0.1, size=(int(inside.sum()), 3))
        m = np.zeros((crop, crop), np.int32)
        m[inside] = cls
        masks.append(m)
    return {"image": np.ascontiguousarray(img.transpose(0, 3, 1, 2)), "label": np.stack(masks)}


def parse_args(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--preset", default="",
                     help="named recipe from tasks/configs.py, e.g. "
                          "seg_recnext_m3_fpn_ade20k_40k")
    pre_args, argv = pre.parse_known_args(argv)
    p = argparse.ArgumentParser("Semantic FPN training (PyTorch/CUDA port)")
    p.add_argument("--backbone", default="recnext_m3")
    p.add_argument("--num-classes", type=int, default=150)
    p.add_argument("--iters", type=int, default=40000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--crop", type=int, default=512)
    p.add_argument("--eval-every", type=int, default=8000)
    p.add_argument("--data-set", default="FAKE", choices=["FAKE", "FOLDER"],
                   help="FOLDER = ADE20K-style images/ + annotations/ layout")
    p.add_argument("--data-path", default="")
    p.add_argument("--init-ckpt", default="", help="classification checkpoint (.pth/.pt)")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint interval in iters (0 = at every eval)")
    p.add_argument("--resume", action="store_true",
                   help="auto-resume from the latest checkpoint in output-dir")
    p.add_argument("--eval-only", action="store_true",
                   help="restore the latest checkpoint and report mIoU only")
    p.add_argument("--benchmark", type=int, default=0, metavar="ITERS",
                   help="measure inference images/sec over ITERS batches and exit")
    p.add_argument("--output-dir", default="runs/seg")
    p.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"])
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    if pre_args.preset:
        from recnext_tpu_torch.tasks.configs import SEGMENTATION_CONFIGS

        if pre_args.preset not in SEGMENTATION_CONFIGS:
            raise SystemExit(f"unknown preset {pre_args.preset!r}; "
                             f"known: {sorted(SEGMENTATION_CONFIGS)}")
        c = SEGMENTATION_CONFIGS[pre_args.preset]
        p.set_defaults(backbone=c["backbone"], lr=c["lr"], weight_decay=c["weight_decay"],
                       iters=c["iters"], batch_size=c["batch_size"],
                       num_classes=c["num_classes"], crop=c["crop"],
                       eval_every=c["eval_every"])
    return p.parse_args(argv)


def build_state(args, device: torch.device):
    """The Semantic FPN (seeded with 0, the classification checkpoint in its backbone
    where given) and its train state: AdamW with decay on every parameter, the poly
    schedule, no clipping, no EMA."""
    from recnext_tpu_torch.models.registry import get_config
    from recnext_tpu_torch.tasks.detection import (init_backbone_from_classification,
                                                   init_task_weights)
    from recnext_tpu_torch.tasks.segmentation import SemanticFPN
    from recnext_tpu_torch.train.finetune import read_weights
    from recnext_tpu_torch.train.optim import make_optimizer
    from recnext_tpu_torch.train.state import TrainState

    model = SemanticFPN(get_config(args.backbone, num_classes=0), num_classes=args.num_classes)
    init_task_weights(model, torch.Generator().manual_seed(0))
    if args.init_ckpt:
        model.load_state_dict(init_backbone_from_classification(
            model.state_dict(), read_weights(args.init_ckpt)), strict=True)
    model.to(device)
    optimizer = make_optimizer(model.named_parameters(), poly_schedule(args.lr, args.iters),
                               args.weight_decay, agc_clip=0.0, decay_all=True)
    return TrainState.create(model, optimizer, ema=False)


def make_seg_train_step(dtype: torch.dtype = torch.float32):
    """``train_step(state, batch, generator) -> loss``: forward in ``dtype``
    (``train/step.py:forward_model``), the per-pixel loss, backward, AdamW; the
    head's dropout draws from ``generator`` (on the model's device)."""
    from recnext_tpu_torch.tasks.segmentation import segmentation_loss
    from recnext_tpu_torch.train.step import forward_model

    def train_step(state, batch, generator):
        model = state.model.train()
        model.decode_head.generator = generator
        state.optimizer.zero_grad()
        loss = segmentation_loss(forward_model(model, batch["image"], dtype), batch["label"])
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return train_step


def make_seg_eval_step(num_classes: int, dtype: torch.dtype = torch.float32):
    """``eval_step(state, batch) -> (intersection, union)`` in eval mode, no grad."""
    from recnext_tpu_torch.tasks.segmentation import miou
    from recnext_tpu_torch.train.step import forward_model

    def eval_step(state, batch):
        model = state.model.eval()
        with torch.no_grad():
            logits = forward_model(model, batch["image"], dtype)
        return miou(logits, batch["label"], num_classes)

    return eval_step


def _mean_iou(inter: np.ndarray, union: np.ndarray) -> float:
    seen = union > 0
    return float(np.mean(inter[seen] / union[seen])) if seen.any() else 0.0


def main(argv=None):
    args = parse_args(argv)
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.train.main import Checkpoints

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    state = build_state(args, device)
    train_step = make_seg_train_step(dtype)
    eval_step = make_seg_eval_step(args.num_classes, dtype)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    ckpts = Checkpoints(out.resolve() / "ckpt", stem="iter")
    start_iter = 0
    if (args.resume or args.eval_only) and ckpts.latest() is not None:
        saved = torch.load(ckpts.path(ckpts.latest()), map_location=device, weights_only=True)
        state.load_state_dict(saved["state"])
        start_iter = state.step
        print(f"resumed at iter {start_iter}", flush=True)
    ckpt_every = args.ckpt_every or args.eval_every

    def to_device(batch):
        return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}

    rng_np = np.random.default_rng(0)
    val_ds = None
    if args.data_set == "FOLDER":
        from recnext_tpu_torch.data.datasets import SegFolder
        from recnext_tpu_torch.tasks.segmentation import seg_train_sample

        if not args.data_path:
            raise SystemExit("--data-set FOLDER requires --data-path")
        seg_ds = SegFolder(args.data_path, split="training")
        if len(seg_ds) == 0:
            raise SystemExit(f"no image/annotation pairs under {args.data_path}/images/"
                             f"training + annotations/training: check --data-path")
        val_ds = SegFolder(args.data_path, split="validation")
        val_ds = val_ds if len(val_ds) else None

        def next_batch(rng):
            imgs, segs = [], []
            for _ in range(args.batch_size):
                img, seg = seg_ds[int(rng.integers(len(seg_ds)))]
                a, s = seg_train_sample(rng, img, seg, args.crop)
                imgs.append(a)
                segs.append(s)
            return {"image": np.stack(imgs), "label": np.stack(segs)}
    else:
        def next_batch(rng):
            return synthetic_seg_batch(rng, args.batch_size, args.crop, args.num_classes)

    def val_miou():
        """mIoU over the validation split: center-crop samples of one shape, the tail
        batch padded with ignore labels; global intersection and union."""
        from recnext_tpu_torch.tasks.segmentation import seg_eval_sample

        inter_t = np.zeros(args.num_classes)
        union_t = np.zeros(args.num_classes)
        n = len(val_ds)
        for start in range(0, n, args.batch_size):
            idx = list(range(start, min(start + args.batch_size, n)))
            pad = args.batch_size - len(idx)
            samples = [seg_eval_sample(*val_ds[i], args.crop) for i in idx]
            imgs = np.stack([a for a, _ in samples] + [samples[0][0]] * pad)
            segs = np.stack([s for _, s in samples]
                            + [np.full_like(samples[0][1], 255)] * pad)
            inter, union = eval_step(state, to_device({"image": imgs, "label": segs}))
            inter_t += inter.cpu().numpy()
            union_t += union.cpu().numpy()
        return _mean_iou(inter_t, union_t)

    def measure_miou(batch):
        if val_ds is not None:
            return val_miou()
        inter, union = eval_step(state, batch)
        return _mean_iou(inter.cpu().numpy(), union.cpu().numpy())

    if args.benchmark:
        return benchmark(state.model, args, device, dtype)

    if args.eval_only:
        if ckpts.latest() is None and not args.init_ckpt:
            raise SystemExit(f"--eval-only: no checkpoint under {out / 'ckpt'}")
        batch = None if val_ds is not None else to_device(next_batch(np.random.default_rng(1)))
        rec = {"iter": start_iter, "mIoU": round(100 * measure_miou(batch), 2)}
        print(json.dumps(rec), flush=True)
        return rec

    t0 = time.time()
    rec = None
    for it in range(start_iter, args.iters):
        batch = to_device(next_batch(rng_np))
        gen = torch.Generator(device=device).manual_seed(it)  # the dropout's draws
        loss = train_step(state, batch, gen)
        if (it + 1) % args.eval_every == 0 or it + 1 == args.iters:
            loss = loss.item()
            rec = {"iter": it + 1, "loss": loss, "mIoU": round(100 * measure_miou(batch), 2),
                   "elapsed_s": round(time.time() - t0, 1)}
            if device.type == "cuda":
                rec["max_memory_gib"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
            print(json.dumps(rec), flush=True)
            with open(out / "log.txt", "a") as f:
                f.write(json.dumps(rec) + "\n")
            if not math.isfinite(loss):
                raise SystemExit(f"Loss is {loss}, stopping")
        if (it + 1) % ckpt_every == 0 or it + 1 == args.iters:
            ckpts.save(it + 1, {"iter": it + 1, "state": state.state_dict()})
    return {"state": state, "last": rec}


def benchmark(model, args, device, dtype):
    """Inference images per second over ``args.benchmark`` batches of ones, after one
    warm-up batch, the device synchronised before and after (one JSON line)."""
    from recnext_tpu_torch.train.step import forward_model

    model.eval()
    x = torch.ones(args.batch_size, 3, args.crop, args.crop, device=device)
    with torch.inference_mode():
        forward_model(model, x, dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.benchmark):
            forward_model(model, x, dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    rec = {"backbone": args.backbone, "crop": args.crop, "batch_size": args.batch_size,
           "iters": args.benchmark,
           "images_per_sec": round(args.benchmark * args.batch_size / dt, 2)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
