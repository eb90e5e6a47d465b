"""Training CLI: ``python -m recnext_tpu_torch.train.main``.

Counterpart of ``recnext_tpu/train/main.py`` for the subset the port runs so far:
one device (the GPU unless ``--device cpu``), the M and A families (on the GPU
through their kernels and the kernels' backward), FAKE data with the simple train
transform and the loader's seeded permutation, mixup/cutmix and label smoothing,
hard or soft distillation from a teacher (``--distillation-type``, ``--teacher-model``
regnety_160/040/016 or a registry model, ``--teacher-ckpt``), AGC + AdamW with the
reference cosine schedule, EMA, bf16 compute with fp32 parameters (``--dtype``), a
per-epoch BN-fused eval of the model and of its EMA, a checkpoint each epoch
(``torch.save``; the last 3 and the best kept) and auto-resume from the newest. The
per-epoch JSON line and ``log.txt`` keep the JAX CLI's key names.

The teacher's ``--teacher-ckpt`` is a ``.pth``/``.pt`` state dict (timm's layout for a
RegNetY, the published DeiT ``regnety_160`` one included; the port's own for a
registry model), loaded strictly; without one the teacher is a seeded init, as the
JAX CLI's ``init(PRNGKey(1))``. Other data sets, the full train transform
(RandAugment, ThreeAugment, erasing) and the JAX package's teacher checkpoints
(orbax, msgpack) raise, naming their ROADMAP item; the JAX CLI's other options
(MESA, JSD, gradient accumulation, remat, the repeated-augmentation sampler, the
unfused eval) are not flags here yet.

Smoke run on the CPU (a small M config; it resumes from the checkpoints that
--output-dir already holds, so empty it first):
  rm -rf runs/smoke
  python -m recnext_tpu_torch.train.main --device cpu --model recnext_m0 \\
      --model-kwargs embed_dim=16:32:64:128,depth=1:1:2:1 --data-set FAKE \\
      --simple-aug --input-size 32 --batch-size 4 --epochs 2 --steps-per-epoch 2 \\
      --fake-classes 11 --dtype float32 --output-dir runs/smoke

recnext_a1 with the reference recipe's hard distillation from a (seeded) regnety_160
teacher on the GPU:
  python -m recnext_tpu_torch.train.main --model recnext_a1 --distillation-type hard \
      --teacher-model regnety_160 --data-set FAKE --simple-aug --batch-size 64 \
      --epochs 2 --steps-per-epoch 3 --output-dir runs/a1_distill
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

import torch

from recnext_tpu_torch.data.datasets import DATA_ITEM

CKPT_KEEP = 3
CKPT_ITEM = "ROADMAP.md Queue 1 item 9 (checkpoint import)"


def parse_args(argv=None):
    p = argparse.ArgumentParser("RecNext training (PyTorch/CUDA port)")
    p.add_argument("--model", default="recnext_m1")
    p.add_argument("--model-kwargs", default="",
                   help="comma-separated RecNextConfig overrides, tuples with ':', e.g. "
                        "embed_dim=16:32:64:128,depth=1:1:2:1")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.025)
    p.add_argument("--clip-grad", type=float, default=0.02)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--cooldown-epochs", type=int, default=0)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--simple-aug", action="store_true",
                   help="RRC + flip + normalize (the only train transform ported so far)")
    p.add_argument("--fake-classes", type=int, default=1000)
    p.add_argument("--distillation-type", default="none", choices=["none", "hard", "soft"])
    p.add_argument("--distillation-alpha", type=float, default=0.5)
    p.add_argument("--distillation-tau", type=float, default=1.0)
    p.add_argument("--teacher-ckpt", default="",
                   help=".pth/.pt state dict of the teacher (timm's layout for a RegNetY, "
                        "the port's for a registry model); none: a seeded init")
    p.add_argument("--teacher-model", default="",
                   help="the teacher: regnety_160/040/016 or a registry model")
    p.add_argument("--model-ema-decay", type=float, default=0.99996)
    p.add_argument("--no-model-ema", action="store_true")
    p.add_argument("--data-set", default="IMNET",
                   choices=["IMNET", "CIFAR", "FOLDER", "FAKE", "IMNETEE", "FLOWERS", "INAT",
                            "INAT19"])
    p.add_argument("--output-dir", default="runs/default")
    p.add_argument("--eval", action="store_true", help="evaluate the newest checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="truncate each epoch (and its eval) to this many batches; 0 = all")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if not args.simple_aug:
        raise NotImplementedError("the full train transform (RandAugment, ThreeAugment, "
                                  f"erasing) is not ported yet: pass --simple-aug; see "
                                  f"{DATA_ITEM}")
    if args.distillation_type != "none" and not args.teacher_model:
        raise SystemExit("--distillation-type requires --teacher-model")
    if args.teacher_ckpt and not args.teacher_ckpt.endswith((".pth", ".pt")):
        raise NotImplementedError(f"teacher checkpoint {args.teacher_ckpt!r}: the port reads "
                                  ".pth/.pt state dicts; the JAX package's orbax directories "
                                  f"and .msgpack files are not ported; see {CKPT_ITEM}")


def load_state_dict_file(path: str) -> dict:
    """A ``.pth``/``.pt`` state dict: as saved, inside a ``{"model": ...}`` checkpoint
    (timm's, the published DeiT teacher's), or inside this trainer's checkpoint
    (``{"state": {"model": ...}}``)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("state", state)
    return state.get("model", state)


def build_teacher(args, num_classes: int, device: torch.device, dtype: torch.dtype, log):
    """``teacher_apply`` for the train step: ``--teacher-model`` with the weights of
    ``--teacher-ckpt`` (strict), or seeded."""
    from recnext_tpu_torch.train.step import create_teacher, make_teacher_apply

    teacher = create_teacher(args.teacher_model, num_classes=num_classes, device=device)
    if args.teacher_ckpt:
        teacher.load_state_dict(load_state_dict_file(args.teacher_ckpt), strict=True)
    n = sum(p.numel() for p in teacher.parameters())
    log(f"teacher {args.teacher_model}: {n / 1e6:.2f}M params, "
        f"{args.teacher_ckpt or 'seeded weights (no --teacher-ckpt)'}")
    return make_teacher_apply(teacher, dtype)


class Checkpoints:
    """``epoch_NNNN.pt`` files in ``root``, written atomically; the newest ``keep``
    and the best by acc1 are kept (``metrics.json`` holds each epoch's acc1)."""

    def __init__(self, root: Path, keep: int = CKPT_KEEP):
        self.root = root
        self.keep = keep
        self.root.mkdir(parents=True, exist_ok=True)
        self._metrics_path = root / "metrics.json"
        self.metrics = (json.loads(self._metrics_path.read_text())
                        if self._metrics_path.exists() else {})

    def epochs(self) -> list:
        return sorted(int(p.stem.split("_")[1]) for p in self.root.glob("epoch_*.pt"))

    def path(self, epoch: int) -> Path:
        return self.root / f"epoch_{epoch:04d}.pt"

    def save(self, epoch: int, state: dict, acc1: float) -> None:
        tmp = self.root / f".epoch_{epoch:04d}.pt.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(epoch))
        self.metrics[str(epoch)] = acc1
        self._metrics_path.write_text(json.dumps(self.metrics))
        saved = self.epochs()
        best = max(saved, key=lambda e: self.metrics.get(str(e), 0.0))
        for e in saved[:-self.keep]:
            if e != best:
                self.path(e).unlink()

    def latest(self):
        saved = self.epochs()
        return saved[-1] if saved else None


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)

    from recnext_tpu_torch.data.datasets import build_dataset
    from recnext_tpu_torch.data.loader import eval_loader, train_loader
    from recnext_tpu_torch.data.transforms import EvalTransform, SimpleTrainTransform
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.registry import create_model, get_config, parse_kv_overrides
    from recnext_tpu_torch.train.optim import cosine_schedule, make_optimizer, scaled_lr
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import make_fused_eval_step, make_train_step

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "args.json").write_text(json.dumps(vars(args), indent=1))

    def log(msg):
        print(msg, flush=True)

    log(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                               if device.type == "cuda" else ""))
    train_ds, nb_classes = build_dataset(True, args.data_set, "", args.input_size,
                                         args.fake_classes)
    val_ds, _ = build_dataset(False, args.data_set, "", args.input_size, args.fake_classes)
    distill = args.distillation_type != "none"
    overrides = dict(parse_kv_overrides(args.model_kwargs), num_classes=nb_classes)
    if distill:
        overrides["distillation"] = True  # the dual-head student
    model = create_model(args.model, device=device,
                         generator=torch.Generator().manual_seed(args.seed), **overrides)
    n_parameters = sum(p.numel() for p in model.parameters())
    log(f"model {args.model}: {n_parameters / 1e6:.2f}M params, {nb_classes} classes")

    steps_per_epoch = args.steps_per_epoch or max(len(train_ds) // args.batch_size, 1)
    sched = cosine_schedule(scaled_lr(args.lr, args.batch_size), steps_per_epoch, args.epochs,
                            args.warmup_epochs, args.cooldown_epochs, args.warmup_lr,
                            args.min_lr)
    optimizer = make_optimizer(model.named_parameters(), sched, args.weight_decay,
                               args.clip_grad)
    state = TrainState.create(model, optimizer, ema=not args.no_model_ema)

    # either alpha 0 disables that branch alone; both 0 disable mixing
    use_mix = args.mixup > 0 or args.cutmix > 0
    switch_prob = 0.5 if args.mixup > 0 and args.cutmix > 0 else (
        1.0 if args.cutmix > 0 else 0.0)
    teacher_apply = (build_teacher(args, nb_classes, device, dtype, log)
                     if distill and not args.eval else None)
    train_step = make_train_step(
        num_classes=nb_classes, mixup=use_mix,
        mixup_kwargs=dict(mixup_alpha=max(args.mixup, 1e-8),
                          cutmix_alpha=max(args.cutmix, 1e-8), switch_prob=switch_prob),
        smoothing=args.smoothing, ema_decay=args.model_ema_decay, dtype=dtype,
        teacher_apply=teacher_apply,
        distillation=args.distillation_type if teacher_apply else "none",
        alpha=args.distillation_alpha, tau=args.distillation_tau)
    cfg = get_config(args.model, **overrides)
    eval_step = make_fused_eval_step(cfg, dtype=dtype)
    eval_ema = None
    if not args.no_model_ema and not args.eval:
        eval_ema = make_fused_eval_step(cfg, ema=True, dtype=dtype)

    ckpts = Checkpoints(out_dir.resolve() / "ckpt")
    start_epoch = 0
    latest = ckpts.latest()
    if latest is not None:
        saved = torch.load(ckpts.path(latest), map_location=device, weights_only=True)
        state.load_state_dict(saved["state"])
        start_epoch = latest + 1
        log(f"auto-resumed at epoch {start_epoch}")

    def run_evals(*fns):
        """Summed over the eval split (one pass scores every weight set)."""
        tots = [{"correct1": 0, "correct5": 0, "count": 0, "loss_sum": 0.0} for _ in fns]
        loader = eval_loader(val_ds, EvalTransform(args.input_size),
                             batch_size=args.batch_size)
        for i, batch in enumerate(loader):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            batch = {k: v.to(device) for k, v in batch.items()}
            for tot, fn in zip(tots, fns):
                m = fn(state, batch)
                for k in tot:
                    tot[k] += m[k].item()
        return [(100.0 * t["correct1"] / max(t["count"], 1),
                 100.0 * t["correct5"] / max(t["count"], 1),
                 t["loss_sum"] / max(t["count"], 1)) for t in tots]

    if args.eval:
        acc1, acc5, test_loss = run_evals(eval_step)[0]
        log(json.dumps({"test_loss": test_loss, "test_acc1": acc1, "test_acc5": acc5}))
        return {"acc1": acc1, "acc5": acc5, "test_loss": test_loss}

    tt = SimpleTrainTransform(args.input_size)
    max_acc = max(ckpts.metrics.values(), default=0.0)
    for epoch in range(start_epoch, args.epochs + args.cooldown_epochs):
        t0 = time.time()
        loader = train_loader(train_ds, tt, batch_size=args.batch_size, epoch=epoch,
                              seed=args.seed)
        losses, seen = [], 0
        for i, batch in enumerate(loader):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
            # the mixup draws of step s: a generator seeded by (seed, s), so a resumed
            # run draws what an uninterrupted one would
            gen = torch.Generator().manual_seed(args.seed * 2 ** 32 + state.step)
            metrics = train_step(state, batch, gen)
            if (i + 1) % args.log_every == 0:
                loss = metrics["loss"].item()
                if not math.isfinite(loss):
                    raise SystemExit(f"Loss is {loss}, stopping training")
                log(f"epoch {epoch} step {i + 1}: loss {loss:.4f}")
            losses.append(metrics["loss"])
            seen += args.batch_size
        train_loss = torch.stack(losses).mean().item() if losses else float("nan")
        if not math.isfinite(train_loss):
            raise SystemExit(f"Loss is {train_loss}, stopping training")
        ema_stats = {}
        if eval_ema is not None:
            (acc1, acc5, test_loss), (ema_acc1, ema_acc5, _) = run_evals(eval_step, eval_ema)
            ema_stats = {"ema_test_acc1": ema_acc1, "ema_test_acc5": ema_acc5}
        else:
            acc1, acc5, test_loss = run_evals(eval_step)[0]
        max_acc = max(max_acc, acc1)
        elapsed = time.time() - t0
        # the schedule at the update count, as the JAX CLI logs it
        stats = {"train_lr": sched(state.step), "train_loss": train_loss,
                 "test_loss": round(test_loss, 6), "test_acc1": acc1, "test_acc5": acc5,
                 "epoch": epoch, "n_parameters": n_parameters,
                 "epoch_time_s": round(elapsed, 1),
                 "images_per_sec": round(seen / max(elapsed, 1e-9), 1), **ema_stats}
        log(json.dumps(stats))
        with open(out_dir / "log.txt", "a") as f:
            f.write(json.dumps(stats) + "\n")
        csv_path = out_dir / "summary.csv"
        header = not csv_path.exists()
        with open(csv_path, "a") as f:
            if header:
                f.write(",".join(stats.keys()) + "\n")
            f.write(",".join(str(v) for v in stats.values()) + "\n")
        ckpts.save(epoch, {"epoch": epoch, "state": state.state_dict()}, acc1)
    log(f"max accuracy: {max_acc:.2f}%")
    return {"max_acc": max_acc, "state": state}


if __name__ == "__main__":
    main()
