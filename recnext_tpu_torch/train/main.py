"""Training CLI: ``python -m recnext_tpu_torch.train.main``.

Counterpart of ``recnext_tpu/train/main.py`` for the subset the port runs so far:
one device (the GPU unless ``--device cpu``), the M, A and L families (on the GPU
through their kernels and the kernels' backward), every data set of the JAX CLI
(``--data-set``, ``--data-path``; FAKE is synthetic) through the reference recipe's
train transform (RandomResizedCrop, flip, RandAugment rand-m9-mstd0.5-inc1 or
``--ThreeAugment`` or jitter alone under ``--no-aa``, RandomErasing ``--reprob``;
``--simple-aug`` for crop, flip and normalize only) and the repeated-augmentation
sampler (``--no-repeated-aug``: a seeded permutation), decoded by PIL or by the C++
decoder (``--native-loader``, which raises where it cannot be built) in one thread
or ``--workers`` processes, each batch copied to the card from pinned memory;
mixup/cutmix and label smoothing, hard or soft distillation from a teacher
(``--distillation-type``, ``--teacher-model`` regnety_160/040/016 or a registry model,
``--teacher-ckpt``), AGC (or ``--clip-mode norm``) + AdamW with the reference cosine
schedule, EMA, bf16 compute with fp32 parameters (``--dtype``), a per-epoch BN-fused
eval of the model and of its EMA (the M and A families through the packed executor;
unfused with ``--no-fused-eval``, and always for MLLA), a checkpoint each epoch (``torch.save``; the last 3 and the best kept) and
auto-resume from the newest. The
per-epoch JSON line and ``log.txt`` keep the JAX CLI's key names, and add the train
loop's seconds and images per second, the seconds it waited on the loader (and on its
first batch, which includes starting the workers), the loaders' routes ("native",
"pil", or "pil (...)" where the native route was asked for and does not apply) and
the batches that fell back from the native decoder to PIL.

The teacher's ``--teacher-ckpt`` is a ``.pth``/``.pt`` state dict (timm's layout for a
RegNetY, the published DeiT ``regnety_160`` one included; the port's own for a
registry model), loaded strictly; without one the teacher is a seeded init, as the
JAX CLI's ``init(PRNGKey(1))``. ``--finetune`` warm-starts the model's weights
from a checkpoint (``train/finetune.py``: a reference ``.pth``, this trainer's
checkpoint, a fused archive; a head of another class count is dropped);
``--grad-accum`` averages that many micro-batches an update, ``--remat``
recomputes each block in the backward, ``--mesa`` adds MESA's self-distillation
from the EMA model after ``--mesa-start-ratio`` of the epochs, ``--jsd-loss`` the JSD
loss over ``--aug-splits`` views of each sample (the first through the simple
transform). ``--finetune`` and ``--teacher-ckpt`` also read the JAX package's
``.msgpack`` files (its own decoder, ``utils/msgpack.py``); orbax directories raise,
naming their ROADMAP item. ``--set-bn-eval`` keeps every BatchNorm on its running statistics
(``RecNext(frozen_stats=True)``). The JAX CLI's
``--loader grain --workers N`` is ``--workers N`` here (the default 0 is the JAX
CLI's default, one prefetch thread); grain's own sampling order is not ported.

The JAX CLI's remaining flags: ``--resume PATH`` restores a checkpoint of this
trainer and starts at epoch ``state.step // steps_per_epoch``, as the JAX CLI does,
so a mid-epoch recovery checkpoint replays its epoch from batch 0 with the recovered
state; ``--ckpt-every-steps N`` writes ``recovery.pt`` (atomically, replacing the
last) every N steps; ``--eval-ema`` scores the EMA weights alone in each epoch's eval;
``--export-teacher PATH`` saves the final weights (the EMA's, the raw ones under
``--no-model-ema``) as a ``.pt`` state dict that ``--teacher-ckpt`` reads with
``--teacher-model`` the same model; ``--wandb`` logs each epoch's line to wandb where
it imports. Several processes train one model on the global batch
(``parallel/sharding.py``): ``--dist-coordinator host:port --dist-num-processes N
--dist-process-id R``, or torchrun's environment. ``--batch-size`` is the global
batch (each process takes ``batch_size // N``); every rank starts from rank 0's
weights and the same checkpoint; rank 0 alone logs and writes ``log.txt``,
``summary.csv`` and the checkpoints. ``--fsdp`` > 1 raises (not ported).

Two processes on the CPU (gloo), a global batch of 8:
  for r in 0 1; do python -m recnext_tpu_torch.train.main --device cpu --model recnext_m0 \\
      --model-kwargs embed_dim=16:32:64:128,depth=1:1:2:1 --data-set FAKE --simple-aug \\
      --input-size 32 --batch-size 8 --epochs 1 --steps-per-epoch 2 --fake-classes 11 \\
      --dist-coordinator localhost:29511 --dist-num-processes 2 --dist-process-id $r \\
      --output-dir runs/two & done; wait

Smoke run on the CPU (a small M config; it resumes from the checkpoints that
--output-dir already holds, so empty it first):
  rm -rf runs/smoke
  python -m recnext_tpu_torch.train.main --device cpu --model recnext_m0 \\
      --model-kwargs embed_dim=16:32:64:128,depth=1:1:2:1 --data-set FAKE \\
      --simple-aug --input-size 32 --batch-size 4 --epochs 2 --steps-per-epoch 2 \\
      --fake-classes 11 --dtype float32 --output-dir runs/smoke

The 384^2 finetune recipe on recnext_m1 from a checkpoint of the 224^2 run, on a
data set of another class count, two micro-batches an update, blocks recomputed in
the backward, MESA from the start:
  python -m recnext_tpu_torch.train.main --model recnext_m1 --finetune \
      runs/m1/ckpt/epoch_0299.pt --input-size 384 --data-set FAKE --simple-aug \
      --fake-classes 100 --batch-size 32 --grad-accum 2 --remat --mesa 1.0 \
      --mesa-start-ratio 0 --epochs 30 --output-dir runs/m1_384

recnext_m1 with the reference recipe on a folder of JPEGs (<path>/train/<class>/...,
<path>/val/<class>/...), decoded in C++ by 8 worker processes:
  python -m recnext_tpu_torch.train.main --model recnext_m1 --data-set FOLDER \
      --data-path <path> --native-loader --workers 8 --batch-size 128 \
      --output-dir runs/m1_folder

recnext_a1 with the reference recipe's hard distillation from a (seeded) regnety_160
teacher on the GPU:
  python -m recnext_tpu_torch.train.main --model recnext_a1 --distillation-type hard \
      --teacher-model regnety_160 --data-set FAKE --simple-aug --batch-size 64 \
      --epochs 2 --steps-per-epoch 3 --output-dir runs/a1_distill

recnext_t (the L family, through K2 and K2') on FAKE data on the GPU:
  python -m recnext_tpu_torch.train.main --model recnext_t --data-set FAKE --simple-aug \\
      --batch-size 128 --epochs 2 --steps-per-epoch 3 --output-dir runs/t_fake

The MLLA graft family (``mlla_{nano,mini}_{recconv,recattn,recattn_simple}``) with its
recipe from a ``--config`` preset (a flat YAML file, ``train/config.py``: its values are
the defaults, the command line overrides them): global-norm clipping (``--clip-mode
norm --clip-grad 5.0``), MESA, 256^2; evaluated unfused (no BatchNorm past the stem),
no distillation head, no frozen BN:
  python -m recnext_tpu_torch.train.main --config configs/mlla_mini_300e.yaml \\
      --model mlla_mini_recconv --data-set FAKE --batch-size 128 --epochs 2 \\
      --steps-per-epoch 3 --output-dir runs/mlla_mini
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

import torch

from recnext_tpu_torch.train.config import apply_config
from recnext_tpu_torch.train.finetune import read_weights

CKPT_KEEP = 3


def parse_args(argv=None):
    """Two stages, as the JAX CLI's: a ``--config`` file gives defaults, the command
    line overrides them."""
    cfg_parser = argparse.ArgumentParser(add_help=False)
    cfg_parser.add_argument("--config", default="",
                            help="flat YAML of argument defaults (configs/*.yaml)")
    cfg_args, remaining = cfg_parser.parse_known_args(argv)
    p = argparse.ArgumentParser("RecNext training (PyTorch/CUDA port)", parents=[cfg_parser])
    p.add_argument("--model", default="recnext_m1")
    p.add_argument("--model-kwargs", default="",
                   help="comma-separated RecNextConfig overrides, tuples with ':', e.g. "
                        "embed_dim=16:32:64:128,depth=1:1:2:1")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.025)
    p.add_argument("--clip-grad", type=float, default=0.02, help="gradient clip value")
    p.add_argument("--clip-mode", default="agc", choices=["agc", "norm"],
                   help="'agc': adaptive clip (the RecNeXt recipe); 'norm': global-norm "
                        "clip (the MLLA recipe, 5.0)")
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--cooldown-epochs", type=int, default=0)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--ThreeAugment", action="store_true")
    p.add_argument("--simple-aug", action="store_true",
                   help="RRC + flip + normalize only (no RA/jitter/erasing)")
    p.add_argument("--fake-classes", type=int, default=1000)
    p.add_argument("--aa-magnitude", type=float, default=9.0)
    p.add_argument("--no-aa", action="store_true",
                   help="disable RandAugment (the reference's --aa ''); color jitter then "
                        "applies")
    p.add_argument("--color-jitter", type=float, default=0.4)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--no-repeated-aug", action="store_true")
    p.add_argument("--distillation-type", default="none", choices=["none", "hard", "soft"])
    p.add_argument("--distillation-alpha", type=float, default=0.5)
    p.add_argument("--distillation-tau", type=float, default=1.0)
    p.add_argument("--teacher-ckpt", default="",
                   help=".pth/.pt state dict of the teacher (timm's layout for a RegNetY, "
                        "the port's for a registry model) or the JAX package's .msgpack "
                        "variables; none: a seeded init")
    p.add_argument("--teacher-model", default="",
                   help="the teacher: regnety_160/040/016 or a registry model")
    p.add_argument("--model-ema-decay", type=float, default=0.99996)
    p.add_argument("--no-model-ema", action="store_true")
    p.add_argument("--mesa", type=float, default=0.0,
                   help="weight of the EMA-teacher self-distillation loss (softCE against "
                        "the EMA model's softmax); 0 = off")
    p.add_argument("--mesa-start-ratio", type=float, default=0.25,
                   help="fraction of the epochs after which MESA starts")
    p.add_argument("--finetune", default="",
                   help="warm-start the model weights from a checkpoint (.pth/.pt/.bin: a "
                        "reference state dict, this trainer's checkpoint, a fused "
                        "archive; .msgpack: the JAX package's variables); leaves of "
                        "another shape (the head) are dropped")
    p.add_argument("--set-bn-eval", action="store_true",
                   help="freeze BatchNorm while finetuning: running statistics in the "
                        "forward, no updates (RecNext families)")
    p.add_argument("--jsd-loss", action="store_true",
                   help="JSD consistency loss over --aug-splits views")
    p.add_argument("--aug-splits", type=int, default=0,
                   help="augmentation splits per batch (0/1 = off); split 0 is the clean "
                        "view")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches averaged into one update (optax.MultiSteps)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's forward in the backward")
    p.add_argument("--data-set", default="IMNET",
                   choices=["IMNET", "CIFAR", "FOLDER", "FAKE", "IMNETEE", "FLOWERS", "INAT",
                            "INAT19"])
    p.add_argument("--data-path", default="")
    p.add_argument("--native-loader", action="store_true",
                   help="C++ fused decode + RandomResizedCrop + flip train path and fused "
                        "bicubic eval path (class folders; raises where it cannot be built)")
    p.add_argument("--workers", type=int, default=0,
                   help="loader worker processes (0: one prefetch thread)")
    p.add_argument("--output-dir", default="runs/default")
    p.add_argument("--resume", default="",
                   help="a checkpoint of this trainer to restore (epoch_NNNN.pt or "
                        "recovery.pt); training starts at epoch state.step // "
                        "steps_per_epoch")
    p.add_argument("--eval", action="store_true", help="evaluate the newest checkpoint")
    p.add_argument("--eval-ema", action="store_true",
                   help="each epoch's eval scores the EMA weights only")
    p.add_argument("--no-fused-eval", action="store_true",
                   help="evaluate each epoch through the unfused model (MLLA always is)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="truncate each epoch (and its eval) to this many batches; 0 = all")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every-steps", type=int, default=0,
                   help="write <output-dir>/recovery.pt every N steps (0 = off)")
    p.add_argument("--export-teacher", default="",
                   help="after training, save the final weights (EMA unless "
                        "--no-model-ema) as a .pt state dict for --teacher-ckpt")
    p.add_argument("--wandb", action="store_true", help="log to wandb where it imports")
    p.add_argument("--fsdp", type=int, default=1, help="1 only (FSDP is not ported)")
    p.add_argument("--dist-coordinator", default="",
                   help="host:port of rank 0; starts torch.distributed (else torchrun's "
                        "environment, if set)")
    p.add_argument("--dist-num-processes", type=int, default=0)
    p.add_argument("--dist-process-id", type=int, default=-1)
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    if cfg_args.config:
        apply_config(p, cfg_args.config)
    return p.parse_args(remaining)


def _refuse_unported(args) -> None:
    if args.model.startswith("mlla") and args.distillation_type != "none":
        raise SystemExit("mlla models have no distillation head; use --mesa for the "
                         "MLLA recipe's self-distillation")
    if args.set_bn_eval and args.model.startswith(("regnet", "mlla")):
        raise SystemExit("--set-bn-eval is a RecNext-family finetune knob")
    if args.distillation_type != "none" and not args.teacher_model:
        raise SystemExit("--distillation-type requires --teacher-model")
    if args.jsd_loss and args.aug_splits < 2:
        raise SystemExit("--jsd-loss requires --aug-splits >= 2")
    if args.jsd_loss and args.distillation_type != "none":
        raise SystemExit("--jsd-loss is incompatible with distillation")
    if args.mesa > 0 and args.no_model_ema:
        raise SystemExit("--mesa needs the EMA model as its teacher (drop --no-model-ema)")
    if args.mesa > 0 and args.distillation_type != "none":
        raise SystemExit("--mesa is incompatible with distillation")
    if args.fsdp > 1:
        from recnext_tpu_torch.parallel.sharding import make_mesh

        make_mesh(fsdp=args.fsdp)  # raises, naming the ROADMAP item


def build_teacher(args, num_classes: int, device: torch.device, dtype: torch.dtype, log):
    """``teacher_apply`` for the train step: ``--teacher-model`` with the weights of
    ``--teacher-ckpt`` (strict), or seeded."""
    from recnext_tpu_torch.train.step import create_teacher, make_teacher_apply

    teacher = create_teacher(args.teacher_model, num_classes=num_classes, device=device)
    if args.teacher_ckpt:
        teacher.load_state_dict(read_weights(args.teacher_ckpt, ema=False), strict=True)
    n = sum(p.numel() for p in teacher.parameters())
    log(f"teacher {args.teacher_model}: {n / 1e6:.2f}M params, "
        f"{args.teacher_ckpt or 'seeded weights (no --teacher-ckpt)'}")
    return make_teacher_apply(teacher, dtype)


class Checkpoints:
    """``{stem}_NNNN.pt`` files in ``root`` (``stem`` "epoch", or "iter" for the
    segmentation trainer), written atomically; the newest ``keep`` are kept, and the
    best by acc1 where ``save`` is given one (``metrics.json`` holds each acc1)."""

    def __init__(self, root: Path, keep: int = CKPT_KEEP, stem: str = "epoch"):
        self.root = root
        self.keep = keep
        self.stem = stem
        self.root.mkdir(parents=True, exist_ok=True)
        self._metrics_path = root / "metrics.json"
        self.metrics = (json.loads(self._metrics_path.read_text())
                        if self._metrics_path.exists() else {})

    def epochs(self) -> list:
        return sorted(int(p.stem.split("_")[1]) for p in self.root.glob(f"{self.stem}_*.pt"))

    def path(self, epoch: int) -> Path:
        return self.root / f"{self.stem}_{epoch:04d}.pt"

    def save(self, epoch: int, state: dict, acc1: float | None = None) -> None:
        save_atomic(state, self.path(epoch))
        if acc1 is not None:
            self.metrics[str(epoch)] = acc1
            self._metrics_path.write_text(json.dumps(self.metrics))
        saved = self.epochs()
        best = (max(saved, key=lambda e: self.metrics.get(str(e), 0.0)) if self.metrics
                else None)
        for e in saved[:-self.keep]:
            if e != best:
                self.path(e).unlink()

    def latest(self):
        saved = self.epochs()
        return saved[-1] if saved else None


def save_atomic(obj, path: Path) -> None:
    """``torch.save`` to a temporary name, then renamed over ``path``."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)
    from recnext_tpu_torch.parallel.sharding import init_distributed

    device_type = torch.device(args.device or "cuda").type
    started = init_distributed(args.dist_coordinator, args.dist_num_processes,
                               args.dist_process_id, device_type=device_type)
    try:
        return _train(args)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _train(args):
    from recnext_tpu_torch.data.datasets import build_dataset
    from recnext_tpu_torch.data.loader import eval_loader, train_loader
    from recnext_tpu_torch.data.transforms import (EvalTransform, SimpleTrainTransform,
                                                   TrainTransform)
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.mlla import create_mlla
    from recnext_tpu_torch.models.registry import create_model, get_config, parse_kv_overrides
    from recnext_tpu_torch.parallel.sharding import (all_reduce_sum, broadcast_tensors,
                                                     local_device, rank, world_size)
    from recnext_tpu_torch.train.optim import cosine_schedule, make_optimizer, scaled_lr
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import (make_eval_step, make_fused_eval_step,
                                              make_train_step)

    device = local_device(resolve_device(args.device))
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    n_proc, is_main = world_size(), rank() == 0
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if is_main:
        (out_dir / "args.json").write_text(json.dumps(vars(args), indent=1))

    def log(msg):
        if is_main:
            print(msg, flush=True)

    log(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                               if device.type == "cuda" else "")
        + (f", {n_proc} processes" if n_proc > 1 else ""))
    wandb_run = None
    if args.wandb and is_main:
        try:
            import wandb

            wandb_run = wandb.init(project="recnext_tpu_torch", config=vars(args))
        except Exception:
            log("wandb requested but unavailable; continuing without it")
    train_ds, nb_classes = build_dataset(True, args.data_set, args.data_path, args.input_size,
                                         args.fake_classes)
    val_ds, _ = build_dataset(False, args.data_set, args.data_path, args.input_size,
                              args.fake_classes)
    distill = args.distillation_type != "none"
    mlla = args.model.startswith("mlla")
    overrides = dict(parse_kv_overrides(args.model_kwargs), num_classes=nb_classes)
    if distill:
        overrides["distillation"] = True  # the dual-head student
    frozen = {} if mlla else {"frozen_stats": args.set_bn_eval}
    model = (create_mlla if mlla else create_model)(
        args.model, device=device, generator=torch.Generator().manual_seed(args.seed),
        **frozen, **overrides)
    if args.finetune:
        # weights only; the optimizer, schedule and epoch start fresh
        from recnext_tpu_torch.train.finetune import load_pretrained

        model.load_state_dict(load_pretrained(args.finetune, model.state_dict(), log=log),
                              strict=True)
    broadcast_tensors(model.state_dict().values())  # every rank starts from rank 0's
    n_parameters = sum(p.numel() for p in model.parameters())
    log(f"model {args.model}: {n_parameters / 1e6:.2f}M params, {nb_classes} classes")

    # the global batch, as the JAX CLI's: each process takes its rows of it
    local_bs = max(args.batch_size // n_proc, 1)
    steps_per_epoch = args.steps_per_epoch or max(len(train_ds) // args.batch_size, 1)
    sched = cosine_schedule(scaled_lr(args.lr, args.batch_size), steps_per_epoch, args.epochs,
                            args.warmup_epochs, args.cooldown_epochs, args.warmup_lr,
                            args.min_lr)
    # the optimizer reads the schedule at its update count: under accumulation map it
    # back to micro-steps, as the JAX CLI does
    k = args.grad_accum
    sched_opt = sched if k <= 1 else (lambda u: sched(u * k))
    optimizer = make_optimizer(model.named_parameters(), sched_opt, args.weight_decay,
                               args.clip_grad, grad_accum=k, clip_mode=args.clip_mode)
    state = TrainState.create(model, optimizer, ema=not args.no_model_ema)

    # either alpha 0 disables that branch alone; both 0 disable mixing; the JSD loss
    # takes its views unmixed
    use_mix = (args.mixup > 0 or args.cutmix > 0) and not args.jsd_loss
    splits = args.aug_splits if args.jsd_loss else 0
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
        alpha=args.distillation_alpha, tau=args.distillation_tau, remat=args.remat,
        jsd_splits=splits, grad_accum=k, mesa=args.mesa,
        mesa_start_step=int(args.mesa_start_ratio * args.epochs * steps_per_epoch))
    # MLLA has no fused form: its eval is the unfused model's, as with --no-fused-eval;
    # the M and A families' fused eval runs the packed executor, as the JAX trainer's
    if mlla or args.no_fused_eval:
        make_eval = lambda ema: make_eval_step(model, ema=ema, dtype=dtype)  # noqa: E731
    else:
        cfg = get_config(args.model, **overrides)
        make_eval = lambda ema: make_fused_eval_step(  # noqa: E731
            cfg, ema=ema, packed=True, dtype=dtype)
    eval_step = make_eval(args.eval_ema)
    eval_ema = (make_eval(True) if not (args.no_model_ema or args.eval_ema or args.eval)
                else None)

    ckpts = Checkpoints(out_dir.resolve() / "ckpt")
    start_epoch = 0
    latest = ckpts.latest()
    if args.resume:
        saved = torch.load(args.resume, map_location=device, weights_only=True)
        state.load_state_dict(saved["state"])
        start_epoch = state.step // steps_per_epoch
        log(f"resumed from {args.resume} at epoch {start_epoch}")
    elif latest is not None:
        saved = torch.load(ckpts.path(latest), map_location=device, weights_only=True)
        state.load_state_dict(saved["state"])
        start_epoch = latest + 1
        log(f"auto-resumed at epoch {start_epoch}")

    pin = device.type == "cuda"
    routes = {}

    def run_evals(*fns):
        """Summed over the eval split, strided over the processes and summed over them
        (one pass scores every weight set)."""
        tots = torch.zeros(len(fns), 4, dtype=torch.float64)
        loader = eval_loader(val_ds, EvalTransform(args.input_size), batch_size=local_bs,
                             rank=rank(), num_replicas=n_proc, native=args.native_loader,
                             workers=args.workers, pin_memory=pin)
        keys = ("correct1", "correct5", "count", "loss_sum")
        for i, batch in enumerate(loader):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
            for tot, fn in zip(tots, fns):
                m = fn(state, batch)
                tot += torch.tensor([m[k].item() for k in keys], dtype=torch.float64)
        all_reduce_sum(tots)
        routes["eval_loader_route"] = loader.route
        return [(100.0 * float(c1) / max(float(n), 1), 100.0 * float(c5) / max(float(n), 1),
                 float(ls) / max(float(n), 1)) for c1, c5, n, ls in tots]

    if args.eval:
        acc1, acc5, test_loss = run_evals(eval_step)[0]
        log(json.dumps({"test_loss": test_loss, "test_acc1": acc1, "test_acc5": acc5}))
        return {"acc1": acc1, "acc5": acc5, "test_loss": test_loss}

    if args.simple_aug:
        tt = SimpleTrainTransform(args.input_size)
    else:
        tt = TrainTransform(args.input_size, three_augment=args.ThreeAugment,
                            auto_augment=not args.no_aa, ra_magnitude=args.aa_magnitude,
                            jitter=args.color_jitter, reprob=args.reprob)
    max_acc = max(ckpts.metrics.values(), default=0.0)
    for epoch in range(start_epoch, args.epochs + args.cooldown_epochs):
        t0 = time.time()
        loader = train_loader(train_ds, tt,
                              batch_size=local_bs // splits if splits > 1 else local_bs,
                              epoch=epoch, rank=rank(), num_replicas=n_proc,
                              repeated_aug=not args.no_repeated_aug, seed=args.seed,
                              aug_splits=splits,
                              clean_transform=SimpleTrainTransform(args.input_size)
                              if splits > 1 else None,
                              native=args.native_loader, workers=args.workers,
                              pin_memory=pin)
        losses, seen, waits = [], 0, []
        batches = iter(loader)
        for i in range(args.steps_per_epoch or len(loader)):
            t = time.perf_counter()
            batch = next(batches, None)
            waits.append(time.perf_counter() - t)  # the host blocked on the loader
            if batch is None:
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
            seen += int(batch["label"].shape[0]) * n_proc
            if args.ckpt_every_steps and (i + 1) % args.ckpt_every_steps == 0 and is_main:
                save_atomic({"epoch": epoch, "state": state.state_dict()},
                            out_dir / "recovery.pt")
                log(f"recovery checkpoint at epoch {epoch} step {i + 1}")
        batches.close()  # the workers end before the eval's start
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.time() - t0
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
        # the lr the optimizer applies, as the JAX CLI logs it
        stats = {"train_lr": sched_opt(state.step // k), "train_loss": train_loss,
                 "test_loss": round(test_loss, 6), "test_acc1": acc1, "test_acc5": acc5,
                 "epoch": epoch, "n_parameters": n_parameters,
                 "epoch_time_s": round(elapsed, 1),
                 "images_per_sec": round(seen / max(elapsed, 1e-9), 1),
                 "train_images_per_sec": round(seen / max(train_s, 1e-9), 1),
                 "train_s": round(train_s, 3), "loader_wait_s": round(sum(waits), 3),
                 "loader_first_batch_s": round(waits[0], 3) if waits else None, **ema_stats,
                 "loader_route": loader.route, **routes, "workers": args.workers,
                 "native_fallback_batches": loader.native_fallback_batches}
        log(json.dumps(stats))
        if wandb_run is not None:
            wandb_run.log(stats, step=epoch)
        if is_main:
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
    if args.export_teacher and is_main:
        use_ema = not args.no_model_ema
        teacher = {k: v.detach().cpu() for k, v in state.variables(ema=use_ema).items()}
        path = Path(args.export_teacher)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_atomic(teacher, path)
        log(f"exported {'EMA ' if use_ema else ''}teacher weights to {path}")
    return {"max_acc": max_acc, "state": state}


if __name__ == "__main__":
    main()
