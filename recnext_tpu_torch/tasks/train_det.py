"""Detection training CLI: ``python -m recnext_tpu_torch.tasks.train_det``.

Counterpart of ``recnext_tpu/tasks/train_det.py`` (the reference's mmdet harness and
its 1x configs: AdamW lr 2e-4, weight decay 0.05 on every parameter, 12 epochs with
decays at 8 and 11 and mmdet's 500-iteration linear warm-up, COCO bbox mAP), with the
same flags and defaults, on the GPU unless ``--device cpu``. The port trains the
single-stage detector, ``--detector retinanet``; the two-stage Mask R-CNN (the JAX
CLI's default ``--detector mask_rcnn``), ``--with-mask`` and ``--num-proposals`` raise,
naming their ROADMAP item.

* ``--preset`` takes a recipe of ``tasks/configs.py`` as the defaults; its img_scale
  (1333, 800) becomes the square ``--img-size`` of its short side, 800;
* ``--data-set FAKE`` (coloured rectangles on noise; the AP loop runs over a seeded
  synthetic set) or ``COCO`` (a COCO-format folder, ``data/coco.py``);
* ``--init-ckpt`` loads a classification checkpoint into the backbone;
* a ``torch.save`` checkpoint each epoch, the last 3 kept; ``--resume`` continues from
  the newest, ``--eval-only`` reports its AP, ``--benchmark N`` the inference (forward
  and post-process) images per second over N batches.

The RetinaNet's backbone BN trains (``frozen_backbone_stats=False``), as the JAX CLI
builds it, although the presets say frozen. The anchors follow the pyramid's level
sizes (each level halves, rounding up: P6 is 13^2 at 800^2).

The recipe on the card with FAKE data, from a classification checkpoint:
  python -m recnext_tpu_torch.tasks.train_det --preset det_recnext_m3_fpn_1x_coco \\
      --detector retinanet --init-ckpt runs/m3/ckpt/epoch_0299.pt --epochs 2 \\
      --steps-per-epoch 3 --eval-max-images 32 --output-dir runs/det_m3
A small run on the CPU:
  python -m recnext_tpu_torch.tasks.train_det --device cpu --backbone recnext_m0 \\
      --detector retinanet --num-classes 4 --img-size 64 --batch-size 2 --fake-size 4 \\
      --epochs 1 --steps-per-epoch 2 --output-dir runs/det_small
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

F32 = np.float32
TWO_STAGE_ITEM = ("ROADMAP.md Queue 1 item 11's rest (Mask R-CNN: tasks/roi.py, "
                  "tasks/mask_rcnn.py, paste_masks, --detector mask_rcnn, --with-mask)")
STRIDES = (4, 8, 16, 32, 64)
NUM_ANCHOR_SHAPES = 9  # 3 scales x 3 ratios (generate_anchors' defaults)


def synthetic_det_batch(rng: np.random.Generator, batch: int, img: int, num_classes: int,
                        max_gt: int = 4):
    """The JAX package's coloured rectangles on noise, from the same draws; boxes and
    labels padded to ``max_gt`` with -1. The image is (N, 3, img, img)."""
    images = rng.normal(scale=0.3, size=(batch, img, img, 3)).astype(np.float32)
    boxes = np.full((batch, max_gt, 4), -1, np.float32)
    labels = np.full((batch, max_gt), -1, np.int32)
    for b in range(batch):
        n = int(rng.integers(1, max_gt + 1))
        for g in range(n):
            w, h = rng.integers(img // 6, img // 2, 2)
            x1 = int(rng.integers(0, img - w))
            y1 = int(rng.integers(0, img - h))
            cls = int(rng.integers(0, num_classes))
            color = np.random.default_rng(cls).uniform(-1.5, 1.5, 3)
            images[b, y1:y1 + h, x1:x1 + w] = color + rng.normal(scale=0.1, size=(h, w, 3))
            boxes[b, g] = [x1, y1, x1 + w, y1 + h]
            labels[b, g] = cls
    return {"image": np.ascontiguousarray(images.transpose(0, 3, 1, 2)), "gt_boxes": boxes,
            "gt_labels": labels}


def step_lr(base_lr: float, steps_per_epoch: int, decay_epochs=(8, 11), factor: float = 0.1,
            warmup_steps: int = 500, warmup_ratio: float = 0.001):
    """mmdet's 1x schedule: by-epoch decays and a linear warm-up over ``warmup_steps``
    from ``warmup_ratio``, in float32 as the JAX package computes it."""
    def sched(step: int) -> float:
        lr = F32(base_lr)
        for e in decay_epochs:
            if step // steps_per_epoch >= e:
                lr = lr * F32(factor)
        if warmup_steps > 0:
            frac = min(F32(step) / F32(warmup_steps), F32(1.0))
            lr = lr * (F32(warmup_ratio) + F32(1.0 - warmup_ratio) * frac)
        return float(lr)

    return sched


class FakeDetDataset:
    """The JAX package's deterministic synthetic detection set, with the COCO data
    set's eval surface (``gt_for_eval``, ``nb_classes``)."""

    def __init__(self, n: int, img: int, num_classes: int, max_gt: int = 4, seed: int = 0):
        self.n, self.img, self.nb_classes = n, img, num_classes
        self.max_gt, self.seed = max_gt, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        s = synthetic_det_batch(np.random.default_rng((self.seed, i)), 1, self.img,
                                self.nb_classes, self.max_gt)
        return {"image": s["image"][0], "gt_boxes": s["gt_boxes"][0],
                "gt_labels": s["gt_labels"][0], "image_id": i, "scale": 1.0,
                "orig_hw": (self.img, self.img)}

    def gt_for_eval(self, i: int):
        s = self[i]
        keep = s["gt_labels"] >= 0
        return {"boxes": s["gt_boxes"][keep], "labels": s["gt_labels"][keep],
                "iscrowd": np.zeros(int(keep.sum()), bool), "image_id": i}


def _det_batches(dataset, indices, batch_size, *, drop_last=True):
    from recnext_tpu_torch.data.coco import collate_det

    n = len(indices)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        yield collate_det([dataset[int(i)] for i in indices[start:start + batch_size]])


def evaluate_detection(dataset, predict_fn, *, batch_size: int, max_images: int = 0,
                       score_thresh: float = 0.05):
    """Inference over the val set in batches of one shape (the tail padded by cycling
    the indices), boxes mapped back to original coordinates, COCO AP.
    ``predict_fn(images (N, 3, S, S) numpy) -> (boxes, scores, labels, valid)``, each
    (N, D, ...) numpy."""
    from recnext_tpu_torch.tasks.coco_eval import COCOEvaluator

    ev = COCOEvaluator(dataset.nb_classes)
    n = min(len(dataset), max_images) if max_images else len(dataset)
    idx = list(range(n))
    pad = (-n) % batch_size
    padded = idx + (idx * (pad // n + 1))[:pad] if pad else idx
    seen = 0
    for batch in _det_batches(dataset, padded, batch_size, drop_last=False):
        boxes, scores, labels, valid = predict_fn(batch["image"])
        for b in range(len(boxes)):
            if seen >= n:
                break
            i = padded[seen]
            seen += 1
            keep = valid[b] & (scores[b] > score_thresh)
            scale = float(batch["scale"][b])
            orig_hw = batch["orig_hw"][b]
            pb = boxes[b][keep] / scale
            pb[:, 0::2] = pb[:, 0::2].clip(0, int(orig_hw[1]))
            pb[:, 1::2] = pb[:, 1::2].clip(0, int(orig_hw[0]))
            ev.add(dataset.gt_for_eval(i), {"boxes": pb, "scores": scores[b][keep],
                                            "labels": labels[b][keep]})
    return ev.summarize()


def apply_preset(p: argparse.ArgumentParser, preset: str) -> None:
    """A recipe of ``tasks/configs.py:DETECTION_CONFIGS`` as the parser's defaults;
    img_scale becomes the square ``--img-size`` of its short side."""
    from recnext_tpu_torch.tasks.configs import DETECTION_CONFIGS

    if preset not in DETECTION_CONFIGS:
        raise SystemExit(f"unknown preset {preset!r}; known: {sorted(DETECTION_CONFIGS)}")
    c = DETECTION_CONFIGS[preset]
    p.set_defaults(backbone=c["backbone"], lr=c["lr"], weight_decay=c["weight_decay"],
                   epochs=c["epochs"], decay_epochs=list(c["lr_decay_epochs"]),
                   batch_size=c["batch_size"], num_classes=c["num_classes"],
                   img_size=min(c["img_scale"]))


def pyramid_shapes(img_size: int, levels: int = len(STRIDES)):
    """The FPN's level sizes for a square input: the stem and each downsample (and the
    extra level's subsample) halve, rounding up."""
    side = (((img_size + 1) // 2) + 1) // 2  # the stem's two stride-2 convs
    shapes = []
    for _ in range(levels):
        shapes.append((side, side))
        side = (side + 1) // 2
    return shapes


def parse_args(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--preset", default="",
                     help="named recipe from tasks/configs.py, e.g. det_recnext_m3_fpn_1x_coco")
    pre_args, argv = pre.parse_known_args(argv)
    p = argparse.ArgumentParser("Detection training (PyTorch/CUDA port)")
    p.add_argument("--backbone", default="recnext_m3")
    p.add_argument("--detector", default="mask_rcnn", choices=["mask_rcnn", "retinanet"])
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="0 = one pass over the dataset (FAKE: 1000)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--decay-epochs", type=int, nargs="*", default=[8, 11],
                   help="step-decay epochs (mm 1x default: 8 11)")
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--num-proposals", type=int, default=None,
                   help="Mask R-CNN only (the JAX CLI's default: 128); not ported, raises")
    p.add_argument("--data-set", default="FAKE", choices=["FAKE", "COCO"])
    p.add_argument("--data-path", default="", help="COCO root (annotations/ + dirs)")
    p.add_argument("--ann-file", default="", help="override train annotation json")
    p.add_argument("--img-dir", default="", help="override train image dir")
    p.add_argument("--val-ann-file", default="")
    p.add_argument("--val-img-dir", default="")
    p.add_argument("--with-mask", action="store_true",
                   help="train/eval instance masks (Mask R-CNN only)")
    p.add_argument("--max-gt", type=int, default=48)
    p.add_argument("--fake-size", type=int, default=64, help="FAKE dataset size (train and val)")
    p.add_argument("--eval-every", type=int, default=1, help="epochs; 0 = never")
    p.add_argument("--eval-max-images", type=int, default=0, help="0 = all")
    p.add_argument("--eval-score-thresh", type=float, default=0.05)
    p.add_argument("--init-ckpt", default="", help="classification checkpoint (.pth/.pt)")
    p.add_argument("--resume", action="store_true",
                   help="auto-resume from the latest checkpoint in output-dir")
    p.add_argument("--eval-only", action="store_true",
                   help="restore the latest checkpoint and run the AP eval only")
    p.add_argument("--benchmark", type=int, default=0, metavar="ITERS",
                   help="measure inference images/sec over ITERS batches and exit")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="runs/det")
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    if pre_args.preset:
        apply_preset(p, pre_args.preset)
    return p.parse_args(argv)


def build_datasets(args):
    """(train set, val set or None, steps per epoch); COCO sets the class count."""
    if args.data_set == "COCO":
        from recnext_tpu_torch.data.coco import CocoDetection

        root = Path(args.data_path)
        ann = args.ann_file or str(root / "annotations/instances_train2017.json")
        img_dir = args.img_dir or str(root / "train2017")
        vann = args.val_ann_file or str(root / "annotations/instances_val2017.json")
        vimg = args.val_img_dir or str(root / "val2017")
        train_ds = CocoDetection(img_dir, ann, img_size=args.img_size, max_gt=args.max_gt,
                                 with_masks=False, train=True, seed=args.seed)
        val_ds = (CocoDetection(vimg, vann, img_size=args.img_size, max_gt=args.max_gt,
                                with_masks=False, train=False) if Path(vann).exists() else None)
        args.num_classes = train_ds.nb_classes
        return train_ds, val_ds, args.steps_per_epoch or max(1, len(train_ds) // args.batch_size)
    fake = FakeDetDataset(args.fake_size, args.img_size, args.num_classes, seed=args.seed)
    return fake, fake, args.steps_per_epoch or 1000


def make_predict_fn(model, anchors: torch.Tensor, level_sizes, score_thresh: float):
    """``predict(images) -> (boxes, scores, labels, valid)`` tensors (N, 100, ...): the
    model in eval mode without grad, then each image's ``retinanet_postprocess``."""
    from recnext_tpu_torch.tasks.detection import retinanet_postprocess

    def predict(images: torch.Tensor):
        model.eval()
        with torch.no_grad():
            cls_scores, bbox_preds = model(images)
            outs = [retinanet_postprocess(c, b, anchors, score_thresh=score_thresh,
                                          level_sizes=level_sizes)
                    for c, b in zip(cls_scores, bbox_preds)]
        return tuple(torch.stack(t) for t in zip(*outs))

    return predict


def main(argv=None):
    args = parse_args(argv)
    if args.detector == "mask_rcnn" or args.with_mask or args.num_proposals is not None:
        raise NotImplementedError(f"--detector mask_rcnn, --with-mask and --num-proposals "
                                  f"are not ported; see {TWO_STAGE_ITEM}")
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.registry import get_config
    from recnext_tpu_torch.tasks.detection import (RetinaNet, generate_anchors,
                                                   init_backbone_from_classification,
                                                   init_task_weights,
                                                   make_detection_train_step)
    from recnext_tpu_torch.train.finetune import read_weights
    from recnext_tpu_torch.train.main import Checkpoints
    from recnext_tpu_torch.train.optim import make_optimizer
    from recnext_tpu_torch.train.state import TrainState

    device = resolve_device(args.device)
    train_ds, val_ds, steps_per_epoch = build_datasets(args)
    model = RetinaNet(get_config(args.backbone, num_classes=0), num_classes=args.num_classes,
                      frozen_backbone_stats=False)
    init_task_weights(model, torch.Generator().manual_seed(args.seed))
    if args.init_ckpt:
        model.load_state_dict(init_backbone_from_classification(
            model.state_dict(), read_weights(args.init_ckpt)), strict=True)
    model.to(device)
    feat_shapes = pyramid_shapes(args.img_size)
    anchors = torch.from_numpy(generate_anchors(feat_shapes, strides=STRIDES)).to(device)
    level_sizes = [h * w * NUM_ANCHOR_SHAPES for h, w in feat_shapes]
    optimizer = make_optimizer(
        model.named_parameters(),
        step_lr(args.lr, steps_per_epoch, decay_epochs=tuple(args.decay_epochs)),
        args.weight_decay, agc_clip=0.0, decay_all=True)
    state = TrainState.create(model, optimizer, ema=False)
    train_step = make_detection_train_step(anchors, args.num_classes)
    predict = make_predict_fn(model, anchors, level_sizes, args.eval_score_thresh)

    def predict_np(images: np.ndarray):
        return tuple(t.cpu().numpy() for t in predict(torch.from_numpy(images).to(device)))

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    ckpts = Checkpoints(out.resolve() / "ckpt")
    start_epoch = 0
    if (args.resume or args.eval_only) and ckpts.latest() is not None:
        saved = torch.load(ckpts.path(ckpts.latest()), map_location=device, weights_only=True)
        state.load_state_dict(saved["state"])
        start_epoch = ckpts.latest() + 1
        print(f"resumed from epoch {ckpts.latest()}", flush=True)

    def ap_record(stats):  # NaN: no gt in that area range; JSON has no NaN
        return {k: (round(v, 4) if np.isfinite(v) else None) for k, v in stats.items()}

    if args.benchmark:
        return benchmark(predict, args, device)

    if args.eval_only:
        if ckpts.latest() is None and not args.init_ckpt:
            raise SystemExit(f"--eval-only: no checkpoint under {out / 'ckpt'}")
        if val_ds is None:
            raise SystemExit("--eval-only: no validation dataset")
        stats = evaluate_detection(val_ds, predict_np, batch_size=args.batch_size,
                                   max_images=args.eval_max_images,
                                   score_thresh=args.eval_score_thresh)
        rec = {"epoch": start_epoch - 1, **ap_record(stats)}
        print(json.dumps(rec), flush=True)
        return rec

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    rec = None
    for epoch in range(start_epoch, args.epochs):
        if args.data_set == "COCO":
            batches = itertools.islice(
                _det_batches(train_ds, rng.permutation(len(train_ds)), args.batch_size),
                steps_per_epoch)
        else:
            batches = (synthetic_det_batch(rng, args.batch_size, args.img_size,
                                           args.num_classes) for _ in range(steps_per_epoch))
        losses = []
        for batch in batches:
            tb = {k: torch.from_numpy(batch[k]).to(device, non_blocking=True)
                  for k in ("image", "gt_boxes", "gt_labels")}
            losses.append(train_step(state, tb)["loss"])  # read once an epoch, below
        train_loss = torch.stack(losses).mean().item() if losses else float("nan")
        rec = {"epoch": epoch, "train_loss": train_loss, "elapsed_s": round(time.time() - t0, 1)}
        if device.type == "cuda":
            rec["max_memory_gib"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
        if val_ds is not None and args.eval_every and (epoch + 1) % args.eval_every == 0:
            rec.update(ap_record(evaluate_detection(
                val_ds, predict_np, batch_size=args.batch_size,
                max_images=args.eval_max_images, score_thresh=args.eval_score_thresh)))
        ckpts.save(epoch, {"epoch": epoch, "state": state.state_dict()})
        print(json.dumps(rec), flush=True)
        with open(out / "log.txt", "a") as f:
            f.write(json.dumps(rec) + "\n")
        if not math.isfinite(train_loss):
            raise SystemExit(f"Loss is {train_loss}, stopping")
    return {"state": state, "last": rec}


def benchmark(predict, args, device):
    """Inference (forward and post-process) images per second over ``args.benchmark``
    batches of ones after one warm-up batch, the device synchronised before and after
    (one JSON line)."""
    x = torch.ones(args.batch_size, 3, args.img_size, args.img_size, device=device)
    predict(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.benchmark):
        predict(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    rec = {"detector": args.detector, "backbone": args.backbone, "img_size": args.img_size,
           "batch_size": args.batch_size, "iters": args.benchmark,
           "images_per_sec": round(args.benchmark * args.batch_size / dt, 2)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
