"""Validation CLI: ``python -m recnext_tpu_torch.validate``.

Counterpart of ``recnext_tpu/validate.py`` (the reference's ``moganet_valid.py``):
score a checkpoint on a data set, with the crop-pct, a CSV results row and, with
``--fused``, the BN-fused model (``fuse_eval.py``'s role). Checkpoints are those of
``train/finetune.py:read_weights``: a reference ``.pth``, this trainer's checkpoint
(``--ema`` takes its EMA weights) or a fused archive (a directory holding
``<model>_fused.pt``, or the file; ``--fused`` needed). Without ``--checkpoint`` the
model is a seeded init. ``--real-labels`` scores against reassessed label sets,
``--valid-labels`` restricts the classes, ``--test-pool`` pools the classifier over
windows of the native 7x7 map at inputs above 224. Every data set of the trainer
(``--data-set``, ``--data-path``), decoded by PIL or, with ``--native-loader``, by
the C++ decoder's fused crop-resample (``data/native.py``; it raises where it cannot
be built), over ``distributed_eval_indices``' split.

The MLLA graft family (``--model mlla_*``) is LayerNorm-based: it evaluates unfused
(``--fused``, ``--packed`` and ``--test-pool`` exit), from a seed or a ``.pth`` in the
reference MLLA layout (its ``rope.rotations`` buffers are dropped: the port computes
its own) or the trainer's checkpoint.

Not here: ``--packed`` (the TPU's lane-packed executor, ``PACKED_ITEM``); the JAX
CLI's ``--compile-cache`` is XLA's and has no counterpart.

  python -m recnext_tpu_torch.validate --model recnext_m1 --checkpoint runs/m1_384/pub \\
      --fused --data-set FAKE --input-size 384 --crop-pct 1.0 --results-file results.csv
  python -m recnext_tpu_torch.validate --model mlla_mini_recconv --checkpoint \\
      runs/mlla_mini/ckpt/epoch_0001.pt --ema --data-set FAKE --input-size 256
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def parse_args(argv=None):
    p = argparse.ArgumentParser("RecNext validation (PyTorch/CUDA port)")
    p.add_argument("--model", required=True)
    p.add_argument("--model-kwargs", default="",
                   help="comma-separated RecNextConfig overrides, tuples with ':'")
    p.add_argument("--checkpoint", default="",
                   help=".pth/.pt state dict or train checkpoint, or a fused archive")
    p.add_argument("--fused", action="store_true", help="evaluate the BN-fused model")
    p.add_argument("--packed", action="store_true",
                   help="the JAX package's lane-packed executor (not ported)")
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA weights of a train checkpoint")
    p.add_argument("--data-set", default="IMNET",
                   choices=["IMNET", "CIFAR", "FOLDER", "FAKE", "IMNETEE", "FLOWERS", "INAT",
                            "INAT19"])
    p.add_argument("--data-path", default="")
    p.add_argument("--fake-classes", type=int, default=1000)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--crop-pct", type=float, default=224 / 256)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"])
    p.add_argument("--results-file", default="", help="append a CSV row here")
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--native-loader", action="store_true",
                   help="the C++ fused decode + crop-resample path (class folders)")
    p.add_argument("--real-labels", default="",
                   help="JSON of reassessed labels: the real.json list (ImageNet val "
                        "order) or a {basename: [labels]} dict")
    p.add_argument("--valid-labels", default="",
                   help="file of class indices, one a line: score over these classes only")
    p.add_argument("--test-pool", action="store_true",
                   help="test-time pooling at inputs above 224 (needs --fused)")
    p.add_argument("--device", default=None, help="default: the GPU (cuda)")
    return p.parse_args(argv)


class RealLabels:
    """Reassessed-label scoring (timm's RealLabelsImagenet): a prediction counts where
    any of its top-k classes is in the sample's label set; samples with an empty set
    are skipped."""

    def __init__(self, filenames, real_json: str, topk=(1, 5)):
        with open(real_json) as f:
            data = json.load(f)
        if isinstance(data, list):
            data = {f"ILSVRC2012_val_{i + 1:08d}.JPEG": v for i, v in enumerate(data)}
        self._labels = data
        self._filenames = [os.path.basename(str(f)) for f in filenames]
        self._topk = topk
        self._correct = {k: 0 for k in topk}
        self._scored = 0
        self._idx = 0

    def add_results(self, logits: np.ndarray, col_map=None):
        maxk = max(self._topk)
        preds = np.argsort(logits, axis=-1)[:, : -maxk - 1: -1]
        if col_map is not None:
            preds = np.asarray(col_map)[preds]
        for pred in preds:
            labels = self._labels.get(self._filenames[self._idx])
            if labels:
                self._scored += 1
                for k in self._topk:
                    if any(int(p) in labels for p in pred[:k]):
                        self._correct[k] += 1
            self._idx += 1

    def accuracy(self, k: int) -> float:
        return 100.0 * self._correct[k] / max(self._scored, 1)


def load_weights(args, template: dict) -> dict:
    """The state dict to evaluate, fused where ``--fused``: the checkpoint's (a train
    checkpoint's EMA weights with ``--ema``), or ``template`` (a seeded init)."""
    from recnext_tpu_torch.export import resolve_published_path
    from recnext_tpu_torch.fusion import fuse_params
    from recnext_tpu_torch.train.finetune import is_raw_state_dict, read_weights

    sd = template
    if args.checkpoint:
        path = resolve_published_path(args.model, args.checkpoint)
        sd = read_weights(str(path), log=lambda m: print(m, flush=True), ema=args.ema)
        if not is_raw_state_dict(sd):
            if not args.fused:
                raise SystemExit("the checkpoint is BN-fused: pass --fused")
            return sd
    return fuse_params(sd) if args.fused else sd


def main(argv=None):
    args = parse_args(argv)
    from recnext_tpu_torch.data.datasets import build_dataset
    from recnext_tpu_torch.data.loader import eval_loader
    from recnext_tpu_torch.data.transforms import EvalTransform
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.registry import create_model, parse_kv_overrides
    from recnext_tpu_torch.train.step import PACKED_ITEM

    mlla = args.model.startswith("mlla")
    if mlla and (args.fused or args.packed or args.test_pool):
        raise SystemExit("mlla models have no fused/packed/test-pool path")
    if args.packed:
        raise NotImplementedError(f"the packed executor is not ported; see {PACKED_ITEM}")
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    ds, nb_classes = build_dataset(False, args.data_set, args.data_path, args.input_size,
                                   args.fake_classes)
    mkw = dict(parse_kv_overrides(args.model_kwargs), num_classes=nb_classes)
    if mlla:
        from recnext_tpu_torch.models.mlla import create_mlla

        net = create_mlla(args.model, device="cpu", **mkw)
        weights = load_weights(args, net.state_dict())
        # the reference's RoPE tables: the port's are computed, non-persistent buffers
        weights = {k: v for k, v in weights.items() if not k.endswith("rope.rotations")}
    else:
        template = create_model(args.model, device="cpu", **mkw).state_dict()
        weights = load_weights(args, template)
        net = create_model(args.model, fused=args.fused, device="cpu", **mkw)
    net.load_state_dict(weights, strict=True)
    net = net.to(device=device, dtype=dtype).eval()

    # test-time pooling only above the native train resolution (timm's
    # apply_test_time_pool); where active, crop_pct 1.0
    test_pool = False
    if args.test_pool:
        if not args.fused:
            raise SystemExit("--test-pool requires --fused (single-linear head)")
        if args.input_size > 224:
            test_pool = True
            args.crop_pct = 1.0
        else:
            print(f"test-pool inactive: input {args.input_size} <= native 224")

    pool = 224 // 32  # the model's native final feature size

    def forward(x: torch.Tensor) -> torch.Tensor:
        if not test_pool:
            return net(x).float()
        feats = net.forward_features(x).float()
        pooled = F.avg_pool2d(feats, pool, stride=1)
        head = net.head
        logits = torch.einsum("bchw,nc->bnhw", pooled, head.weight.float()) \
            + head.bias.float()[None, :, None, None]
        # timm's adaptive_avgmax_pool2d over the positional logits
        return 0.5 * (logits.mean(dim=(2, 3)) + logits.amax(dim=(2, 3)))

    valid_cols = None
    if args.valid_labels:
        with open(args.valid_labels) as f:
            valid_cols = np.asarray(sorted({int(line) for line in f if line.strip()}))

    real = None
    if args.real_labels:
        samples = getattr(ds, "samples", None)
        if samples is None:
            raise SystemExit(f"--real-labels needs a dataset with file names "
                             f"(got {args.data_set})")
        real = RealLabels([s[0] for s in samples], args.real_labels)

    c1 = c5 = n = 0
    t0 = time.time()
    loader = eval_loader(ds, EvalTransform(args.input_size, args.crop_pct),
                         batch_size=args.batch_size, native=args.native_loader)
    with torch.inference_mode():
        for i, batch in enumerate(loader):
            if args.max_batches and i >= args.max_batches:
                break
            logits = forward(batch["image"].to(device, dtype)).cpu().numpy()
            if valid_cols is not None:
                logits = logits[:, valid_cols]
            if real is not None:
                real.add_results(logits, col_map=valid_cols)
            top5 = np.argsort(logits, axis=-1, kind="stable")[:, -5:]
            labels = batch["label"].numpy()
            c1 += int((top5[:, -1] == labels).sum())
            c5 += int((top5 == labels[:, None]).any(axis=-1).sum())
            n += len(labels)
    dt = time.time() - t0
    top1, top5_acc = 100 * c1 / max(n, 1), 100 * c5 / max(n, 1)
    if real is not None:
        top1, top5_acc = real.accuracy(1), real.accuracy(5)
    result = {"model": args.model, "top1": round(top1, 3), "top5": round(top5_acc, 3),
              "img_size": args.input_size, "crop_pct": args.crop_pct, "count": n,
              "images_per_sec": round(n / max(dt, 1e-9), 1), "fused": args.fused,
              "ema": args.ema, "packed": args.packed, "test_pool": test_pool,
              "real_labels": real is not None, "loader_route": loader.route,
              "native_fallback_batches": loader.native_fallback_batches,
              "device": str(device)}
    print(json.dumps(result), flush=True)
    if args.results_file:
        path = Path(args.results_file)
        fieldnames = list(result.keys())
        need_header = not path.exists() or path.stat().st_size == 0
        if not need_header:
            # an older file's header keeps the CSV rectangular
            with open(path, newline="") as f:
                header = f.readline().strip()
            if header:
                fieldnames = header.split(",")
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
            if need_header:
                w.writeheader()
            w.writerow(result)
    return result


if __name__ == "__main__":
    main()
