"""Contact sheet of the train augmentation: ``python -m recnext_tpu_torch.data.browse``.

Counterpart of ``recnext_tpu/data/browse.py``. Each row is one source image: the
original (its label stamped in the corner), the eval transform, then ``--draws``
independent draws of the train transform that the trainer's flags select. Pixels are
de-normalized for display; the sheet is a PNG.

  python -m recnext_tpu_torch.data.browse --data-set FAKE --input-size 96 \\
      --rows 4 --draws 6 --out runs/browse.png
  python -m recnext_tpu_torch.data.browse --data-set FOLDER --data-path <path> \\
      --three-augment --out runs/aug_sheet.png
"""

from __future__ import annotations

import argparse

import numpy as np

from recnext_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD, EvalTransform,
                                               SimpleTrainTransform, TrainTransform)


def denormalize(arr: np.ndarray) -> np.ndarray:
    """Inverse of ``normalize`` on a CHW float32 array: HWC uint8 RGB."""
    img = (arr.transpose(1, 2, 0) * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def contact_sheet(dataset, train_tf, eval_tf, *, rows: int, draws: int, seed: int = 0,
                  pad: int = 2):
    """A PIL image: rows x (original | eval | ``draws`` train draws)."""
    from PIL import Image, ImageDraw

    size = getattr(train_tf, "size", 224)
    rng = np.random.default_rng(seed)
    n = len(dataset)
    picks = sorted(int(i) for i in np.random.default_rng(seed + 1).choice(
        n, size=min(rows, n), replace=False))
    sheet = Image.new("RGB", ((2 + draws) * (size + pad) + pad, len(picks) * (size + pad) + pad),
                      (24, 24, 24))
    for r, i in enumerate(picks):
        img, label = dataset[i]
        img = (img.convert("RGB") if isinstance(img, Image.Image)
               else Image.fromarray(np.asarray(img, np.uint8), "RGB"))
        y = pad + r * (size + pad)
        orig = img.resize((size, size), Image.BICUBIC)
        ImageDraw.Draw(orig).text((3, 3), str(label), fill=(255, 255, 0))
        sheet.paste(orig, (pad, y))
        sheet.paste(Image.fromarray(denormalize(eval_tf(img))), (pad + (size + pad), y))
        for d in range(draws):
            aug = denormalize(train_tf(rng, img))
            sheet.paste(Image.fromarray(aug), (pad + (2 + d) * (size + pad), y))
    return sheet


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-set", default="FAKE",
                   choices=["IMNET", "CIFAR", "FOLDER", "FAKE", "IMNETEE", "FLOWERS", "INAT",
                            "INAT19"])
    p.add_argument("--data-path", default="")
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--rows", type=int, default=4, help="source images")
    p.add_argument("--draws", type=int, default=6,
                   help="independent augmentation draws per image")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="browse.png")
    # the trainer's augmentation switches
    p.add_argument("--simple-aug", action="store_true")
    p.add_argument("--ThreeAugment", "--three-augment", dest="three_augment",
                   action="store_true")
    p.add_argument("--no-aa", action="store_true")
    p.add_argument("--aa-magnitude", type=float, default=9.0)
    p.add_argument("--color-jitter", type=float, default=0.4)
    p.add_argument("--reprob", type=float, default=0.25)
    args = p.parse_args(argv)

    from recnext_tpu_torch.data.datasets import build_dataset

    dataset, nb_classes = build_dataset(True, args.data_set, args.data_path,
                                        input_size=args.input_size)
    if args.simple_aug:
        train_tf = SimpleTrainTransform(args.input_size)
    else:
        train_tf = TrainTransform(args.input_size, three_augment=args.three_augment,
                                  auto_augment=not args.no_aa, ra_magnitude=args.aa_magnitude,
                                  jitter=args.color_jitter, reprob=args.reprob)
    sheet = contact_sheet(dataset, train_tf, EvalTransform(args.input_size), rows=args.rows,
                          draws=args.draws, seed=args.seed)
    sheet.save(args.out)
    print(f"wrote {args.out}: {len(dataset)} samples ({nb_classes} classes), "
          f"{args.rows} rows x (orig + eval + {args.draws} train draws)")
    return sheet


if __name__ == "__main__":
    main()
