"""COCO-format detection data set with fixed-shape batches: the port's copy of
``recnext_tpu/data/coco.py`` (the reference builds mmdet's CocoDataset from
``annotations/instances_{train,val}2017.json``), channels first. JSON parsing and
mask decoding in Python, numpy and PIL: no pycocotools.

Every sample is letterboxed onto one (img_size, img_size) canvas (top left) and its
ground truth padded to ``max_gt`` rows (-1 = empty), so each batch has one shape; the
original size and the scale travel with it, so that evaluation maps the
predictions back to the original image's coordinates (where COCO AP is defined).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# ImageNet normalization, as the classification pipeline's (mmdet's default too)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def decode_compressed_rle(counts: str, h: int, w: int) -> np.ndarray:
    """Decode COCO's compressed RLE string (pycocotools LEB128 variant) to a
    (h, w) uint8 mask. Column-major runs starting with background."""
    runs: List[int] = []
    i = 0
    n = len(counts)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    return _runs_to_mask(runs, h, w)


def _runs_to_mask(runs: Sequence[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for r in runs:
        if val:
            flat[pos:pos + r] = 1
        pos += r
        val ^= 1
    # COCO RLE is column-major (Fortran order)
    return flat.reshape((w, h)).T


def ann_to_mask(seg, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygon list / uncompressed RLE / compressed RLE) ->
    (h, w) uint8 binary mask."""
    if isinstance(seg, dict):
        rh, rw = seg["size"]
        counts = seg["counts"]
        if isinstance(counts, str):
            return decode_compressed_rle(counts, rh, rw)
        return _runs_to_mask(counts, rh, rw)
    # list of polygons [x0,y0,x1,y1,...]
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in seg:
        if len(poly) >= 6:
            draw.polygon([float(v) for v in poly], outline=1, fill=1)
    return np.asarray(img, np.uint8)


class CocoDetection:
    """COCO-annotation detection dataset.

    Layout: `ann_file` is an instances_*.json; `img_dir` holds the images by
    `file_name`. Category ids are remapped to contiguous [0, C) by sorted id —
    the same convention mmdet's CocoDataset uses (cat2label).

    __getitem__ returns a dict of fixed-shape numpy arrays:
      image     (3, S, S) float32, normalized, letterboxed top-left
      gt_boxes  (max_gt, 4) xyxy in canvas coords, padded -1
      gt_labels (max_gt,) int32 contiguous class ids, padded -1
      gt_masks  (max_gt, S, S) uint8 (only if with_masks)
      image_id, scale, orig_hw — for mapping predictions back for COCO AP
    """

    def __init__(self, img_dir: str, ann_file: str, *, img_size: int = 512,
                 max_gt: int = 48, with_masks: bool = True,
                 skip_empty: bool = True, train: bool = True,
                 hflip_prob: float = 0.5, seed: int = 0):
        self.img_dir = Path(img_dir)
        self.img_size = img_size
        self.max_gt = max_gt
        self.with_masks = with_masks
        self.train = train
        self.hflip_prob = hflip_prob if train else 0.0
        self._rng = np.random.default_rng(seed)

        with open(ann_file) as f:
            data = json.load(f)

        cat_ids = sorted(c["id"] for c in data["categories"])
        self.cat_to_label = {c: i for i, c in enumerate(cat_ids)}
        self.label_to_cat = {i: c for c, i in self.cat_to_label.items()}
        self.nb_classes = len(cat_ids)
        self.class_names = [
            c["name"] for c in sorted(data["categories"], key=lambda c: c["id"])]

        anns_by_img: Dict[int, list] = {}
        for a in data["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.images = []
        for img in data["images"]:
            anns = anns_by_img.get(img["id"], [])
            anns = [a for a in anns if not a.get("iscrowd", 0)
                    and a["bbox"][2] > 1 and a["bbox"][3] > 1]
            crowd = [a for a in anns_by_img.get(img["id"], [])
                     if a.get("iscrowd", 0)]
            if skip_empty and train and not anns:
                continue
            self.images.append((img, anns, crowd))

    def __len__(self):
        return len(self.images)

    def load_image(self, info) -> np.ndarray:
        from PIL import Image

        path = self.img_dir / info["file_name"]
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def __getitem__(self, i: int) -> dict:
        info, anns, _ = self.images[i]
        img = self.load_image(info)
        h, w = img.shape[:2]
        S = self.img_size
        scale = min(S / w, S / h)
        nw, nh = max(1, round(w * scale)), max(1, round(h * scale))

        from PIL import Image

        im = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
        flip = self.train and self._rng.random() < self.hflip_prob
        if flip:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        canvas = np.zeros((S, S, 3), np.float32)
        canvas[:nh, :nw] = np.asarray(im, np.float32) / 255.0
        canvas = (canvas - MEAN) / STD

        G = self.max_gt
        boxes = np.full((G, 4), -1, np.float32)
        labels = np.full((G,), -1, np.int32)
        masks = np.zeros((G, S, S), np.uint8) if self.with_masks else None
        for g, a in enumerate(anns[:G]):
            x, y, bw, bh = a["bbox"]
            x1, y1 = x * scale, y * scale
            x2, y2 = (x + bw) * scale, (y + bh) * scale
            if flip:
                x1, x2 = nw - x2, nw - x1
            boxes[g] = [x1, y1, x2, y2]
            labels[g] = self.cat_to_label[a["category_id"]]
            if self.with_masks and a.get("segmentation"):
                m = ann_to_mask(a["segmentation"], h, w)
                mi = Image.fromarray(m * 255).resize((nw, nh), Image.BILINEAR)
                if flip:
                    mi = mi.transpose(Image.FLIP_LEFT_RIGHT)
                masks[g, :nh, :nw] = (np.asarray(mi) > 127).astype(np.uint8)

        out = {"image": np.ascontiguousarray(canvas.transpose(2, 0, 1)),
               "gt_boxes": boxes, "gt_labels": labels,
               "image_id": info["id"], "scale": scale, "orig_hw": (h, w)}
        if self.with_masks:
            out["gt_masks"] = masks
        return out

    def gt_for_eval(self, i: int) -> dict:
        """Original-coordinate ground truth (incl. crowd) for the AP evaluator."""
        info, anns, crowd = self.images[i]
        every = anns + crowd
        boxes = np.array([[a["bbox"][0], a["bbox"][1],
                           a["bbox"][0] + a["bbox"][2],
                           a["bbox"][1] + a["bbox"][3]] for a in every],
                         np.float32).reshape(-1, 4)
        labels = np.array([self.cat_to_label[a["category_id"]] for a in every],
                          np.int32)
        iscrowd = np.array([a.get("iscrowd", 0) for a in every], bool)
        out = {"boxes": boxes, "labels": labels, "iscrowd": iscrowd,
               "image_id": info["id"]}
        if self.with_masks:
            h, w = info["height"], info["width"]
            out["masks"] = np.stack(
                [ann_to_mask(a["segmentation"], h, w) if a.get("segmentation")
                 else np.zeros((h, w), np.uint8) for a in every]) \
                if every else np.zeros((0, h, w), np.uint8)
        return out


def collate_det(samples: List[dict]) -> dict:
    """Stack fixed-shape samples into one batch dict of numpy arrays."""
    keys = ("image", "gt_boxes", "gt_labels") + (
        ("gt_masks",) if "gt_masks" in samples[0] else ())
    batch = {k: np.stack([s[k] for s in samples]) for k in keys}
    batch["image_id"] = np.array([s["image_id"] for s in samples])
    batch["scale"] = np.array([s["scale"] for s in samples], np.float32)
    batch["orig_hw"] = np.array([s["orig_hw"] for s in samples], np.int32)
    return batch
