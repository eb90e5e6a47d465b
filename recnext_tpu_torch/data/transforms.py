"""Image transforms: the evaluation transform (short-side resize, bicubic, center
crop, ImageNet normalization) and the simple train transform (RandomResizedCrop,
flip, normalization). Counterparts of ``recnext_tpu/data/transforms.py``'s
``EvalTransform``, ``SimpleTrainTransform``, ``random_resized_crop`` and
``rrc_rect``, with torchvision/timm-exact rounding and the same draws from an
explicit numpy ``Generator``; the output is CHW, the port's layout. The full train
transform (RandAugment, ThreeAugment, random erasing) comes with the data
pipeline's slice. PIL is imported where it is used, so the package imports without
it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img) -> np.ndarray:
    """PIL image or HWC uint8 array -> HWC float32, ImageNet-normalized."""
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return (arr[..., :3] - IMAGENET_MEAN) / IMAGENET_STD


def center_crop_rect(w: int, h: int, size: int, crop_pct: float = 224 / 256):
    """The source-image float rect that resize_center_crop maps onto the final
    (size x size) crop: (cx, cy, cw, ch, (nw, nh)). scale_size = floor(size /
    crop_pct) (timm), the long side of the aspect-preserving resize truncates
    (torchvision F.resize), and the crop offset is int(round(diff / 2.0))
    (torchvision F.center_crop)."""
    scale_size = int(size / crop_pct)
    if w <= h:
        nw, nh = scale_size, max(1, int(scale_size * h / w))
    else:
        nh, nw = scale_size, max(1, int(scale_size * w / h))
    sx, sy = w / nw, h / nh
    x, y = _crop_offset(nw, size), _crop_offset(nh, size)
    return x * sx, y * sy, size * sx, size * sy, (nw, nh)


def _crop_offset(full: int, crop: int) -> int:
    """torchvision F.center_crop offset: int(round((full - crop) / 2.0))."""
    return int(round((full - crop) / 2.0))


def resize_center_crop(img, size: int, crop_pct: float = 224 / 256):
    from PIL import Image

    w, h = img.size
    _, _, _, _, (nw, nh) = center_crop_rect(w, h, size, crop_pct)
    img = img.resize((nw, nh), Image.BICUBIC)
    x, y = _crop_offset(nw, size), _crop_offset(nh, size)
    return img.crop((x, y, x + size, y + size))


@dataclasses.dataclass
class EvalTransform:
    size: int = 224
    crop_pct: float = 224 / 256

    def __call__(self, img) -> np.ndarray:
        """PIL image -> (3, size, size) float32."""
        img = img.convert("RGB")
        arr = normalize(resize_center_crop(img, self.size, self.crop_pct))
        return np.ascontiguousarray(arr.transpose(2, 0, 1), dtype=np.float32)


def rrc_rect(rng: np.random.Generator, w: int, h: int,
             scale: Tuple[float, float] = (0.08, 1.0),
             ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> Tuple[int, int, int, int]:
    """The RandomResizedCrop rectangle (x, y, cw, ch): torchvision/timm's sampling
    loop, ten tries, then a centre crop."""
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return x, y, cw, ch
    s = min(w, h)
    return (w - s) // 2, (h - s) // 2, s, s


def random_resized_crop(rng: np.random.Generator, img, size: int,
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
    from PIL import Image

    w, h = img.size
    x, y, cw, ch = rrc_rect(rng, w, h, scale, ratio)
    return img.resize((size, size), Image.BICUBIC, box=(x, y, x + cw, y + ch))


@dataclasses.dataclass
class SimpleTrainTransform:
    """RandomResizedCrop (scale 0.6-1) + horizontal flip + normalize: smoke runs and
    ablations. ``transform(rng, img)`` -> (3, size, size) float32."""

    size: int = 224
    rrc_scale: Tuple[float, float] = (0.6, 1.0)

    def __call__(self, rng: np.random.Generator, img) -> np.ndarray:
        from PIL import Image

        img = random_resized_crop(rng, img.convert("RGB"), self.size, scale=self.rrc_scale)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return np.ascontiguousarray(normalize(img).transpose(2, 0, 1), dtype=np.float32)
