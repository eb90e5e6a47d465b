"""Evaluation image transform: short-side resize (bicubic), center crop, ImageNet
normalization. Counterpart of the eval part of ``recnext_tpu/data/transforms.py``
with torchvision/timm-exact rounding; the output is CHW, the port's layout.
PIL is imported where it is used, so the package imports without it.
"""

from __future__ import annotations

import dataclasses

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
