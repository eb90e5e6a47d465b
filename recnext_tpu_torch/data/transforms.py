"""Image transforms: the evaluation transform (short-side resize, bicubic, center
crop, ImageNet normalization), the simple train transform (RandomResizedCrop, flip,
normalization) and the reference recipe's train transform (RandomResizedCrop, flip,
RandAugment ``rand-m9-mstd0.5-inc1`` or ThreeAugment or color jitter, normalization,
RandomErasing 0.25). Counterparts of ``recnext_tpu/data/transforms.py``, with
torchvision/timm-exact rounding and the same draws, in the same order, from an
explicit numpy ``Generator``, so the same seed gives the same pixels; the output is
CHW, the port's layout, where the JAX package's is HWC. PIL is imported where it is
used, so the package imports without it.
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
    ablations. ``transform(rng, img)`` -> (3, size, size) float32. ``post_crop`` None
    tells the native loader that normalization fuses into its C++ crop."""

    size: int = 224
    rrc_scale: Tuple[float, float] = (0.6, 1.0)
    post_crop = None

    def __call__(self, rng: np.random.Generator, img) -> np.ndarray:
        from PIL import Image

        img = random_resized_crop(rng, img.convert("RGB"), self.size, scale=self.rrc_scale)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return np.ascontiguousarray(normalize(img).transpose(2, 0, 1), dtype=np.float32)


def _chw(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr.transpose(2, 0, 1), dtype=np.float32)


# RandAugment, timm's "rand-m9-mstd0.5-inc1": the 15 ops of
# _RAND_INCREASING_TRANSFORMS, chosen uniformly with replacement, each applied with
# probability 0.5 at a magnitude N(m, mstd) clamped to [0, 10], through the inc1
# level -> argument maps; affine ops fill with (124, 116, 104), bicubic.
_MAX_LEVEL = 10.0
_FILL = (124, 116, 104)


def _affine(img, matrix):
    from PIL import Image

    return img.transform(img.size, Image.AFFINE, matrix, resample=Image.BICUBIC,
                         fillcolor=_FILL)


def _shear_x(img, v):
    return _affine(img, (1, v, 0, 0, 1, 0))


def _shear_y(img, v):
    return _affine(img, (1, 0, 0, v, 1, 0))


def _translate_x(img, v):
    return _affine(img, (1, 0, v * img.size[0], 0, 1, 0))


def _translate_y(img, v):
    return _affine(img, (1, 0, 0, 0, 1, v * img.size[1]))


def _rotate(img, v):
    from PIL import Image

    return img.rotate(v, resample=Image.BICUBIC, fillcolor=_FILL)


def _enhance(name):
    def op(img, v):
        from PIL import ImageEnhance

        return getattr(ImageEnhance, name)(img).enhance(v)

    return op


def _image_op(name):
    def op(img, v):
        from PIL import ImageOps

        return getattr(ImageOps, name)(img)

    return op


def _posterize(img, bits):
    """timm's posterize: 8 bits or more is the identity; inc1 reaches 0 bits at level
    10, which blacks the image (done here, since PIL may refuse 0 bits)."""
    from PIL import Image, ImageOps

    bits = int(bits)
    if bits >= 8:
        return img
    if bits <= 0:
        return Image.fromarray(np.zeros_like(np.asarray(img)))
    return ImageOps.posterize(img, bits)


def _solarize(img, thresh):
    from PIL import ImageOps

    return ImageOps.solarize(img, int(thresh))


def _solarize_add(img, add, thresh=128):
    from PIL import Image

    arr = np.asarray(img, np.int32)
    arr = np.where(arr < thresh, np.clip(arr + int(add), 0, 255), arr).astype(np.uint8)
    return Image.fromarray(arr)


def _lvl_signed(scale):
    def f(rng, level):
        v = level / _MAX_LEVEL * scale
        return -v if rng.random() < 0.5 else v

    return f


def _lvl_enhance(rng, level):
    """inc1: 1 +/- 0.9 * level / 10, at least 0.1."""
    v = level / _MAX_LEVEL * 0.9
    return max(0.1, 1.0 + (-v if rng.random() < 0.5 else v))


def _lvl_none(rng, level):
    return None


_RA_OPS = [
    ("AutoContrast", _image_op("autocontrast"), _lvl_none),
    ("Equalize", _image_op("equalize"), _lvl_none),
    ("Invert", _image_op("invert"), _lvl_none),
    ("Rotate", _rotate, _lvl_signed(30.0)),
    ("Posterize", _posterize, lambda rng, l: 4 - int(l / _MAX_LEVEL * 4)),
    ("Solarize", _solarize, lambda rng, l: 256 - int(l / _MAX_LEVEL * 256)),
    ("SolarizeAdd", _solarize_add, lambda rng, l: int(l / _MAX_LEVEL * 110)),
    ("Color", _enhance("Color"), _lvl_enhance),
    ("Contrast", _enhance("Contrast"), _lvl_enhance),
    ("Brightness", _enhance("Brightness"), _lvl_enhance),
    ("Sharpness", _enhance("Sharpness"), _lvl_enhance),
    ("ShearX", _shear_x, _lvl_signed(0.3)),
    ("ShearY", _shear_y, _lvl_signed(0.3)),
    ("TranslateX", _translate_x, _lvl_signed(0.45)),
    ("TranslateY", _translate_y, _lvl_signed(0.45)),
]


def rand_augment(rng: np.random.Generator, img, num_ops: int = 2, magnitude: float = 9.0,
                 mstd: float = 0.5, prob: float = 0.5):
    """timm RandAugment: ``num_ops`` draws, each applied with probability ``prob``."""
    for _ in range(num_ops):
        if rng.random() > prob:
            continue
        _, fn, lvl = _RA_OPS[int(rng.integers(len(_RA_OPS)))]
        m = float(rng.normal(magnitude, mstd)) if mstd else float(magnitude)
        img = fn(img, lvl(rng, float(np.clip(m, 0.0, _MAX_LEVEL))))
    return img


def color_jitter(rng: np.random.Generator, img, strength: float = 0.4):
    """Brightness, contrast, saturation, each by a factor U(1 - s, 1 + s)."""
    from PIL import ImageEnhance

    for cls in (ImageEnhance.Brightness, ImageEnhance.Contrast, ImageEnhance.Color):
        img = cls(img).enhance(float(rng.uniform(max(0.0, 1 - strength), 1 + strength)))
    return img


def random_erasing(rng: np.random.Generator, arr: np.ndarray, p: float = 0.25,
                   area: Tuple[float, float] = (0.02, 1 / 3),
                   ratio: Tuple[float, float] = (0.3, 3.33)) -> np.ndarray:
    """timm RandomErasing, mode "pixel", on a normalized HWC array: with probability
    ``p`` one box (10 tries) filled with N(0, 1) noise drawn in (h, w, C) order."""
    if rng.random() > p:
        return arr
    h, w = arr.shape[:2]
    for _ in range(10):
        target = rng.uniform(*area) * h * w
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        eh, ew = int(round(np.sqrt(target * ar))), int(round(np.sqrt(target / ar)))
        if 0 < eh < h and 0 < ew < w:
            y = int(rng.integers(0, h - eh + 1))
            x = int(rng.integers(0, w - ew + 1))
            arr = arr.copy()
            arr[y:y + eh, x:x + ew] = rng.normal(size=(eh, ew, arr.shape[2])).astype(arr.dtype)
            return arr
    return arr


def three_augment_choice(rng: np.random.Generator, img):
    """DeiT-III's ThreeAugment: one of grayscale, solarize, Gaussian blur."""
    from PIL import ImageFilter, ImageOps

    c = int(rng.integers(3))
    if c == 0:
        return ImageOps.grayscale(img).convert("RGB")
    if c == 1:
        return ImageOps.solarize(img)
    return img.filter(ImageFilter.GaussianBlur(radius=float(rng.uniform(0.1, 2.0))))


@dataclasses.dataclass
class TrainTransform:
    """The reference recipe's train transform: ``transform(rng, img)`` -> (3, size,
    size) float32. RandomResizedCrop and flip, then ``post_crop``: ThreeAugment then
    jitter, or RandAugment (which replaces jitter, as timm's create_transform does),
    or jitter alone (``auto_augment=False``, the reference's ``--aa ''``); normalize;
    RandomErasing. The native loader runs the crop and flip in C++ with the same
    draws and hands the uint8 crop to ``post_crop``."""

    size: int = 224
    three_augment: bool = False
    auto_augment: bool = True
    ra_magnitude: float = 9.0
    jitter: float = 0.4
    reprob: float = 0.25
    rrc_scale: Tuple[float, float] = (0.08, 1.0)

    def post_crop(self, rng: np.random.Generator, img) -> np.ndarray:
        """Augment a (size x size) crop, a PIL image or a uint8 HWC array. The chain
        runs in HWC, as the JAX package's does, so erasing's noise lands on the same
        pixels; the result is transposed to CHW once, at the end."""
        from PIL import Image

        if not isinstance(img, Image.Image):
            img = Image.fromarray(img, "RGB")
        if self.three_augment:
            img = three_augment_choice(rng, img)
            if self.jitter:
                img = color_jitter(rng, img, self.jitter)
        elif self.auto_augment:
            img = rand_augment(rng, img, magnitude=self.ra_magnitude)
        elif self.jitter:
            img = color_jitter(rng, img, self.jitter)
        arr = normalize(img)
        if self.reprob:
            arr = random_erasing(rng, arr, p=self.reprob)
        return _chw(arr)

    def __call__(self, rng: np.random.Generator, img) -> np.ndarray:
        from PIL import Image

        img = random_resized_crop(rng, img.convert("RGB"), self.size, scale=self.rrc_scale)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return self.post_crop(rng, img)
