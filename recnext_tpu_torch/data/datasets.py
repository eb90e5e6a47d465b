"""Datasets: class folders (ImageNet's layout, also in a tar), CIFAR-100, iNaturalist,
a repeated data set, the deterministic synthetic FAKE data set, and ADE20K's
segmentation layout (``SegFolder``, whose items are ``(PIL.Image, label map)``).

Counterpart of ``recnext_tpu/data/datasets.py`` and its ``build_dataset``; each item
is ``(PIL.Image, label)``, as there. PIL is imported where it is used.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _open_image(data: bytes):
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img.load()
    return img


class ImageFolder:
    """A directory per class, images below it (any depth); ``samples`` holds
    (path, label) in sorted order."""

    def __init__(self, root: str):
        self.root = Path(root)
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [(p, self.class_to_idx[c]) for c in classes
                        for p in sorted((self.root / c).rglob("*"))
                        if p.suffix.lower() in IMG_EXTENSIONS]
        self.nb_classes = len(classes)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        path, label = self.samples[i]
        return _open_image(Path(path).read_bytes()), label


class CIFAR100:
    """The cifar-100-python pickle directory (its train or test file)."""

    nb_classes = 100

    def __init__(self, root: str, train: bool = True):
        path = Path(root) / "cifar-100-python" / ("train" if train else "test")
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self.data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.asarray(d[b"fine_labels"], np.int32)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int):
        from PIL import Image

        return Image.fromarray(self.data[i]), int(self.labels[i])


class INatDataset:
    """iNaturalist 2018/2019: images listed in train{year}.json / val{year}.json, each
    labelled by its category's ``category`` rank (kingdom ... name) in
    categories.json."""

    def __init__(self, root: str, train: bool = True, year: int = 2018,
                 category: str = "name"):
        self.root = Path(root)
        anno = self.root / (f"train{year}.json" if train else f"val{year}.json")
        data = json.loads(anno.read_text())
        categories = json.loads((self.root / "categories.json").read_text())
        targets = sorted({c[category] for c in categories})
        self.target_to_idx = {t: i for i, t in enumerate(targets)}
        self.nb_classes = len(targets)
        cat_by_id = {c["id"]: c for c in categories}
        ann_by_image = {a["image_id"]: a["category_id"] for a in data["annotations"]}
        self.samples = [(self.root / img["file_name"],
                         self.target_to_idx[cat_by_id[ann_by_image[img["id"]]][category]])
                        for img in data["images"]]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        path, label = self.samples[i]
        return _open_image(Path(path).read_bytes()), label


class FakeData:
    """Deterministic synthetic images with a class-dependent signal (a class colour
    plus noise), so smoke training can learn; returns (PIL.Image, label)."""

    def __init__(self, n: int = 1024, size: int = 224, nb_classes: int = 1000):
        self.n, self.size, self.nb_classes = n, size, nb_classes

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        from PIL import Image

        label = int(i % self.nb_classes)
        g = np.random.default_rng(i)
        color = np.random.default_rng(label).integers(40, 216, size=3)
        noise = g.integers(-40, 41, size=(self.size, self.size, 3))
        arr = np.clip(color[None, None] + noise, 0, 255).astype(np.uint8)
        return Image.fromarray(arr, "RGB"), label


class TarImageFolder:
    """Class folders inside a tar (timm's DatasetTar: ``train.tar`` / ``val.tar`` of
    class-dir/image members), indexed once; ``samples`` holds (member name, label).
    Members are read through one tarfile handle per process and thread: a handle is
    not thread-safe, and one that a parent opened before a fork shares its file offset
    with every child, so reads through it would interleave. Pickling (for a worker
    process) drops the handles."""

    def __init__(self, tar_path: str):
        import tarfile

        self.path = str(tar_path)
        self._handles: dict = {}
        entries = []
        with tarfile.open(self.path) as tf:
            for m in tf.getmembers():
                parts = m.name.split("/")
                if (m.isfile() and len(parts) >= 2
                        and "." + parts[-1].rsplit(".", 1)[-1].lower() in IMG_EXTENSIONS):
                    entries.append((m.name, parts[-2]))
        entries.sort()
        classes = sorted({c for _, c in entries})
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [(name, self.class_to_idx[c]) for name, c in entries]
        self.nb_classes = len(classes)

    def __getstate__(self):
        return {**self.__dict__, "_handles": {}}

    def __len__(self) -> int:
        return len(self.samples)

    def _tar(self):
        import tarfile

        key = (os.getpid(), threading.get_ident())
        tf = self._handles.get(key)
        if tf is None:
            tf = self._handles[key] = tarfile.open(self.path)
        return tf

    def __getitem__(self, i: int):
        name, label = self.samples[i]
        return _open_image(self._tar().extractfile(name).read()), label


class RepeatDataset:
    """``dataset`` repeated ``repeats`` times (the reference's FLOWERS epoch)."""

    def __init__(self, dataset, repeats: int):
        self.dataset = dataset
        self.repeats = repeats
        self.nb_classes = getattr(dataset, "nb_classes", None)

    def __len__(self) -> int:
        return len(self.dataset) * self.repeats

    def __getitem__(self, i: int):
        return self.dataset[i % len(self.dataset)]


class SegFolder:
    """ADE20K's layout: ``<root>/images/<split>/*.jpg`` beside
    ``<root>/annotations/<split>/<stem>.png`` label maps. With ``reduce_zero_label``
    (mmseg's ADE20KDataset) label 0 becomes 255 (ignored) and k becomes k - 1."""

    def __init__(self, root: str, split: str = "training", reduce_zero_label: bool = True):
        self.root = Path(root)
        ann_dir = self.root / "annotations" / split
        self.reduce_zero_label = reduce_zero_label
        self.samples = []
        for p in sorted((self.root / "images" / split).glob("*")):
            ann = ann_dir / (p.stem + ".png")
            if p.suffix.lower() in IMG_EXTENSIONS and ann.exists():
                self.samples.append((p, ann))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        from PIL import Image

        img_p, ann_p = self.samples[i]
        img = Image.open(img_p).convert("RGB")
        seg = np.asarray(Image.open(ann_p), dtype=np.int32)
        if self.reduce_zero_label:
            seg = np.where(seg == 0, 256, seg) - 1
        return img, seg


def build_dataset(is_train: bool, data_set: str, data_path: str = "", input_size: int = 224,
                  fake_classes: int = 1000) -> Tuple[object, int]:
    """(dataset, number of classes) for the trainer's and validate.py's ``--data-set``:
    FAKE is 2048 training and 512 validation images of ``input_size``^2."""
    split = "train" if is_train else "val"
    if data_set == "CIFAR":
        return CIFAR100(data_path, train=is_train), 100
    if data_set == "IMNET":
        tar = Path(data_path) / f"{split}.tar"
        if tar.exists():
            return TarImageFolder(str(tar)), 1000
        return ImageFolder(str(Path(data_path) / split)), 1000
    if data_set == "IMNETEE":
        return ImageFolder(str(Path(data_path) / split)), 10
    if data_set == "FLOWERS":
        ds = ImageFolder(str(Path(data_path) / ("train" if is_train else "test")))
        return (RepeatDataset(ds, 100) if is_train else ds), 102
    if data_set == "FOLDER":
        ds = ImageFolder(str(Path(data_path) / split))
        return ds, ds.nb_classes
    if data_set == "FAKE":
        return FakeData(n=2048 if is_train else 512, size=input_size,
                        nb_classes=fake_classes), fake_classes
    if data_set in ("INAT", "INAT19"):
        ds = INatDataset(data_path, train=is_train, year=2018 if data_set == "INAT" else 2019)
        return ds, ds.nb_classes
    raise ValueError(f"unknown data set {data_set!r}")
