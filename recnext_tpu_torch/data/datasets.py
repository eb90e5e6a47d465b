"""Datasets: the deterministic synthetic FAKE data set.

Counterpart of ``recnext_tpu/data/datasets.py:FakeData`` and of the ``FAKE`` branch
of its ``build_dataset``. ImageFolder, CIFAR-100, tar archives and iNaturalist come
with the data pipeline's slice (``DATA_ITEM``). PIL is imported where it is used.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DATA_ITEM = "ROADMAP.md Queue 1 item 7 (data pipeline)"


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


def build_dataset(is_train: bool, data_set: str, data_path: str = "", input_size: int = 224,
                  fake_classes: int = 1000) -> Tuple[object, int]:
    """(dataset, number of classes). Only ``FAKE`` is ported: 2048 training and 512
    validation images of ``input_size``^2; every other data set raises."""
    if data_set == "FAKE":
        return FakeData(n=2048 if is_train else 512, size=input_size,
                        nb_classes=fake_classes), fake_classes
    raise NotImplementedError(f"data set {data_set!r} is not ported yet (FAKE only); see "
                              f"{DATA_ITEM}")
