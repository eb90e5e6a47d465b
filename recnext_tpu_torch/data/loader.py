"""Batched input pipeline: sampler indices -> transformed samples -> NCHW batches,
with a background thread that keeps a few batches ready.

Counterpart of the Python path of ``recnext_tpu/data/loader.py``: ``_batches``,
``train_loader`` with its seeded permutation (``repeated_aug=False``) and
``eval_loader``, with the same per-sample seeds ``((seed, epoch), i, start + j)``
and ``((0,), i, start + j)``, so the same data set gives the same pixels. Batches
are ``{"image": float32 (B, 3, H, W) tensor, "label": int64 (B,) tensor}`` on the
host. The repeated-augmentation sampler, the native decoder and augmentation
splits come with the data pipeline's slice.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from recnext_tpu_torch.data.datasets import DATA_ITEM


def _batches(dataset, transform, indices, batch_size: int, seed, drop_last: bool):
    """``transform(rng, img)`` -> CHW float32 per sample; one rng per sample."""
    n = len(indices)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        imgs, labels = [], []
        for j, i in enumerate(indices[start:start + batch_size]):
            rng = np.random.default_rng((seed, int(i), start + j))
            img, label = dataset[int(i)]
            imgs.append(transform(rng, img))
            labels.append(label)
        yield {"image": torch.from_numpy(np.stack(imgs).astype(np.float32)),
               "label": torch.as_tensor(labels, dtype=torch.int64)}


class _PrefetchError:
    """Carries a worker's exception to the consumer, apart from any yielded item."""

    def __init__(self, exc: BaseException):
        self.exc = exc


PREFETCH_DEPTH = 2  # batches kept ready


class Prefetcher:
    """Runs the sample pipeline in a background thread, keeping ``PREFETCH_DEPTH``
    batches ready. A failure in the pipeline is raised on the consumer's side."""

    def __init__(self, gen_factory: Callable[[], Iterator]):
        self._factory = gen_factory

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        stop = object()
        done = threading.Event()

        def worker():
            try:
                for item in self._factory():
                    if done.is_set():
                        return
                    q.put(item)
            except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
                q.put(_PrefetchError(e))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, _PrefetchError):
                    raise RuntimeError("input pipeline worker failed") from item.exc
                yield item
        finally:  # a consumer that stops early lets the worker end
            done.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def train_loader(dataset, transform, *, batch_size: int, epoch: int,
                 repeated_aug: bool = False, seed: int = 0) -> Prefetcher:
    """The epoch's batches (drop_last), in a permutation seeded by (seed, epoch).
    ``repeated_aug=True`` (the RA sampler) is not ported yet and raises."""
    if repeated_aug:
        raise NotImplementedError(f"the repeated-augmentation sampler is not ported yet; "
                                  f"see {DATA_ITEM}")
    indices = np.random.default_rng((seed, epoch)).permutation(len(dataset))
    return Prefetcher(lambda: _batches(dataset, transform, indices, batch_size,
                                       seed=(seed, epoch), drop_last=True))


def eval_loader(dataset, transform, *, batch_size: int) -> Prefetcher:
    """Every sample, in order, the last batch short.
    ``transform(img)`` (the eval transform takes no rng)."""
    indices = np.arange(len(dataset))
    return Prefetcher(lambda: _batches(dataset, lambda rng, img: transform(img), indices,
                                       batch_size, seed=(0,), drop_last=False))
