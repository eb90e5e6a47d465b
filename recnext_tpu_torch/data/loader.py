"""Batched input pipeline: sampler indices -> transformed samples -> NCHW batches.

Counterpart of ``recnext_tpu/data/loader.py``. ``train_loader`` takes the
repeated-augmentation sampler's indices (``repeated_aug``, on by default) or a
permutation seeded by (seed, epoch), strided by ``rank`` over ``num_replicas``;
``eval_loader`` takes ``distributed_eval_indices``. Sample j of the batch that
starts at ``start`` is transformed with ``default_rng((seed, i, start + j))``
(``(seed, i, start + j, s)`` for augmentation split s; the train seed is (seed,
epoch), the eval seed (0,)), so a data set gives the JAX loader's pixels, transposed
to NCHW. Batches are ``{"image": float32 (B, 3, H, W) tensor, "label": int64 (B,)
tensor}``.

With ``aug_splits`` > 1 (timm's AugMix layout, for the JSD loss) a batch holds that
many blocks over the same samples: block 0 through ``clean_transform``, the others
through ``transform``; the labels repeat per block.

Routes, chosen before any decode and kept in ``Loader.route``:
* "pil": PIL decode and the transform in Python;
* "native": ``native=True`` on a data set whose samples are files: the C++ decoder
  (``data/native.py``) decodes, crops and flips with the same draws as the PIL route
  (``rrc_rect``, then the flip), and the transform's ``post_crop`` augments the
  uint8 crop; without one (``SimpleTrainTransform``, the eval transform) the
  normalization is fused in C++ too. A batch holding a file the decoder refuses (a
  PNG, a corrupt JPEG) is made by the PIL route with fresh draws, as the JAX loader
  does, and counted in ``Loader.native_fallback_batches``;
* "pil (not on disk)" / "pil (aug splits)": ``native=True`` on a data set whose
  samples are not files (a tar), or with ``aug_splits`` > 1: the PIL route, as the
  JAX loader takes it. ``native=True`` raises ``NativeBuildError`` where the decoder
  cannot be built.

``workers`` > 0 builds the batches in that many worker processes (a
``torch.utils.data.DataLoader`` over a source whose item b is batch b), forked from
this process, as PyTorch's DataLoader does by default on Linux: a worker inherits
the data set instead of unpickling it, and touches no CUDA state (batches are pinned
in this process). "spawn" and "forkserver" send each worker the pickled source
through a pipe that the worker reads only after importing the main module, so a
source over 64 KB (an epoch of 2,560 samples) starts the workers one after another:
6.5 s a worker on the H100's host, 53 s for 8. Each batch's seeds do not depend on
the worker, so the pixels do not depend on ``workers``. It
takes the place of the JAX package's grain loader, whose own sampling order is not
ported. ``workers`` = 0 builds them in one background thread. ``pin_memory`` pins
each batch for a ``non_blocking`` copy to the card. A failure while a batch is built
is raised on the consumer's side as ``RuntimeError("input pipeline worker failed")``.
"""

from __future__ import annotations

import io
import os
import queue
import threading
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from recnext_tpu_torch.data.samplers import distributed_eval_indices, ra_sampler_indices


def _samples_on_disk(dataset) -> bool:
    """The native decoder reads ``dataset.samples[i][0]`` as a file; a tar's samples
    are member names."""
    samples = getattr(dataset, "samples", None)
    return bool(samples) and os.path.isfile(samples[0][0])


def _image_size(blob: bytes):
    from PIL import Image

    with Image.open(io.BytesIO(blob)) as im:  # reads the header only
        return im.size


class BatchSource:
    """Map-style source whose item b is batch b: ``kind`` "train" (``transform(rng,
    img)``, the last short batch dropped) or "eval" (``transform(img)``, every
    sample)."""

    def __init__(self, dataset, transform, indices, batch_size: int, *, kind: str, seed,
                 native: bool = False, aug_splits: int = 0, clean_transform=None):
        self.dataset, self.transform, self.indices = dataset, transform, indices
        self.batch_size, self.kind, self.seed, self.native = batch_size, kind, seed, native
        self.aug_splits, self.clean_transform = aug_splits, clean_transform
        n = len(indices)
        end = n - n % batch_size if kind == "train" else n
        self.starts = range(0, end, batch_size)

    def __len__(self) -> int:
        return len(self.starts)

    def _apply(self, transform, rng, img) -> np.ndarray:
        return transform(rng, img) if self.kind == "train" else transform(img)

    def _rng(self, i, j, *split):
        return np.random.default_rng((self.seed, int(i), j, *split))

    def _pil(self, idx, start):
        if self.aug_splits > 1:
            blocks = [[] for _ in range(self.aug_splits)]
            labels = []
            for j, i in enumerate(idx):
                img, label = self.dataset[int(i)]
                labels.append(label)
                for s in range(self.aug_splits):
                    t = self.clean_transform if s == 0 else self.transform
                    blocks[s].append(self._apply(t, self._rng(i, start + j, s), img))
            return [im for block in blocks for im in block], labels * self.aug_splits
        imgs, labels = [], []
        for j, i in enumerate(idx):
            img, label = self.dataset[int(i)]
            imgs.append(self._apply(self.transform, self._rng(i, start + j), img))
            labels.append(label)
        return imgs, labels

    def _native(self, idx, start):
        """The native route's batch (NCHW), or None where the decoder refused a file."""
        from recnext_tpu_torch.data import native as native_io
        from recnext_tpu_torch.data.transforms import center_crop_rect, rrc_rect

        blobs = [Path(self.dataset.samples[int(i)][0]).read_bytes() for i in idx]
        crops, rngs = [], []
        for j, (i, blob) in enumerate(zip(idx, blobs)):
            w, h = _image_size(blob)
            if self.kind == "train":
                rng = self._rng(i, start + j)
                x, y, cw, ch = rrc_rect(rng, w, h, scale=self.transform.rrc_scale)
                crops.append([x, y, cw, ch, 1.0 if rng.random() < 0.5 else 0.0])
                rngs.append(rng)
            else:
                cx, cy, cw, ch, _ = center_crop_rect(w, h, self.transform.size,
                                                     self.transform.crop_pct)
                crops.append([cx, cy, cw, ch, 0.0])
        crops = np.asarray(crops, np.float32)
        size = self.transform.size
        post = getattr(self.transform, "post_crop", None)
        if post is None:
            out = native_io.batch_decode_crop(blobs, crops, size)
            return None if out is None else out.transpose(0, 3, 1, 2)
        u8 = native_io.batch_decode_crop_u8(blobs, crops, size)
        return None if u8 is None else np.stack([post(r, a) for r, a in zip(rngs, u8)])

    def __getitem__(self, b: int) -> dict:
        start = self.starts[b]
        idx = self.indices[start:start + self.batch_size]
        fallback = False
        if self.native:
            out = self._native(idx, start)
            labels = [self.dataset.samples[int(i)][1] for i in idx]
            if out is None:  # a file the decoder refused: the PIL route, fresh draws
                fallback = True
                out, labels = self._pil(idx, start)
        else:
            out, labels = self._pil(idx, start)
        return {"image": torch.from_numpy(np.ascontiguousarray(np.stack(out), np.float32)),
                "label": torch.as_tensor(labels, dtype=torch.int64),
                "native_fallback": fallback}


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


def _pinned(batch: dict) -> dict:
    return {k: v.pin_memory() if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


class Loader:
    """The batches of a ``BatchSource``, from ``workers`` processes or one thread."""

    def __init__(self, source: BatchSource, *, route: str, workers: int = 0,
                 pin_memory: bool = False):
        self.source, self.route, self.workers = source, route, workers
        self.pin_memory = pin_memory
        self.native_fallback_batches = 0

    def __len__(self) -> int:
        return len(self.source)

    def _from_thread(self):
        src, pin = self.source, self.pin_memory
        return Prefetcher(lambda: (_pinned(src[b]) if pin else src[b]
                                   for b in range(len(src))))

    def _from_workers(self):
        it = iter(torch.utils.data.DataLoader(
            self.source, batch_size=None, shuffle=False, num_workers=self.workers,
            pin_memory=self.pin_memory, multiprocessing_context="fork"))
        while True:
            try:
                batch = next(it)
            except StopIteration:
                return
            except Exception as e:  # a worker's failure, re-raised as the thread's
                # the workers end with the iterator, which e's traceback would keep
                # alive (e's message holds the worker's own traceback)
                del it
                raise RuntimeError("input pipeline worker failed") from e.with_traceback(None)
            yield batch

    def __iter__(self):
        for batch in (self._from_workers() if self.workers > 0 else self._from_thread()):
            self.native_fallback_batches += int(batch.pop("native_fallback"))
            yield batch


def _route(dataset, native: bool, aug_splits: int = 0) -> str:
    if not native:
        return "pil"
    if aug_splits > 1:
        return "pil (aug splits)"
    from recnext_tpu_torch.data import native as native_io

    native_io.load()  # raises NativeBuildError where it cannot be built
    return "native" if _samples_on_disk(dataset) else "pil (not on disk)"


def train_loader(dataset, transform, *, batch_size: int, epoch: int, rank: int = 0,
                 num_replicas: int = 1, repeated_aug: bool = True, seed: int = 0,
                 aug_splits: int = 0, clean_transform=None, native: bool = False,
                 workers: int = 0, pin_memory: bool = False) -> Loader:
    """The epoch's batches of ``batch_size`` samples (times ``aug_splits`` views where
    it is > 1), the last short batch dropped."""
    if repeated_aug:
        indices = ra_sampler_indices(len(dataset), epoch, rank, num_replicas)
    else:
        indices = np.random.default_rng((seed, epoch)).permutation(len(dataset))
        indices = indices[rank::num_replicas]
    route = _route(dataset, native, aug_splits)
    source = BatchSource(dataset, transform, indices, batch_size, kind="train",
                         seed=(seed, epoch), native=route == "native",
                         aug_splits=aug_splits, clean_transform=clean_transform)
    return Loader(source, route=route, workers=workers, pin_memory=pin_memory)


def eval_loader(dataset, transform, *, batch_size: int, rank: int = 0, num_replicas: int = 1,
                native: bool = False, workers: int = 0, pin_memory: bool = False) -> Loader:
    """Every sample of this replica's split, in order, the last batch short.
    ``transform(img)`` (the eval transform takes no rng)."""
    indices = distributed_eval_indices(len(dataset), rank, num_replicas)
    route = _route(dataset, native)
    source = BatchSource(dataset, transform, indices, batch_size, kind="eval", seed=(0,),
                         native=route == "native")
    return Loader(source, route=route, workers=workers, pin_memory=pin_memory)
