"""Sampler indices as pure functions: the repeated-augmentation sampler and the
strided evaluation split.

Counterpart of ``recnext_tpu/data/samplers.py``. ``ra_sampler_indices`` is the
reference's RASampler: an epoch's permutation seeded by ``epoch`` alone (not by the
run's seed), each index repeated 3 times so that the augmented copies land on
different replicas, a rank-strided subsample, truncated to floor(n / 256) * 256 /
replicas. ``distributed_eval_indices`` strides the evaluation split over the
replicas and pads it to a multiple of their count by wrapping around.
"""

from __future__ import annotations

import numpy as np


def ra_sampler_indices(n: int, epoch: int, rank: int = 0, num_replicas: int = 1, *,
                       shuffle: bool = True, repeats: int = 3) -> np.ndarray:
    num_samples = int(np.ceil(n * repeats / num_replicas))
    total_size = num_samples * num_replicas
    num_selected = int(n // 256 * 256 / num_replicas)
    if num_selected == 0:  # a data set under 256 samples keeps everything
        num_selected = num_samples
    indices = np.random.default_rng(epoch).permutation(n) if shuffle else np.arange(n)
    indices = np.repeat(indices, repeats)
    if total_size > len(indices):
        indices = np.concatenate([indices, indices[:total_size - len(indices)]])
    indices = indices[rank:total_size:num_replicas]
    if len(indices) != num_samples:
        raise AssertionError(f"{len(indices)} indices for rank {rank}, not {num_samples}")
    return indices[:num_selected]


def distributed_eval_indices(n: int, rank: int = 0, num_replicas: int = 1) -> np.ndarray:
    num_samples = int(np.ceil(n / num_replicas))
    total = num_samples * num_replicas
    indices = np.arange(n)
    if total > n:
        indices = np.concatenate([indices, indices[:total - n]])
    return indices[rank:total:num_replicas]
