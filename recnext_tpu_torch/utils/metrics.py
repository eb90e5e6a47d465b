"""Metric tracking: ``SmoothedValue`` and ``MetricLogger``.

Counterparts of ``recnext_tpu/utils/metrics.py``: a windowed median and average and
a global average over the run. Across processes, ``synchronize_between_processes``
sums ``[count, total]`` with one ``all_reduce`` in float64 (on the CPU, which every
backend of ``torch.distributed`` takes); with one process it does nothing.
"""

from __future__ import annotations

import collections
import time
from typing import Dict

import numpy as np
import torch

from recnext_tpu_torch.parallel.sharding import all_reduce_sum, world_size


class SmoothedValue:
    """A series with a smoothing window; global statistics over the whole run."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum ``[count, total]`` over the processes (the window stays local)."""
        if world_size() == 1:
            return
        summed = all_reduce_sum(torch.tensor([self.count, self.total], dtype=torch.float64))
        self.count = int(summed[0])
        self.total = float(summed[1])

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    """Named ``SmoothedValue`` meters and an iteration logger with an ETA."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "", total: int = 0):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        t_prev = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - t_prev)
            t_prev = time.time()
            if print_freq and i % print_freq == 0:
                eta = f" eta: {iter_time.global_avg * (total - i):.0f}s" if total else ""
                print(f"{header} [{i}{'/' + str(total) if total else ''}]"
                      f" {self}{eta} iter_t: {iter_time}", flush=True)
            i += 1
        print(f"{header} done in {time.time() - start:.1f}s", flush=True)
