"""Profiling helpers over torch.profiler, NVTX and CUDA events.

Counterparts of ``recnext_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` session (CPU, and CUDA where present) that
  writes a Chrome trace (``trace.json``) into ``logdir``;
* ``annotate(name)``: a named region, ``record_function`` and, on a CUDA machine, an
  NVTX range;
* ``device_time(fn, *args, iters)``: the median ms of ``fn(*args)`` by CUDA events
  (on the CPU, by the host's clock);
* ``Stopwatch``: wall time of a section, the device synchronised on exit.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; ``<logdir>/trace.json`` is written on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def device_time(fn, *args, iters: int = 50, warmup: int = 3) -> float:
    """Median ms of one ``fn(*args)``: CUDA events around each call on a CUDA
    machine, the host's clock otherwise."""
    for _ in range(warmup):
        fn(*args)
    times = []
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class Stopwatch:
    """Wall time of a ``with`` block in seconds (``elapsed``), the device
    synchronised on exit so that queued work counts."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self.t0
