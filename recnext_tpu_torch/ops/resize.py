"""Spatial resize with PyTorch's ``F.interpolate`` conventions, NCHW layout.

The RecConv pyramid upsamples each level back to the size recorded before its
stride-2 downsample. The semantics are those of ``recnext_tpu/ops/resize.py``:

* bilinear, ``align_corners=False``: source coordinate ``max(scale*(i+0.5)-0.5, 0)``
  with linear weights and edge clamping;
* nearest (not nearest-exact): source index ``floor(i * in_size / out_size)``.

Both are written as per-axis plans (gather indices and lerp weights computed once
per shape on the host), so the arithmetic is the reference's step for step. Each
plan is copied to a device once and cached there per (shape, device, dtype), so a
resize on a CUDA tensor makes no host-to-device copy after its first call. The
RecConv CUDA kernel reads these same bilinear plans, packed into one table per
pyramid by ``ops/cuda/recconv.py:lerp_plan_table`` and cached on each device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _bilinear_axis_plan(in_size: int, out_size: int) -> tuple:
    """(idx0, idx1, w1) so out[i] = x[idx0[i]]*(1-w1[i]) + x[idx1[i]]*w1[i]."""
    scale = in_size / out_size
    src = scale * (np.arange(out_size, dtype=np.float64) + 0.5) - 0.5
    src = np.maximum(src, 0.0)
    idx0 = np.floor(src).astype(np.int32)
    idx0 = np.minimum(idx0, in_size - 1)
    idx1 = np.minimum(idx0 + 1, in_size - 1)
    w1 = (src - idx0).astype(np.float32)
    return idx0, idx1, w1


@functools.lru_cache(maxsize=None)
def _nearest_axis_plan(in_size: int, out_size: int) -> np.ndarray:
    """PyTorch 'nearest' source indices: floor(i * in / out) via exact int math."""
    i = np.arange(out_size, dtype=np.int64)
    return ((i * in_size) // out_size).astype(np.int32)


def _device_tensor(a: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # a normal tensor even when first built under inference_mode, so that autograd
    # may save it (index_select keeps its index for the backward pass), and a real one
    # even when first built while torch.export traces with fake tensors (the cache
    # keeps it, and the exported program holds it as a constant)
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with torch.inference_mode(False), unset_fake_temporarily():
        return torch.from_numpy(a).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _bilinear_device_plan(in_size: int, out_size: int, device: torch.device,
                          dtype: torch.dtype) -> tuple:
    """(idx0, idx1, w1) on ``device``; idx1 and w1 are None where the lerp is a gather."""
    idx0, idx1, w1 = _bilinear_axis_plan(in_size, out_size)
    i0 = _device_tensor(idx0, device, torch.int64)
    if np.all(w1 == 0.0) and np.array_equal(idx0, idx1):
        return i0, None, None
    return i0, _device_tensor(idx1, device, torch.int64), _device_tensor(w1, device, dtype)


@functools.lru_cache(maxsize=None)
def _nearest_device_index(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return _device_tensor(_nearest_axis_plan(in_size, out_size), device, torch.int64)


def _lerp_axis(x: torch.Tensor, dim: int, in_size: int, out_size: int) -> torch.Tensor:
    idx0, idx1, w1 = _bilinear_device_plan(in_size, out_size, x.device, x.dtype)
    x0 = x.index_select(dim, idx0)
    if idx1 is None:
        return x0
    x1 = x.index_select(dim, idx1)
    shape = [1] * x.dim()
    shape[dim] = -1
    return x0 + (x1 - x0) * w1.reshape(shape)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=False, PyTorch-exact."""
    h, w = int(x.shape[2]), int(x.shape[3])
    oh, ow = int(size[0]), int(size[1])
    if h != oh:
        x = _lerp_axis(x, 2, h, oh)
    if w != ow:
        x = _lerp_axis(x, 3, w, ow)
    return x


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NCHW nearest resize with PyTorch's asymmetric floor(i*in/out) convention."""
    h, w = int(x.shape[2]), int(x.shape[3])
    oh, ow = int(size[0]), int(size[1])
    if h != oh:
        x = x.index_select(2, _nearest_device_index(h, oh, x.device))
    if w != ow:
        x = x.index_select(3, _nearest_device_index(w, ow, x.device))
    return x


def resize(x: torch.Tensor, size: tuple[int, int], mode: str = "bilinear") -> torch.Tensor:
    if mode == "bilinear":
        return resize_bilinear(x, size)
    if mode == "nearest":
        return resize_nearest(x, size)
    raise ValueError(f"unsupported resize mode: {mode}")
