"""Replicated inference: one replica of the model a device, the batch split evenly.

Counterpart of ``recnext_tpu/parallel/serving.py:make_sharded_inference``, where the
batch is sharded over a mesh under one ``jit``. Here each device holds a replica
and runs its share of the batch in a thread of its own; the logits come back in
batch order on the first device. On one H100 it is one replica. FSDP-sharded
parameters (the JAX version's ``fsdp_params``) are not ported
(``parallel/sharding.py:FSDP_ITEM``).
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping, Sequence

import torch
import torch.nn as nn


def make_sharded_inference(model: nn.Module | str, state_dict: Mapping[str, torch.Tensor],
                           devices: Sequence | None = None,
                           **overrides) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns ``infer(images) -> logits`` over replicas of ``model`` (a module, copied
    to each device, or a registry name built with ``overrides``) holding
    ``state_dict``, on ``devices`` (default: every GPU; raises without one), in the
    model's dtype. The batch must divide by the replicas."""
    from recnext_tpu_torch.device import resolve_device
    from recnext_tpu_torch.models.registry import create_model

    if devices is None:
        resolve_device(None)  # raises without a GPU
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    replicas = []
    for dev in devices:
        m = (create_model(model, device=dev, **overrides) if isinstance(model, str)
             else copy.deepcopy(model).to(dev))
        m.load_state_dict(state_dict, strict=True)
        replicas.append(m.eval().requires_grad_(False))
    in_dtype = next(replicas[0].parameters()).dtype

    def run(replica, dev, x):
        with torch.inference_mode():
            return replica(x.to(dev, in_dtype))

    def infer(x: torch.Tensor) -> torch.Tensor:
        n = len(replicas)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} is not divisible by {n} replicas")
        parts = x.chunk(n)
        if n == 1:
            return run(replicas[0], devices[0], x)
        with ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(run, replicas, devices, parts))
        return torch.cat([o.to(devices[0]) for o in outs])

    return infer
