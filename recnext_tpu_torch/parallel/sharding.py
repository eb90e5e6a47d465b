"""Multi-process data parallelism over ``torch.distributed``.

Counterpart of ``recnext_tpu/parallel/sharding.py``. JAX shards the global batch
over a ("data", "fsdp") mesh and lets ``jit`` insert the collectives; here each
process holds a replica of the model and the state, takes its ``batch_size //
world`` rows of the global batch (rank r holds rows [r*b, (r+1)*b)), and the code
that needs the global batch says so with the two collectives every backend runs,
gloo on CUDA tensors included: ``all_reduce`` and ``broadcast``. So the same code
runs two processes on one GPU (gloo) as well as one process a GPU (NCCL):

* the train step averages the gradients over the ranks in a few flat fp32 buckets
  (``all_reduce_gradients``) before the clip and the optimizer, and takes the loss
  mean over the ranks;
* BatchNorm in train mode normalises by the global batch's statistics
  (``models/layers.py:_sync_batch_norm``);
* mixup pairs global row i with row B-1-i, whose rows sit on rank W-1-r
  (``partner_rows``);
* eval totals are summed over the ranks.

``init_distributed`` starts the process group from the JAX CLI's
``--dist-coordinator host:port``, ``--dist-num-processes``, ``--dist-process-id``
or, without them, from torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``. The backend is chosen before any launch: NCCL where every process
of the host has a GPU of its own; gloo on the CPU and where processes share a GPU
(NCCL refuses two ranks on one device).

FSDP (``make_mesh(fsdp=k)``, ``state_sharding`` with k > 1) is not ported and
raises, naming its ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence

import torch
import torch.distributed as dist

FSDP_ITEM = "ROADMAP.md Queue 1 item 17 (--fsdp > 1, state_sharding)"
BUCKET_BYTES = 32 << 20  # fp32 gradient bytes a bucket of all_reduce_gradients


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def choose_backend(device_type: str, local_world: int, gpus: int) -> str:
    """``nccl`` where every process of the host (``local_world`` of them) has a GPU
    of its own among ``gpus``; ``gloo`` on the CPU and where processes share one."""
    return "nccl" if device_type == "cuda" and local_world <= gpus else "gloo"


def local_device(device: torch.device) -> torch.device:
    """This process's device: on CUDA, GPU ``local rank % device count``."""
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def init_distributed(coordinator: str = "", num_processes: int = 0, process_id: int = -1,
                     *, device_type: str = "cuda", log=print) -> bool:
    """Join the process group: at ``coordinator`` (host:port) as ``process_id`` of
    ``num_processes``, or from torchrun's environment where those are not given.
    Returns True where more than one process takes part (False: one process, no
    group). The backend is logged."""
    env = os.environ
    if not coordinator and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes <= 0:
        num_processes = int(env.get("WORLD_SIZE", "0") or 0)
    if process_id < 0:
        process_id = int(env.get("RANK", "-1") or -1)
    if not coordinator or num_processes <= 1:
        return False
    if not 0 <= process_id < num_processes:
        raise SystemExit(f"--dist-process-id {process_id} not in 0..{num_processes - 1}")
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    gpus = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = choose_backend(device_type, local_world, gpus)
    if backend == "nccl":  # each rank's communicator on its own GPU
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) % gpus)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    log(f"distributed: rank {process_id} of {num_processes}, backend {backend} "
        f"({local_world} processes on this host, {gpus} GPUs)")
    return True


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (and returned); ``t`` as is alone. A CPU
    tensor (eval totals, metric counts) goes through the GPU under NCCL, which
    reduces CUDA tensors only."""
    if world_size() == 1:
        return t
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        on_gpu = t.cuda()
        dist.all_reduce(on_gpu)
        return t.copy_(on_gpu.cpu())
    dist.all_reduce(t)
    return t


def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Every tensor set to rank ``src``'s values, in place."""
    if world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t, src)


def _buckets(tensors: Sequence[torch.Tensor], nbytes: int) -> List[List[torch.Tensor]]:
    out, cur, size = [], [], 0
    for t in tensors:
        cur.append(t)
        size += t.numel() * 4
        if size >= nbytes:
            out.append(cur)
            cur, size = [], 0
    if cur:
        out.append(cur)
    return out


def all_reduce_gradients(params: Sequence[torch.nn.Parameter],
                         bucket_bytes: int = BUCKET_BYTES) -> int:
    """Each parameter's gradient replaced by its mean over the ranks, reduced in flat
    fp32 buckets of about ``bucket_bytes``. Returns the bytes all-reduced (0 alone)."""
    w = world_size()
    grads = [p.grad for p in params if p.grad is not None]
    if w == 1 or not grads:
        return 0
    total = 0
    for bucket in _buckets(grads, bucket_bytes):
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        dist.all_reduce(flat)
        flat.div_(w)
        total += flat.numel() * 4
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
    return total


def partner_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows global mixup pairs with this rank's: of a global batch flipped (row i
    with row B-1-i), the local rows of rank W-1-r reversed. One all_reduce of a
    zero-padded (W, b, ...) buffer; alone, ``x.flip(0)``."""
    w = world_size()
    if w == 1:
        return x.flip(0)
    buf = torch.zeros((w, *x.shape), dtype=x.dtype, device=x.device)
    buf[rank()] = x
    dist.all_reduce(buf)
    return buf[w - 1 - rank()].flip(0)


def make_mesh(n_devices: int | None = None, fsdp: int = 1):
    """The data-parallel layout: (processes, fsdp). FSDP > 1 is not ported."""
    if fsdp > 1:
        raise NotImplementedError(f"--fsdp {fsdp}: FSDP is not ported; see {FSDP_ITEM}")
    return {"data": n_devices or world_size(), "fsdp": 1}


def state_sharding(state, mesh) -> None:
    """Replicated state (every rank holds all of it): the only layout without FSDP."""
    if mesh.get("fsdp", 1) > 1:
        raise NotImplementedError(f"state_sharding over fsdp {mesh['fsdp']}: FSDP is not "
                                  f"ported; see {FSDP_ITEM}")
    return None
