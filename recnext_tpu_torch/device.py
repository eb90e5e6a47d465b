"""Device resolution for the port's entry points.

Every entry point (model creation, serving, the CLI) runs on the GPU unless the
caller names another device. With no GPU present it raises instead of quietly
running on the CPU: a CPU run of a GPU deployment is a different system, and its
numbers must never pass for the card's.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the GPU. A CUDA device without a GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
