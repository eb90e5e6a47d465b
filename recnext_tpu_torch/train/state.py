"""Train state: the step, the model (fp32 parameters and BN statistics), the
optimizer and the EMA copy of the model.

Counterpart of ``recnext_tpu/train/state.py``. JAX's state is an immutable pytree
that each step replaces; here the step updates the model, the optimizer and the EMA
in place, which keeps one copy of each on the device. The EMA holds every
parameter and the BN running statistics (``running_mean``, ``running_var``; not
``num_batches_tracked``), updated once per optimizer update by timm's ModelEma
rule ``e = decay * e + (1 - decay) * v``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from recnext_tpu_torch.train.optim import Optimizer


def ema_targets(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors the EMA tracks, by state-dict key: every parameter and the BN
    running statistics."""
    out = dict(model.named_parameters())
    out.update({k: v for k, v in model.named_buffers()
                if k.endswith((".running_mean", ".running_var"))})
    return out


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """e = decay * e + (1 - decay) * v, for every tracked tensor, in place."""
    cur = ema_targets(model)
    es = list(ema.values())
    vs = [cur[k].to(ema[k].dtype) for k in ema]
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, vs, alpha=1.0 - decay)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer, ema: bool = True) -> "TrainState":
        copy = ({k: v.detach().clone() for k, v in ema_targets(model).items()}
                if ema else None)
        return cls(model=model, optimizer=optimizer, step=0, ema=copy)

    def variables(self, ema: bool = False) -> Dict[str, torch.Tensor]:
        """The model's state dict, with the EMA values in place of the tracked
        tensors when ``ema``."""
        sd = self.model.state_dict()
        if ema:
            if self.ema is None:
                raise ValueError("this train state keeps no EMA")
            sd.update(self.ema)
        return sd

    def state_dict(self) -> dict:
        """Everything a checkpoint keeps."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            if state["ema"] is None:
                raise ValueError("the checkpoint keeps no EMA")
            with torch.no_grad():
                for k, v in self.ema.items():
                    v.copy_(state["ema"][k])
