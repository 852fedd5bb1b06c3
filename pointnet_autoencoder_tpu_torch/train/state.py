"""Train state: the model (parameters and BN moving statistics), the
optimizer and its slots, and the global step, kept together so that one
checkpoint holds them all. The port's counterpart of
``pointnet_autoencoder_tpu/train/state.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable

import torch
from torch import nn


def make_optimizer(name: str, params: Iterable[nn.Parameter],
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """'adam' or 'momentum', the reference's two choices. TF's Adam
    defaults (b1 0.9, b2 0.999, eps 1e-8, the same update as optax.adam)
    and plain momentum SGD (no Nesterov, no dampening: optax.sgd's trace
    form). The learning rate is written into the param groups before each
    step (``TrainState.set_lr``); 0.0 until then."""
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if name == "momentum":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               nesterov=False)
    raise ValueError(f"unknown optimizer {name!r} (use 'adam' or 'momentum')")


@dataclasses.dataclass
class TrainState:
    """step: the global step (the reference's ``batch`` variable), the
    number of optimizer steps taken; the schedules read it before the
    step, as optax reads its schedule at the pre-increment count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    step: int = 0

    def set_lr(self) -> float:
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
