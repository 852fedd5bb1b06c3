"""Train state: the model (parameters and BN moving statistics), the
optimizer and its slots, and the global step, kept together so that one
checkpoint holds them all. The port's counterpart of
``pointnet_autoencoder_tpu/train/state.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional

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

    def train_step(self, batch: torch.Tensor, loss_fn: Callable,
                   bn_schedule: Callable[[int], float],
                   reduce_gradients: Optional[Callable] = None,
                   context: Callable = contextlib.nullcontext
                   ) -> Dict[str, Any]:
        """One optimizer step on ``batch``, its own label: forward with
        bn_momentum = bn_schedule(step) and the learning rate lr(step)
        (both read before the step advances), ``loss_fn(pred, batch,
        end_points)``, backward, ``reduce_gradients(parameters)`` (the
        collectives of a parallel step), the optimizer. The forward,
        loss and backward run inside ``context()``. Returns the loss, the
        metrics (detached), the learning rate and the BN momentum."""
        bn_momentum = bn_schedule(self.step)
        lr = self.set_lr()
        with context():
            pred, end_points = self.model(batch, train=True,
                                          bn_momentum=bn_momentum)
            loss, metrics = loss_fn(pred, batch, end_points)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if reduce_gradients is not None:
            reduce_gradients(self.model.parameters())
        self.optimizer.step()
        self.step += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        out["learning_rate"] = lr
        out["bn_decay"] = bn_momentum
        return out

    @torch.no_grad()
    def eval_step(self, batch: torch.Tensor, loss_fn: Callable,
                  context: Callable = contextlib.nullcontext
                  ) -> Dict[str, Any]:
        """The loss and metrics of the eval forward on ``batch``."""
        with context():
            pred, end_points = self.model(batch, train=False)
            loss, metrics = loss_fn(pred, batch, end_points)
        out = dict(metrics)
        out["loss"] = loss
        return out
