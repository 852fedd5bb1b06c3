"""LR and BN-momentum staircase schedules, the port's copy of
``pointnet_autoencoder_tpu/train/schedules.py``:

- learning rate: base * decay_rate ** floor(step * batch_size /
  decay_step). The reference's 1e-5 floor is dead code in the published
  training script, so there is no floor unless ``floor`` is given.
- bn_decay (the BatchNorm momentum): min(0.99, 1 - 0.5 * 0.5 **
  floor(step * batch_size / decay_step)), ramping 0.5 -> 0.99.
- PCN's loss weight alpha (``pcn_alpha_schedule``), piecewise constant
  in the step (``PiecewiseConstant``, TF's ``piecewise_constant``).

Each schedule has two forms, which compute as the JAX package does in
f32 and give the same values:

- ``schedule.tensor(step)``, a 0-dim f32 tensor of a device step counter
  (an integer tensor), computed on that device with no host sync, so a
  captured train step reads it at every replay, as the JAX package
  computes its schedules inside the jit;
- ``schedule.f32(step)``, the same value computed on the host as a float
  (the reference the tests hold the tensor form to).

Both take the exponent ``floor(f32(step) * batch_size / decay_step)``,
then ``f32(base) * rate ** exponent``. The power is taken in float64 and
rounded to f32, which gives XLA's f32 power on the CPU bit for bit over
the exponents a run reaches (torch's and CUDA's f32 ``pow`` are each off
by an ulp at some of them).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

BN_INIT_DECAY = 0.5
BN_DECAY_RATE = 0.5
BN_DECAY_CLIP = 0.99


class Staircase:
    """``base * rate ** floor(step * batch_size / decay_step)``, then
    ``1 - value`` if ``complement``, then at least ``floor`` and at most
    ``clip``, in f32 (see the module docstring)."""

    def __init__(self, base: float, rate: float, batch_size: int,
                 decay_step: int, floor: Optional[float] = None,
                 complement: bool = False, clip: Optional[float] = None):
        self.base = np.float32(base)
        self.rate = float(np.float32(rate))
        self.batch_size = batch_size
        self.decay_step = decay_step
        self.floor = floor
        self.complement = complement
        self.clip = clip

    def f32(self, step: int) -> float:
        exponent = np.floor(np.float32(step) * np.float32(self.batch_size)
                            / np.float32(self.decay_step))
        value = self.base * np.float32(np.power(self.rate,
                                                np.float64(exponent)))
        if self.complement:
            value = np.float32(1.0) - value
        if self.floor is not None:
            value = max(value, np.float32(self.floor))
        if self.clip is not None:
            value = min(value, np.float32(self.clip))
        return float(value)

    def tensor(self, step: Tensor) -> Tensor:
        exponent = torch.floor(step.float() * self.batch_size
                               / self.decay_step)
        power = torch.pow(torch.full((), self.rate, dtype=torch.float64,
                                     device=step.device),
                          exponent.double()).float()
        value = power * float(self.base)
        if self.complement:
            value = 1.0 - value
        if self.floor is not None:
            value = torch.clamp_min(value, self.floor)
        if self.clip is not None:
            value = torch.clamp_max(value, self.clip)
        return value


def learning_rate_schedule(base_lr: float, decay_rate: float,
                           batch_size: int, decay_step: int,
                           floor: Optional[float] = None) -> Staircase:
    return Staircase(base_lr, decay_rate, batch_size, decay_step,
                     floor=floor)


def bn_momentum_schedule(batch_size: int, decay_step: int) -> Staircase:
    """bn_decay(step): the moving-average momentum fed to BatchNorm."""
    return Staircase(BN_INIT_DECAY, BN_DECAY_RATE, batch_size, decay_step,
                     complement=True, clip=BN_DECAY_CLIP)


class PiecewiseConstant:
    """TF's ``tf.train.piecewise_constant(step, boundaries, values)``:
    ``values[0]`` while ``step <= boundaries[0]``, ``values[i]`` while
    ``boundaries[i - 1] < step <= boundaries[i]``, and ``values[-1]``
    past the last boundary, in f32. The same two forms as ``Staircase``:
    ``tensor(step)`` on the step counter's device with no host sync,
    ``f32(step)`` on the host."""

    def __init__(self, boundaries, values):
        if len(values) != len(boundaries) + 1:
            raise ValueError(f"{len(boundaries)} boundaries need "
                             f"{len(boundaries) + 1} values, got "
                             f"{len(values)}")
        self.boundaries = tuple(int(b) for b in boundaries)
        self.values = tuple(float(np.float32(v)) for v in values)

    def f32(self, step: int) -> float:
        passed = sum(int(step) > b for b in self.boundaries)
        return self.values[passed]

    def tensor(self, step: Tensor) -> Tensor:
        value = torch.full((), self.values[0], dtype=torch.float32,
                           device=step.device)
        for b, v in zip(self.boundaries, self.values[1:]):
            value = torch.where(step > b, v, value)
        return value


def pcn_alpha_schedule() -> PiecewiseConstant:
    """PCN's weight of the fine Chamfer term (``train.py``: ``alpha``):
    0.01, 0.1, 0.5, then 1.0 past steps 10k, 20k and 50k."""
    return PiecewiseConstant((10000, 20000, 50000), (0.01, 0.1, 0.5, 1.0))
