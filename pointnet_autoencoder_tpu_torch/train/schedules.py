"""LR and BN-momentum staircase schedules, the port's copy of
``pointnet_autoencoder_tpu/train/schedules.py``, as plain functions of the
integer step:

- learning rate: base * decay_rate ** floor(step * batch_size /
  decay_step). The reference's 1e-5 floor is dead code in the published
  training script, so there is no floor unless ``floor`` is given.
- bn_decay (the BatchNorm momentum): min(0.99, 1 - 0.5 * 0.5 **
  floor(step * batch_size / decay_step)), ramping 0.5 -> 0.99.
"""

from __future__ import annotations

from typing import Callable, Optional

BN_INIT_DECAY = 0.5
BN_DECAY_RATE = 0.5
BN_DECAY_CLIP = 0.99


def staircase(base: float, rate: float, batch_size: int,
              decay_step: int) -> Callable[[int], float]:
    def fn(step: int) -> float:
        return base * rate ** ((int(step) * batch_size) // decay_step)

    return fn


def learning_rate_schedule(base_lr: float, decay_rate: float,
                           batch_size: int, decay_step: int,
                           floor: Optional[float] = None
                           ) -> Callable[[int], float]:
    stair = staircase(base_lr, decay_rate, batch_size, decay_step)
    if floor is None:
        return stair
    return lambda step: max(stair(step), floor)


def bn_momentum_schedule(batch_size: int,
                         decay_step: int) -> Callable[[int], float]:
    """bn_decay(step): the moving-average momentum fed to BatchNorm."""
    stair = staircase(BN_INIT_DECAY, BN_DECAY_RATE, batch_size, decay_step)
    return lambda step: min(BN_DECAY_CLIP, 1.0 - stair(step))
