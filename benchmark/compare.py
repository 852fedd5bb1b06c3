"""The numbers that decide ``correct``, each against the plain reference.

Training (the first three steps of the object the window then drives):

- ``loss1_gap``: the first step's loss, its relative gap. ``loss_gap``:
  the largest over steps 1-3.
- ``bn1_gap``: the change of BatchNorm's moving statistics over the first
  step (the batch's statistics of every layer, a smooth function of the
  forward), by the worst leaf: the norm of the difference over the larger
  of the reference's norm of that leaf and of the median leaf.
  ``bn3_gap``: the same over the third step, which the program takes by
  replaying its captured step on a new batch, as the window does; the
  reference takes that step again from the program's state after its
  second step (``drivers/train_loop.reference_readings``).
- ``change_gap``: the change of every variable over the three steps
  (BatchNorm's moving statistics included), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.
- ``grad_gap`` (worst leaf) and ``grad_gap_median``: the first step's
  gradient as the optimizer got it (Adam's first moment after one step,
  over 1 - beta1), by the same gap of norms; ``grad_diff`` and
  ``grad_diff_median``: by the norm of the difference instead.
- ``*_median``: the median leaf's reading instead of the worst's.

Each cell's workload file names the ones it compares, with their limits
(``limits``); the rest are logged beside them. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of the
leaf readings of gradients and changes: their gradient is nought but for
rounding (a dense bias in front of BatchNorm, which the batch mean
cancels), and Adam moves them by the sign of that rounding alone.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Tuple

import torch

Tensor = torch.Tensor
NEGLIGIBLE = 1e-3


def norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


def _gaps(side: Dict[str, float], ref: Dict[str, float],
          leaves: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of the reference's norm
    of that leaf and of the median leaf."""
    leaves = list(leaves)
    median = statistics.median(ref[k] for k in leaves)
    return {k: abs(side[k] - ref[k]) / max(ref[k], median) for k in leaves}


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _median(gaps: Dict[str, float]) -> Tuple[float, str]:
    ranked = sorted(gaps, key=gaps.get)
    middle = ranked[(len(ranked) - 1) // 2]
    return statistics.median(gaps.values()), middle


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * median]


def _diffs(side: Dict[str, Tensor], ref: Dict[str, Tensor],
           leaves: Iterable[str]) -> Dict[str, float]:
    """Each leaf's norm of the difference, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    leaves = list(leaves)
    size = {k: float(ref[k].float().norm()) for k in leaves}
    median = statistics.median(size.values())
    return {k: float((side[k].float() - ref[k].float()).norm())
            / max(size[k], median) for k in leaves}


def training(side: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """Each number, with where it was worst (or, for a median, the median
    leaf). ``side`` and ``ref`` hold ``losses`` (three), ``grad1`` and
    ``change`` (leaf -> norm), ``grad1_t`` (leaf -> the gradient) and
    ``bn1`` and ``bn3`` (leaf -> the moving statistic's change)."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(side["losses"],
                                                     ref["losses"])]
    step = max(range(len(loss_gaps)), key=loss_gaps.__getitem__)
    leaves = counted_leaves(ref["grad1"])
    buffers = [k for k in ref["change"] if k not in ref["grad1"]]
    grad = _gaps(side["grad1"], ref["grad1"], leaves)
    change = _gaps(side["change"], ref["change"], leaves + buffers)
    diff = _diffs(side["grad1_t"], ref["grad1_t"], leaves)
    bn1 = _diffs(side["bn1"], ref["bn1"], ref["bn1"])
    bn3 = _diffs(side["bn3"], ref["bn3"], ref["bn3"])
    return {"loss1_gap": (loss_gaps[0], "step 1"),
            "bn1_gap": _worst(bn1),
            "bn1_gap_median": _median(bn1),
            "bn3_gap": _worst(bn3),
            "bn3_gap_median": _median(bn3),
            "grad_diff_median": _median(diff),
            "grad_diff": _worst(diff),
            "loss_gap": (loss_gaps[step], f"step {step + 1}"),
            "grad_gap_median": _median(grad),
            "grad_gap": _worst(grad),
            "change_gap_median": _median(change),
            "change_gap": _worst(change)}

