"""Frozen work counts of PCN's train step (``configs/pcn_emd.json``): its
matmul flops, and the bounds of its loss kernels at its shapes, beside
the frozen ``counts.py``, whose kernel formulas and peaks they use.

The matmul flops follow ``counts.step_matmul_flops``' rules: 2 a
multiply-add; forward once; backward twice the forward (the gradient to
the weight and to the layer's input), but once for the encoder's first
layer, whose input (the points) takes no gradient. Every other layer's
input takes one: the folding's first layer's rows hold the code and the
coarse point, the coarse decoder reads the code. The widths are PCN's
(``models/pcn_emd.py``): the encoder 3 -> 128 -> 256 | 512 -> 512 ->
1024, the coarse decoder 1024 -> 1024 -> 1024 -> 3 * num_coarse, the
folding (2 + 3 + 1024) -> 512 -> 512 -> 3 over every fine point.
``benchmark/tests/test_pcn_emd.py`` pins them equal to the
program's ``utils/roofline.pcn_step_matmul_flops``.
"""

from __future__ import annotations

from typing import Dict

from benchmark import counts

ENCODER = ((3, 128), (128, 256), (512, 512), (512, 1024))
CODE = 1024
COARSE_HIDDEN = (1024, 1024)
FOLDING_HIDDEN = (512, 512)


def step_matmul_flops(batch: int, num_point: int, num_coarse: int,
                      grid_size: int) -> Dict[str, float]:
    """Matmul flops of one train step, forward and backward: {"encoder",
    "coarse", "folding", "network" (their sum)}."""
    points = batch * num_point
    fine = batch * num_coarse * grid_size ** 2
    # Forward and the weight's gradient everywhere; the input's gradient
    # past the first layer.
    encoder = sum((2.0 if i == 0 else 3.0) * 2.0 * points * cin * cout
                  for i, (cin, cout) in enumerate(ENCODER))
    coarse = 3.0 * batch * counts._fc_chain_flops(
        (CODE,) + COARSE_HIDDEN + (3 * num_coarse,))
    folding = 3.0 * fine * counts._fc_chain_flops(
        (2 + 3 + CODE,) + FOLDING_HIDDEN + (3,))
    return {"encoder": encoder, "coarse": coarse, "folding": folding,
            "network": encoder + coarse + folding}


def chamfer_bound_ms(batch: int, n: int, m: int) -> float:
    """K1's and K2's frozen bounds at (batch, n, m), summed."""
    shape = dict(b=batch, n=n, m=m)
    return (counts.kernel_bound("nn_distance", **shape)["bound_ms"]
            + counts.kernel_bound("nn_distance_grad", **shape)["bound_ms"])


def emd_bound_ms(batch: int, n: int) -> float:
    """K6's frozen bound at (batch, n, n)."""
    return counts.kernel_bound("emd_forward", b=batch, n=n, m=n)["bound_ms"]
