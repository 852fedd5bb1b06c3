"""The plain reference against the port's CPU path at a small size, in
f32 where both compute the same function: the first step's loss and
gradient, BatchNorm's moving statistics over steps 1 and 3, and the three
steps' change."""

import pytest

from benchmark import compare
from benchmark.tests import small


@pytest.mark.parametrize("cell", ["train.model.b32", "train.model_emd.b32"])
def test_train_steps_match(cell):
    run = small.cpu_run(cell, 2 ** 33 + 11, compute_dtype="float32")
    driver = small.harness.load_module(small.harness.ROOT / "drivers"
                                       / "train_loop.py")
    prog = driver.TrainProgram(run)
    ref = driver.reference_readings(run.config, prog.variables, prog.first,
                                    prog.resumed)
    side = prog.readings
    assert abs(side["losses"][0] - ref["losses"][0]) <= 1e-5 * ref["losses"][0]
    found = compare.training(side, ref)
    assert found["grad_gap"][0] < 1e-4
    assert found["bn1_gap"][0] < 1e-4
    assert found["bn3_gap"][0] < 1e-4
    # Adam normalizes each element's step: the rounding of near-zero
    # gradients moves the later steps by more than the first.
    assert found["change_gap"][0] < 2e-2

