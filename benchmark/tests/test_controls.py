"""The control comes out not correct: the reference in the precision
below the configuration's (for ``train_loop``, every matmul in fp8 under
the configurations' bf16) put in the program's place, against each
workload's own limits. Every cell goes through ``benchmark.calibrate``,
which runs the sides of the cell's own driver. On the CPU at the driver's
small preset; with a card, at the workload's own sizes on three seeds,
every side of the driver's whose name begins with ``control`` (for
``train_loop`` also fp8 in the replayed steps alone)."""

import pytest

from benchmark import calibrate, harness
from benchmark.tests import small

CELLS = sorted(small.workloads())


def _fails(readings, limits) -> bool:
    return any(readings[k] > limits[k] for k in limits)


def _control(run):
    lines = calibrate.sides(run, control=True)
    return {line["side"]: line["readings"] for line in lines}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    run = small.cpu_run(cell, 2 ** 31 + 17)
    sides = _control(run)
    assert _fails(sides["control"], run.workload["limits"]), sides


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    import time
    workload, config = small.files(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        run = harness.Run(cell, seed, 0.0, False, workload, config, card,
                          time.perf_counter(), {}, lambda msg: None)
        sides = _control(run)
        assert not _fails(sides["program"], workload["limits"]), sides
        controls = [k for k in sides if k.startswith("control")]
        assert "control" in controls, sides
        for k in controls:
            assert _fails(sides[k], workload["limits"]), (k, sides)
