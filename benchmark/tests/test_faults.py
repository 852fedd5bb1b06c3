"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run driven through the
cell's own driver, against the cells' own limits. Every cell whose driver
drives the library train step (``TRAIN_STEP``) is taken. On the CPU at
the driver's small preset, one case for each
fault a cell can have: a train step that leaves its state as it was; a
train step on half of its batch, the mean over the rest. On a card, at
the cells' own sizes, faults planted inside the captured program that the
window replays, the first (eager) step left sound: half of the batch
left out under capture; a replay that leaves its static input as it was
captured. (No cell runs on more than one card, so none can leave out an
exchange between cards.)"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import small
from pointnet_autoencoder_tpu_torch.train.state import TrainState
from pointnet_autoencoder_tpu_torch.utils import graphs

TRAIN = small.train_step_cells()


def _unchanged(monkeypatch):
    step = TrainState.train_step

    def still(self, batch, *args, **kwargs):
        kept = {k: v.clone() for k, v in self.model.state_dict().items()}
        out = step(self, batch, *args, **kwargs)
        self.model.load_state_dict(kept)
        return out

    monkeypatch.setattr(TrainState, "train_step", still)


def _half_batch(monkeypatch):
    step = TrainState.train_step

    def half(self, batch, *args, **kwargs):
        return step(self, batch[: batch.shape[0] // 2], *args, **kwargs)

    monkeypatch.setattr(TrainState, "train_step", half)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["unchanged", "half_batch"])
def test_train_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    outcome = small.drive(small.cpu_run(cell, 2 ** 32 + 3,
                                        compute_dtype="float32"))
    assert not small.correct(outcome), outcome.checks


@pytest.mark.parametrize("cell", TRAIN)
def test_sound_run_is_correct(cell):
    outcome = small.drive(small.cpu_run(cell, 2 ** 32 + 7,
                                        compute_dtype="float32"))
    assert small.correct(outcome), outcome.checks


def _captured_half_batch(monkeypatch):
    step = TrainState.train_step

    def half(self, batch, *args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            batch = batch[: batch.shape[0] // 2]
        return step(self, batch, *args, **kwargs)

    monkeypatch.setattr(TrainState, "train_step", half)


def _stale_input(monkeypatch):
    # The new inputs never copied in: every replay (``StepPrograms.run``
    # loads the inputs apart from the replay) takes the static input as it
    # was captured.
    monkeypatch.setattr(graphs.CapturedProgram, "load",
                        lambda self, *inputs: None)


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_captured_half_batch, _stale_input],
                         ids=["captured_half_batch", "stale_input"])
def test_fault_in_the_captured_step_is_not_correct(cell, fault, card,
                                                   monkeypatch):
    fault(monkeypatch)
    workload, config = small.files(cell)
    run = harness.Run(cell, 2 ** 31 + 211, 2.0, False, workload, config,
                      card, time.perf_counter(), {}, lambda msg: None)
    outcome = small.drive(run)
    assert not small.correct(outcome), outcome.checks
