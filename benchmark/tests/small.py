"""A workload's files at a size a CPU test can hold: the preset of the
cell's own driver (``drivers/<driver>.py`` ``small``); everything else as
the files state, limits included."""

from __future__ import annotations

import time
from types import ModuleType
from typing import Dict, Tuple

import torch

from benchmark import calibrate, harness


def files(cell: str) -> Tuple[Dict, Dict]:
    """(workload, config) of the workload file ``cell``, as they stand."""
    workload = harness.load_json(harness.ROOT / "workloads" / f"{cell}.json")
    return workload, harness.load_json(harness.ROOT / "configs"
                                       / f"{workload['config']}.json")


def driver(cell: str) -> ModuleType:
    """The driver that the workload file ``cell`` names."""
    return calibrate.driver(files(cell)[0])


def small(cell: str, compute_dtype: str = "") -> Tuple[Dict, Dict]:
    workload, config = driver(cell).small(*files(cell))
    if compute_dtype:
        config["compute_dtype"] = compute_dtype
    return workload, config


def cpu_run(cell: str, seed: int, seconds: float = 0.3,
            compute_dtype: str = "") -> harness.Run:
    workload, config = small(cell, compute_dtype)
    return harness.Run(cell, seed, seconds, False, workload, config,
                       torch.device("cpu"), time.perf_counter(), {},
                       lambda msg: None)


def drive(run: harness.Run) -> harness.Outcome:
    """The rest of a run after the look for a card: the cell's driver."""
    return calibrate.driver(run.workload).run(run)


def correct(outcome: harness.Outcome) -> bool:
    line, ok = harness.result_line(outcome, {}, torch.device("cpu"), False)
    assert line["correct"] is ok
    return ok


def workloads():
    """Every workload file, by name, with its driver."""
    return {p.stem: harness.load_json(p)["driver"]
            for p in sorted((harness.ROOT / "workloads").glob("*.json"))}


def train_step_cells():
    """The workload files whose driver drives the library train step
    (``TRAIN_STEP``), which the fault tests plant into."""
    return [cell for cell in workloads()
            if getattr(driver(cell), "TRAIN_STEP", False)]
