"""A configuration with its own reference and driver joins the benchmark
by new files and its entries in ``BENCHMARK.json`` alone.

A copy of ``benchmark/`` and ``BENCHMARK.json`` gets the stand-in of
``tests/standin/`` as new files (a configuration, its plain reference, its
driver through ``TrainState.train_step``, a workload) and entries appended
to the copy's ``BENCHMARK.json``. With ``harness.ROOT`` and ``REPO``
pointed at the copy, the contract tests, the calibration sides, the
control check and the CPU fault tests take it through its own driver:
the control and the faults come out not correct, a sound run correct, and
every file of the copy's ``benchmark/`` is byte-identical afterwards."""

import copy as copying
import hashlib
import json
import shutil

import pytest

from benchmark import calibrate, harness
from benchmark.tests import (small, test_cell_files, test_controls,
                             test_faults, test_no_jax)

CELL, CONFIG = "train.standin.b8", "standin"
STANDIN = harness.ROOT / "tests" / "standin"
# Metrics whose cell lists the new cell is appended to.
APPENDED = ("train_shapes_per_s", "idle_pct.train")


def _digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _with_standin(spec):
    spec = copying.deepcopy(spec)
    config = harness.load_json(STANDIN / "configs" / f"{CONFIG}.json")
    workload = harness.load_json(STANDIN / "workloads" / f"{CELL}.json")
    spec["configs"].append({
        "name": CONFIG, "source": config["source"],
        "file": f"benchmark/configs/{CONFIG}.json",
        "reduced": config["reduced"],
        "why": "a model the PointNet reference does not describe"})
    spec["workloads"].append({"name": CELL, "config": CONFIG,
                              "traffic": workload["traffic"], "chips": 1,
                              "why": workload["why"]})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if metric["name"] in APPENDED:
            metric["workloads"].append(CELL)
    return spec


class Copy:
    def __init__(self, root):
        self.root = root
        bench = root / "benchmark"
        shutil.copytree(harness.ROOT, bench,
                        ignore=shutil.ignore_patterns("__pycache__"))
        self.spec = harness.load_json(harness.REPO / "BENCHMARK.json")
        self.before = _digests(bench)
        for src in sorted(STANDIN.rglob("*.*")):
            if "__pycache__" in src.parts:
                continue
            dest = bench / src.relative_to(STANDIN)
            assert not dest.exists(), dest
            shutil.copy(src, dest)
        with open(root / "BENCHMARK.json", "w") as f:
            json.dump(_with_standin(self.spec), f, indent=1)

    def check_unchanged(self):
        """Every file the copy held before the stand-in is byte-identical,
        and its ``BENCHMARK.json`` only gained the stand-in's entries."""
        after = _digests(self.root / "benchmark")
        assert {k: after.get(k) for k in self.before} == self.before
        spec = harness.load_json(self.root / "BENCHMARK.json")
        assert spec == _with_standin(self.spec)


@pytest.fixture
def copy(tmp_path, monkeypatch):
    c = Copy(tmp_path / "repo")
    monkeypatch.setattr(harness, "ROOT", c.root / "benchmark")
    monkeypatch.setattr(harness, "REPO", c.root)
    spec = harness.benchmark_spec()
    monkeypatch.setattr(test_cell_files, "SPEC", spec)
    monkeypatch.setattr(test_cell_files, "CELLS",
                        [w["name"] for w in spec["workloads"]])
    return c


def test_contract_tests_take_the_standin(copy):
    assert CELL in small.workloads() and CELL in small.train_step_cells()
    spec = test_cell_files.SPEC
    test_cell_files.test_top_level_keys()
    test_cell_files.test_config_resolves(
        next(e for e in spec["configs"] if e["name"] == CONFIG))
    test_cell_files.test_cell_resolves(CELL)
    for metric in spec["end_to_end"] + spec["per_layer"]:
        test_cell_files.test_metric_form(metric)
    test_cell_files.test_driver_contract(CELL)
    assert small.driver(CELL).__file__ == str(
        copy.root / "benchmark" / "drivers" / "standin_loop.py")
    copy.check_unchanged()


def test_calibration_and_control_go_through_its_driver(copy):
    run = small.cpu_run(CELL, 2 ** 31 + 29)
    sides = {line["side"]: line["readings"]
             for line in calibrate.sides(run, control=True)}
    limits = run.workload["limits"]
    assert set(sides) == {"program", "control", "half_batch", "unchanged"}
    for side, readings in sides.items():
        assert test_controls._fails(readings, limits) == (side != "program"), \
            (side, sides)
    test_controls.test_control_fails_small(CELL)
    copy.check_unchanged()


@pytest.mark.parametrize("fault", [test_faults._unchanged,
                                   test_faults._half_batch],
                         ids=["unchanged", "half_batch"])
def test_cpu_faults_and_a_sound_run_through_its_driver(copy, fault):
    with pytest.MonkeyPatch.context() as planted:
        test_faults.test_train_fault_is_not_correct(CELL, fault, planted)
    test_faults.test_sound_run_is_correct(CELL)
    copy.check_unchanged()


def test_standin_reference_imports_nothing_of_the_program(copy):
    imports = "import benchmark.reference.standin"
    assert test_no_jax._loaded(imports, harness.FORBIDDEN
                               + ("pointnet_autoencoder_tpu_torch",)) == ""
    copy.check_unchanged()
