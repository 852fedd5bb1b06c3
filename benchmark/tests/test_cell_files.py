"""BENCHMARK.json against the contract's form: every entry resolves to its
files, and every name, unit and text keeps to the allowed characters;
every workload file's driver keeps to the driver contract
(``benchmark/README.md``)."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests import small

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
# Keys that name a width, which a cut may never change: a hidden,
# intermediate, latent, state or projection size, a head size, an
# expansion factor, the experts per token, and this repo's lists of layer
# widths.
WIDTH = re.compile(r"(_dim|_rank|_widths?)$|hidden|intermediate|latent|"
                   r"state_size|^d_state$|projection|head_size|expan|"
                   r"per_tok")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(_text(w) for w in SPEC["command"])
    assert len(SPEC["command"]) <= 32
    assert all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert len(json.dumps(SPEC, indent=1)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _text(entry["source"])
    assert _text(entry["why"])
    assert entry["file"].startswith("benchmark/configs/")
    config = harness.load_json(harness.REPO / entry["file"])
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    cuts = config.get("cuts", {})
    assert set(cuts) == set(entry["reduced"])
    for key in entry["reduced"]:
        # A key of the file, cut in scale only; the file says what the
        # source publishes and the deployment the cut stands for.
        assert NAME.match(key) and key in config and not WIDTH.search(key)
        assert _text(cuts[key]) and cuts[key].strip()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and _text(entry["why"])
    workload, config = harness.cell_files(cell, SPEC)
    assert (harness.ROOT / "drivers" / f"{workload['driver']}.py").is_file()
    assert workload["why"] == entry["why"]
    assert all(isinstance(v, float) and v > 0
               for v in workload["limits"].values())
    e2e, layer = harness.cell_metrics(cell, SPEC)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    modules = harness.readers(layer)
    assert all(callable(m.read) and isinstance(m.KERNELS, dict)
               for m in modules.values())


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert _text(metric["layer"])
    moves = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moves.get("workloads", CELLS))
    assert (harness.ROOT / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("cell", sorted(small.workloads()))
def test_driver_contract(cell):
    driver = small.driver(cell)
    assert callable(driver.run) and callable(driver.calibration)
    assert isinstance(getattr(driver, "TRAIN_STEP", False), bool)
    workload, config = small.files(cell)
    limits = dict(workload["limits"])
    out = driver.small(workload, config)
    assert isinstance(out, tuple) and len(out) == 2
    assert out[0]["limits"] == limits
