"""What every cell shares: finding a cell's files by name, the card check,
the per-layer metrics' readers, the check that JAX stayed out, and the
result line.

A cell (``BENCHMARK.json`` ``workloads``) is found by name:
``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``), its driver
(``benchmark/drivers/<driver>.py``, whose ``run(Run)`` sets up, measures
and checks), its traffic parameters, its traced stretch and its limits.
A per-layer metric ``<name>`` is read by ``benchmark/metrics/<name>.py``:
its ``KERNELS`` (kernel id -> (counted wrapper, launches a call)) and
``read(trace)``, which returns the number or None when the trace holds
nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# Top-level module names that must not be loaded, compared whole: the
# port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "pointnet_autoencoder_tpu")


class Refused(RuntimeError):
    """The run cannot produce a result; the message says why."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> Dict:
    return load_json(REPO / "BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """A Python file by path (metric files carry dots in their names)."""
    name = "benchmark_file_" + "".join(c if c.isalnum() else "_"
                                       for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(cell: str, spec: Optional[Dict] = None) -> Tuple[Dict, Dict]:
    """(workload, config) of the cell named ``cell``."""
    spec = spec or benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise Refused(f"no workload {cell!r} in BENCHMARK.json")
    workload = load_json(ROOT / "workloads" / f"{cell}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                      entry["traffic"]):
        raise Refused(f"{cell}: BENCHMARK.json and its workload file name "
                      f"different configurations or traffic")
    config = load_json(ROOT / "configs" / f"{entry['config']}.json")
    return workload, config


def cell_metrics(cell: str, spec: Dict) -> Tuple[List[Dict], List[Dict]]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


def readers(layer: List[Dict]) -> Dict[str, ModuleType]:
    return {m["name"]: load_module(ROOT / "metrics" / f"{m['name']}.py")
            for m in layer}


def declared_kernels(modules: Dict[str, ModuleType]) -> Dict:
    out = {}
    for module in modules.values():
        out.update(module.KERNELS)
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card_check(chips: int):
    """The CUDA device to run on; Refused without ``chips`` cards."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def card_line(device) -> str:
    """The card's name and power limit, for the log."""
    import torch
    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"power limit not read ({e})"
    return f"{name} ({limit})"


def launch_counts() -> Dict[str, int]:
    """The program's launch counters (``utils/graphs.COUNTED``), by the
    name of each counted kernel wrapper."""
    from pointnet_autoencoder_tpu_torch.utils import graphs
    return {fn.__name__: n for fn, n in zip(graphs.COUNTED,
                                            graphs.launch_counts())}


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The process's peak of allocated device memory (0 off the card)."""
    import torch
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


@dataclasses.dataclass
class Run:
    """One run of one cell, as a driver gets it."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    workload: Dict
    config: Dict
    device: object
    t0: float
    declared: Dict
    log: Callable[[str], None]


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its work, its end-to-end numbers, the
    compared numbers (name -> (value, limit)), the memory peak and, in a
    traced run, the checked trace."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    trace: Optional[object] = None


def metric_values(outcome: Outcome, e2e: List[Dict], layer: List[Dict],
                  modules: Dict[str, ModuleType], traced: bool) -> Dict:
    """The result's ``metrics``: the end-to-end ones, or in a traced run
    the per-layer ones read from the trace. Refused if one is missing, or
    a share of a roofline or a peak is not above 0."""
    out = {}
    if not traced:
        for m in e2e:
            value = outcome.end_to_end.get(m["name"])
            if value is None or not math.isfinite(value):
                raise Refused(f"no value for {m['name']}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in layer:
        value = modules[m["name"]].read(outcome.trace)
        if value is None or not math.isfinite(value):
            raise Refused(f"the checked trace gave no {m['name']}")
        if ("roofline" in m["name"] or "mfu" in m["name"]) and value <= 0:
            raise Refused(f"{m['name']} read {value}, a share not above 0")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(outcome: Outcome, metrics: Dict, device, traced: bool
                ) -> Tuple[Dict, bool]:
    import torch
    correct = outcome.failed == 0 and all(
        math.isfinite(v) and v <= limit
        for v, limit in outcome.checks.values())
    card = device.type == "cuda"
    dev = {"platform": "gpu" if card else device.type,
           "kind": torch.cuda.get_device_name(device) if card else "cpu",
           "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = outcome.trace.busy_s
        dev["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": limit}
                      for k, (v, limit) in outcome.checks.items()}
    return line, correct
