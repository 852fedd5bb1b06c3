"""The port's benchmark (``pointnet_autoencoder_tpu_torch/bench.py``)
smoked on the CPU, as ``tests/test_bench.py`` smokes the root one:
``main`` prints complete JSON lines, headline first, with the artifact's
schema on every line, names each extra it skips for the budget, and
writes its self-record only to BENCH_SELF_PATH.
"""

import hashlib
import json
import os

import pytest
import torch

from pointnet_autoencoder_tpu_torch import bench

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(monkeypatch, capsys, budget: str, tmp_path, self_path=True):
    monkeypatch.setenv("BENCH_NUM_POINT", "128")
    monkeypatch.setenv("BENCH_ITERS_SCALE", "0.02")
    monkeypatch.setenv("BENCH_BUDGET_S", budget)
    if self_path:
        monkeypatch.setenv("BENCH_SELF_PATH",
                           str(tmp_path / "BENCH_SELF.json"))
    else:
        monkeypatch.delenv("BENCH_SELF_PATH", raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out, "no artifact lines"
    # stdout carries only complete JSON lines.
    return [json.loads(x) for x in out.splitlines()]


def test_bench_artifact_lines(monkeypatch, capsys, tmp_path):
    lines = _run_bench(monkeypatch, capsys, "600", tmp_path)
    assert (tmp_path / "BENCH_SELF.json").exists()
    for d in lines:
        # BENCH_NUM_POINT=128: the label tracks the workload and the
        # N=2048 baseline ratio does not apply.
        assert d["metric"] == "train_throughput_model_b32_n128"
        assert d["unit"] == "shapes/sec/chip"
        assert d["value"] > 0
        assert d["vs_baseline"] == 0.0
        assert "model_step_ms" in d["extras"]
        assert "model" in d["extras"]["roofline"]
        assert d["extras"]["device"] == {"kind": "cpu", "count": 1}
        assert d["extras"]["group"] is None
    # Headline first, then the extras accumulate.
    assert len(lines) >= 2
    assert "model_emd_step_ms" not in lines[0]["extras"]
    last = lines[-1]["extras"]
    assert last["skipped"] == []
    for key in ("model_emd_step_ms", "serving_fwd_ms", "serving_b1",
                "serving_b512", "bench_wall_s", "recorded_at"):
        assert key in last, key
    assert last["serving_b1"]["dispatch_overhead_ms"] > 0
    # At N != 2048 the families are model_cpu and model_hierachy.
    assert sorted(last["family_step_ms"]) == ["model_cpu", "model_hierachy"]
    assert sorted(last["roofline"]) == ["model", "model_cpu", "model_emd",
                                        "model_hierachy"]
    for name, row in last["rows"].items():
        # The CPU runs eager: no replays, no kernel launches.
        assert row["replays"] is None and row["path"] == "eager (the CPU)"
        assert len(row["windows_ms"]) >= 1 and row["ms"] == min(
            row["windows_ms"]), name
        assert not any(row["launches"].values()), name
    # The self-record is the last line printed.
    with open(tmp_path / "BENCH_SELF.json") as f:
        assert json.loads(f.read()) == lines[-1]


def test_bench_budget_skips_extras_not_artifact(monkeypatch, capsys,
                                                tmp_path):
    """A budget spent at the headline: every extra is skipped by name and
    the headline still lands."""
    lines = _run_bench(monkeypatch, capsys, "0", tmp_path)
    last = lines[-1]["extras"]
    assert last["skipped"] == ["model_emd", "serving", "serving_b1",
                               "families", "serving_b512"]
    assert "model_step_ms" in last and lines[-1]["value"] > 0


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("self_path", [True, False])
def test_bench_never_writes_the_root_self_record(monkeypatch, capsys,
                                                 tmp_path, self_path):
    """The root BENCH_SELF.json is the JAX package's hardware record: the
    port writes its self-record to BENCH_SELF_PATH only, and nowhere when
    that is unset."""
    root_record = os.path.join(ROOT, "BENCH_SELF.json")
    before = _digest(root_record)
    monkeypatch.chdir(tmp_path)
    lines = _run_bench(monkeypatch, capsys, "0", tmp_path,
                       self_path=self_path)
    assert _digest(root_record) == before
    written = sorted(os.listdir(tmp_path))
    assert written == (["BENCH_SELF.json"] if self_path else [])
    assert lines


def test_bench_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
