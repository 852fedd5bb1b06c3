"""The port's parity harness (pointnet_autoencoder_tpu_torch/cli/parity.py)
on the CPU at a tiny size, and its pieces against the JAX package's
cli/parity.py: the fixture it writes, the split counts, the scalars it
reads back and the row it appends.
"""

import filecmp
import json
import math
import os

import pytest
import torch

from pointnet_autoencoder_tpu.cli import parity as jparity
from pointnet_autoencoder_tpu.data import synthetic as jsynthetic
from pointnet_autoencoder_tpu_torch.cli import parity
from pointnet_autoencoder_tpu_torch.data import synthetic

torch.set_num_threads(2)


@pytest.mark.parametrize("shapes,categories,steps,finite", [
    (12, None, 4, False),  # 10 trainval Chair shapes, 2 test: no eval batch
    (24, "Chair", 10, True),  # 20 trainval, 4 test: one eval batch
])
def test_parity_run_appends_one_row(tmp_path, shapes, categories, steps,
                                    finite):
    results = tmp_path / "RESULTS_TORCH.md"
    argv = ["--synth_fixture", "--fixture_shapes", str(shapes),
            "--num_point", "64", "--batch_size", "4", "--max_epoch", "2",
            "--device", "cpu", "--data_path", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / "log"), "--results", str(results)]
    if categories:
        argv += ["--fixture_categories", categories]
    record = parity.run(argv)
    assert record["data"] == "stand-in fixture (NOT the real archive)"
    assert record["train_steps"] == steps
    assert record["backend"] == "cpu"
    assert record["wall_seconds_incl_compile"] > 0
    assert set(record) == {
        "date", "data", "counts", "command", "best_eval_loss",
        "best_eval_chamfer", "train_steps", "wall_seconds_incl_compile",
        "throughput_incl_compile_shapes_per_sec",
        "post_warmup_shapes_per_sec", "backend"}
    chamfer = record["best_eval_chamfer"]
    assert (0 < chamfer < math.inf) if finite else math.isnan(chamfer)
    text = results.read_text()
    rows = [ln for ln in text.splitlines() if ln.startswith("| 20")]
    assert len(rows) == 1 and "| fixture |" in rows[0]
    assert f"| {steps} |" in rows[0] and rows[0].endswith("| cpu |")
    assert text.count("## Real-data parity runs") == 1
    assert parity.run(argv + ["--max_epoch", "1"])["train_steps"] == steps // 2
    assert results.read_text().count("## Real-data parity runs") == 1
    assert results.read_text().count("\n| 20") == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_fixture_files_equal_the_jax_fixture(tmp_path, seed):
    """For parity's fixture arguments the port writes the JAX package's
    files byte for byte."""
    kw = dict(shapes_per_category=14, points_per_shape=900, seed=seed,
              variable_points=True, categories=["Chair"])
    synthetic.write_fixture(str(tmp_path / "port"), **kw)
    jsynthetic.write_fixture(str(tmp_path / "jax"), **kw)
    names = []
    for root, _, files in os.walk(tmp_path / "jax"):
        names += [os.path.relpath(os.path.join(root, f), tmp_path / "jax")
                  for f in files]
    assert len(names) == 2 * 14 + 4
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


def test_split_counts_equal_jax(tmp_path):
    root = str(tmp_path / "data")
    synthetic.write_fixture(root, 30, 64, categories=["Chair", "Lamp"])
    for category in ("Chair", "Lamp"):
        assert parity.check_splits(root, category) == \
            jparity.check_splits(root, category)


def test_scalar_readers_equal_jax(tmp_path):
    """Best-loss pcloss and the post-warmup slope, scoped to one run, as
    the JAX package's tests hold them (tests/test_cli.py)."""
    rows = [
        {"split": "test", "step": 1, "time": 5.0, "loss": 0.1,
         "pcloss": 0.001},
        {"split": "test", "step": 20, "time": 20.0, "loss": 5.0,
         "pcloss": 0.03},
        {"split": "test", "step": 30, "time": 30.0, "loss": 4.0,
         "pcloss": 0.04},
        {"split": "train", "step": 10, "time": 15.0, "loss": 9.0},
        {"split": "train", "step": 20, "time": 20.0, "loss": 8.0},
        {"split": "train", "step": 30, "time": 25.0, "loss": 7.0},
    ]
    log = tmp_path / "log"
    log.mkdir()
    with open(log / "scalars.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")
    for since in (0.0, 10.0, 24.0):
        assert parity._eval_pcloss_at_best_loss(str(log), since) == \
            jparity._eval_pcloss_at_best_loss(str(log), since)
        assert parity._post_warmup_throughput(str(log), 16, since) == \
            jparity._post_warmup_throughput(str(log), 16, since)
    assert parity._eval_pcloss_at_best_loss(str(log), 10.0) == 0.04
    assert parity._post_warmup_throughput(str(log), 16, 10.0) == 32.0
    assert parity._eval_pcloss_at_best_loss(str(tmp_path / "none")) is None


@pytest.mark.parametrize("old_table", [False, True])
def test_appended_row_equals_jax(tmp_path, old_table):
    """The same record gives the JAX package's row, into a new file and
    into a section whose table has other columns (a new table starts)."""
    record = {
        "date": "2026-10-17", "command": "parity --model model",
        "data": "stand-in fixture (NOT the real archive)",
        "best_eval_chamfer": 0.00345, "train_steps": 21105,
        "wall_seconds_incl_compile": 425.1,
        "post_warmup_shapes_per_sec": 1657.8,
        "backend": "cuda x1 NVIDIA H100 80GB HBM3, 700.00 W",
    }
    old = ("## Real-data parity runs\n\n| date | data | command | best eval "
           "Chamfer | throughput | wall | backend |\n"
           "|---|---|---|---|---|---|---|\n"
           "| 2026-01-01 | fixture | `old` | 0.1 | 2 | 80s | tpu |\n")
    texts = []
    for mod, name in ((parity, "port.md"), (jparity, "jax.md")):
        path = tmp_path / name
        if old_table:
            path.write_text(old)
        mod._append_results(str(path), record, is_real=False)
        texts.append(path.read_text())
    rows = [[ln for ln in t.splitlines() if ln.startswith("| 20")]
            for t in texts]
    assert rows[0] == rows[1] and len(rows[0]) == 1 + old_table
    assert "| 2026-10-17 | fixture | `parity --model model` | 0.0034 | 21105 " \
        "| 425s | 1658 | cuda x1 NVIDIA H100 80GB HBM3, 700.00 W |" in rows[0]
    assert texts[0].count("## Real-data parity runs") == 1
