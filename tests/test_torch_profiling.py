"""StepTimer and trace (utils/profiling.py), the twin of the JAX package's
tests/test_profiling.py, and the Trainer's --profile_dir trace on the CPU;
also the synthetic fixture's real-archive scale (data/synthetic.py), the
calibration input of full-dataset timings, against the JAX package's.
"""

import filecmp
import json
import os
import signal

import pytest
import torch

from pointnet_autoencoder_tpu.data import synthetic as jsynthetic
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.train.loop import Trainer
from pointnet_autoencoder_tpu_torch.utils.profiling import StepTimer, trace

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 4


def test_step_timer_records_and_summarizes():
    t = StepTimer()
    for _ in range(5):
        with t.step() as box:
            box["result"] = {"loss": torch.ones((4,)) * 2}
    s = t.summary()
    assert s["steps"] == 5
    assert s["mean_ms"] > 0
    assert s["p50_ms"] <= s["p90_ms"] <= s["p99_ms"]
    t.reset()
    assert t.summary() == {}


def test_trace_noop_without_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None):
        pass
    with trace(""):
        pass
    assert os.listdir(tmp_path) == []


def test_trace_writes(tmp_path):
    with trace(str(tmp_path / "tr"), device="cpu"):
        torch.ones((8, 8)).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].startswith("trace_rank0_")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with trace(str(tmp_path / "tr"), device="cpu"):
            torch.ones((4,)).sum()
            raise ValueError("inside")
    assert len(os.listdir(tmp_path / "tr")) == 1


def test_step_timer_stop_without_start_raises():
    """Misuse (stop with no start, or double stop) must raise, not record
    a ~0 sample that silently drags the percentile summary toward zero."""
    t = StepTimer()
    with pytest.raises(RuntimeError, match="without a matching start"):
        t.stop()
    t.start()
    t.stop()
    with pytest.raises(RuntimeError, match="without a matching start"):
        t.stop()
    assert t.summary()["steps"] == 1


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """30 Chair shapes: 25 trainval (6 batches of 4), 5 test (1 batch)."""
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 30, NUM_POINT, categories=["Chair"])


def _config(fixture_root, tmp_path, **kw):
    return TrainConfig(data_path=fixture_root, category="Chair",
                       num_point=NUM_POINT, batch_size=BATCH,
                       log_dir=str(tmp_path / "log"),
                       profile_dir=str(tmp_path / "prof"), bf16=False,
                       **kw)


def _log(tmp_path) -> str:
    with open(tmp_path / "log" / "log_train.txt") as f:
        return f.read()


def test_trainer_traces_only_its_first_epoch(fixture_root, tmp_path):
    trainer = Trainer(_config(fixture_root, tmp_path, max_epoch=2),
                      device="cpu")
    try:
        trainer.train()
    finally:
        trainer.close()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names  # the train steps and the eval are inside
    log = _log(tmp_path)
    assert log.count("profiler trace written to") == 1
    first = log.index("profiler trace written to")
    assert log.index("---- EPOCH 000 EVALUATION ----") < first \
        < log.index("**** EPOCH 001 ****")


def test_trainer_writes_the_trace_on_preemption(fixture_root, tmp_path):
    """SIGTERM after the first step: the epoch stops at the next step
    boundary and its trace is written before the preemption save."""
    trainer = Trainer(_config(fixture_root, tmp_path, max_epoch=3),
                      device="cpu")
    real_step = trainer.train_step

    def step_and_signal(batch):
        out = real_step(batch)
        signal.raise_signal(signal.SIGTERM)
        return out

    trainer.train_step = step_and_signal
    try:
        trainer.train()
    finally:
        trainer.close()
    assert trainer.state.step == 1
    assert len(os.listdir(tmp_path / "prof")) == 1
    log = _log(tmp_path)
    assert log.index("profiler trace written to") \
        < log.index("preemption checkpoint saved")
    assert "EVALUATION" not in log


def test_write_fixture_category_counts_match_the_jax_package(tmp_path):
    counts = {"Mug": 3, "Rocket": 5, "Chair": 2}
    ours = synthetic.write_fixture(str(tmp_path / "a"), points_per_shape=40,
                                   seed=5, variable_points=True,
                                   category_counts=counts)
    theirs = jsynthetic.write_fixture(str(tmp_path / "b"),
                                      points_per_shape=40, seed=5,
                                      variable_points=True,
                                      category_counts=counts)
    _assert_same_tree(ours, theirs)
    with open(os.path.join(ours, "synsetoffset2category.txt")) as f:
        assert [line.split()[0] for line in f] == list(counts)


def _assert_same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    for sub in cmp.subdirs:
        _assert_same_tree(os.path.join(a, sub), os.path.join(b, sub))
    # dircmp compares by stat; hold the bytes of every file too.
    for name in cmp.common_files:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def test_real_scale_fixture_takes_the_published_counts(tmp_path,
                                                       monkeypatch):
    assert synthetic.REAL_V0_COUNTS == jsynthetic.REAL_V0_COUNTS
    assert len(synthetic.REAL_V0_COUNTS) == 16
    assert sum(synthetic.REAL_V0_COUNTS.values()) == 16881
    small = {c: 1 + i % 3 for i, c in enumerate(synthetic.REAL_V0_COUNTS)}
    monkeypatch.setattr(synthetic, "REAL_V0_COUNTS", small)
    monkeypatch.setattr(jsynthetic, "REAL_V0_COUNTS", small)
    ours = synthetic.write_real_scale_fixture(str(tmp_path / "a"),
                                              points_per_shape=30, seed=2)
    theirs = jsynthetic.write_real_scale_fixture(str(tmp_path / "b"),
                                                 points_per_shape=30, seed=2)
    _assert_same_tree(ours, theirs)
    sizes = set()
    for cat, synset in synthetic._SYNSETS.items():
        pts = os.listdir(os.path.join(ours, synset, "points"))
        assert len(pts) == small[cat], cat
        for name in pts:
            with open(os.path.join(ours, synset, "points", name)) as f:
                sizes.add(len(f.readlines()))
    assert min(sizes) >= 15 and max(sizes) <= 30 and len(sizes) > 1
