"""The port's Logger (train/logging.py), the twin of the JAX package's
tests/test_logging.py: file outputs, flush without close, idempotent
close; its TensorBoard event files, the filename and echo arguments,
NullLogger.flush, and Trainer.flush flushing the logger.
"""

import json
import os

import pytest
import torch

from pointnet_autoencoder_tpu_torch.train.logging import Logger, NullLogger

torch.set_num_threads(2)


def test_logger_writes_text_and_scalars(tmp_path):
    log = Logger(str(tmp_path), echo=False)
    log.log("hello world")
    log.scalars("train", 7, {"loss": 1.5, "pcloss": 0.25})
    # Text and scalars flush on every write (no close needed to read).
    with open(tmp_path / "log_train.txt") as f:
        assert "hello world" in f.read()
    with open(tmp_path / "scalars.jsonl") as f:
        rec = json.loads(f.read().strip())
    assert rec["split"] == "train" and rec["step"] == 7
    assert rec["loss"] == 1.5 and rec["pcloss"] == 0.25
    assert "time" in rec
    log.close()


def test_logger_flush_keeps_logger_usable(tmp_path):
    """flush() makes buffered sinks durable WITHOUT closing: logging must
    keep working afterwards (train() flushes on every exit; a closed
    logger there would break in-process re-training)."""
    log = Logger(str(tmp_path), echo=False)
    log.log("before flush")
    log.flush()
    log.log("after flush")
    log.scalars("test", 1, {"loss": 0.5})
    with open(tmp_path / "log_train.txt") as f:
        text = f.read()
    assert "before flush" in text and "after flush" in text
    log.close()


def test_logger_close_is_idempotent(tmp_path):
    log = Logger(str(tmp_path), echo=False)
    log.log("x")
    log.close()
    log.close()  # second close must be a no-op, not ValueError


def test_logger_filename_and_echo(tmp_path, capsys):
    log = Logger(str(tmp_path), filename="log_test.txt", echo=False)
    log.log("quiet")
    log.close()
    assert capsys.readouterr().out == ""
    assert (tmp_path / "log_test.txt").read_text() == "quiet\n"
    assert not (tmp_path / "log_train.txt").exists()
    log = Logger(str(tmp_path / "loud"))
    log.log("loud")
    log.close()
    assert capsys.readouterr().out == "loud\n"


def _events(path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(path))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_logger_writes_tensorboard_events_per_split(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    log = Logger(str(tmp_path), echo=False)
    log.scalars("train", 3, {"loss": 2.0, "pcloss": 0.5})
    log.scalars("train", 6, {"loss": 1.0, "pcloss": 0.25})
    log.scalars("test", 6, {"loss": 1.5})
    log.flush()  # the events are on disk before close
    assert _events(tmp_path / "train") == {
        "loss": [(3, 2.0), (6, 1.0)], "pcloss": [(3, 0.5), (6, 0.25)]}
    assert _events(tmp_path / "test") == {"loss": [(6, 1.5)]}
    log.close()


def test_logger_runs_on_without_tensorboard(tmp_path, monkeypatch):
    """Where torch.utils.tensorboard does not import there are no writers
    and logging goes on, as in the JAX package."""
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    log = Logger(str(tmp_path), echo=False)
    log.scalars("train", 1, {"loss": 1.0})
    log.flush()
    log.close()
    assert sorted(os.listdir(tmp_path)) == ["log_train.txt", "scalars.jsonl"]


def test_null_logger_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    log = NullLogger()
    log.log("x")
    log.scalars("train", 1, {"loss": 1.0})
    log.flush()
    log.close()
    assert os.listdir(tmp_path) == []


def test_trainer_flush_flushes_the_logger(tmp_path):
    from pointnet_autoencoder_tpu_torch.config import TrainConfig
    from pointnet_autoencoder_tpu_torch.data import synthetic
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    root = synthetic.write_fixture(str(tmp_path / "data"), 24, 32,
                                   categories=["Chair"])
    cfg = TrainConfig(data_path=root, category="Chair", num_point=32,
                      batch_size=4, log_dir=str(tmp_path / "log"),
                      max_epoch=1, bf16=False, log_every=1)
    log = Logger(cfg.log_dir, echo=False)
    flushes = []
    real_flush = log.flush
    log.flush = lambda: (flushes.append(1), real_flush())
    trainer = Trainer(cfg, logger=log, device="cpu")
    try:
        trainer.train()  # flushes on exit
        assert len(flushes) == 1
        trainer.flush()
        assert len(flushes) == 2
        if log._tb:
            assert _events(tmp_path / "log" / "train")["loss"]
    finally:
        trainer.close()
        log.close()
