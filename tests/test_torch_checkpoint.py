"""The port's background saver (train/checkpoint.py:AsyncSaver), its
snapshots, and the Trainer's preemption handler, on the CPU: the
counterparts of the JAX package's AsyncSaver and of
tests/test_train.py's preemption test.

Held: saves land in submit order with LATEST the newest; a worker's error
surfaces on the training thread; a snapshot is unchanged by the in-place
optimizer steps after it; sync and async runs of one seed write the same
checkpoints bit for bit; SIGTERM during training leaves a resumable
checkpoint and the previous handler.
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.train import checkpoint, schedules
from pointnet_autoencoder_tpu_torch.train.loop import Trainer
from pointnet_autoencoder_tpu_torch.train.state import (TrainState,
                                                        make_optimizer)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """30 Chair shapes at 64 points: 6 train batches of 4, 1 test batch."""
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 30, 64, categories=["Chair"])


def _config(fixture_root, log_dir, **kw):
    return TrainConfig(**{**dict(
        model="model", category="Chair", log_dir=str(log_dir), num_point=64,
        batch_size=4, data_path=fixture_root, seed=7, log_every=1,
        bf16=False), **kw})


def _equal_trees(a, b, path="") -> None:
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict)
                                  ), path
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def _state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 3))
    st = TrainState(model, make_optimizer("adam", model.parameters()),
                    schedules.learning_rate_schedule(1e-2, 1.0, 1, 1))
    return st


def _step(st, seed):
    x = torch.from_numpy(np.random.RandomState(seed).randn(6, 5).astype(
        np.float32))
    st.set_lr()
    st.optimizer.zero_grad()
    st.model(x).square().sum().backward()
    st.optimizer.step()
    st.step += 1


def test_saves_land_in_submit_order_and_latest_is_newest(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    logged = []
    saver = checkpoint.AsyncSaver(mgr, log=logged.append)
    for i, (kind, epoch) in enumerate([("best", 0), ("periodic", 0),
                                       ("best", 3), ("best", 5)]):
        saver.submit(kind, epoch, {"step": torch.tensor(i)})
    saver.flush()
    assert [line.rsplit("/", 1)[-1] for line in logged] == [
        "best_model_epoch_000.ckpt", "model.ckpt",
        "best_model_epoch_003.ckpt", "best_model_epoch_005.ckpt"]
    assert all(line.startswith("Model saved in file: ") for line in logged)
    with open(tmp_path / "LATEST") as f:
        assert f.read() == "best_model_epoch_005.ckpt"
    assert mgr.latest() == str(tmp_path / "best_model_epoch_005.ckpt")
    assert int(checkpoint.load(mgr.latest())["step"]) == 3
    saver.close()


@pytest.mark.parametrize("where", ["flush", "submit", "close"])
def test_a_worker_error_surfaces_on_the_training_thread(tmp_path, where):
    (tmp_path / "model.ckpt").mkdir()  # foreign: a save must refuse it
    saver = checkpoint.AsyncSaver(checkpoint.CheckpointManager(str(tmp_path)))
    saver.submit("periodic", 0, {"step": 1})
    if where == "submit":
        saver._q.join()
        call = lambda: saver.submit("best", 1, {"step": 2})  # noqa: E731
    else:
        call = getattr(saver, where)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"
                       ) as info:
        call()
    assert isinstance(info.value.__cause__, ValueError)
    assert "refusing" in str(info.value.__cause__)
    if where != "close":
        saver.close()


def test_a_snapshot_is_unchanged_by_later_in_place_steps(tmp_path):
    st = _state()
    _step(st, 0)
    snap = checkpoint.snapshot(st.state_dict())
    want = checkpoint.to_host(checkpoint.snapshot(st.state_dict()))
    saver = checkpoint.AsyncSaver(checkpoint.CheckpointManager(str(tmp_path)))
    saver.submit("periodic", 0, snap)
    for s in range(1, 6):  # Adam moves its moments and step in place
        _step(st, s)
    saver.flush()
    saver.close()
    got = checkpoint.load(str(tmp_path / "model.ckpt"))
    _equal_trees(got, want)
    assert not torch.equal(got["model"]["0.weight"],
                           st.model.state_dict()["0.weight"])
    moments = st.optimizer.state_dict()["state"][0]["exp_avg"]
    assert not torch.equal(got["optimizer"]["state"][0]["exp_avg"], moments)
    # A reference to the live state is not a snapshot.
    live = st.optimizer.state_dict()["state"][0]["exp_avg"]
    _step(st, 9)
    assert torch.equal(live, st.optimizer.state_dict()["state"][0][
        "exp_avg"])


@pytest.mark.parametrize("mode", ["device", "host"])
def test_sync_and_async_runs_write_the_same_checkpoints(fixture_root,
                                                        tmp_path, mode):
    """Two epochs of one seed, saves synchronous and in the background:
    every checkpoint (best of each epoch, the periodic one) holds the same
    model, optimizer state, step, epoch and best loss."""
    dirs = {}
    for sync in (True, False):
        dirs[sync] = tmp_path / f"sync_{sync}"
        tr = Trainer(_config(fixture_root, dirs[sync], max_epoch=2,
                             input_mode=mode, async_checkpoints=not sync),
                     device="cpu")
        try:
            assert (tr._saver is None) == sync
            tr.train()
        finally:
            tr.close()
    names = sorted(n for n in os.listdir(dirs[True]) if n.endswith(".ckpt"))
    assert names == sorted(n for n in os.listdir(dirs[False])
                           if n.endswith(".ckpt"))
    assert "model.ckpt" in names and len(names) >= 2
    for name in names:
        _equal_trees(checkpoint.load(str(dirs[True] / name)),
                     checkpoint.load(str(dirs[False] / name)), name)
    latest = [(d / "LATEST").read_text() for d in dirs.values()]
    assert latest[0] == latest[1] and latest[0] in names


@pytest.mark.parametrize("mode", ["device", "host"])
def test_preemption_checkpoints_and_resumes(fixture_root, tmp_path, mode):
    """SIGTERM mid-run: train() returns at the next step boundary with a
    resumable checkpoint; --resume restarts the interrupted epoch with the
    preempted step count; the previous handler is back; a stale flag does
    not survive into a new train() call."""
    cfg = _config(fixture_root, tmp_path / "log", max_epoch=1000,
                  input_mode=mode)
    trainer = Trainer(cfg, device="cpu")
    prev = signal.getsignal(signal.SIGTERM)
    started = threading.Event()
    real_step = trainer.train_step

    def step_and_signal(batch):
        out = real_step(batch)
        started.set()
        return out

    trainer.train_step = step_and_signal

    def send_sigterm_once_training_started():
        started.wait(60)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=send_sigterm_once_training_started)
    t.start()
    try:
        trainer.train()  # returns instead of dying
    finally:
        t.join(timeout=70)
        trainer.close()
    assert trainer.state.step >= 1
    with open(tmp_path / "log" / "log_train.txt") as f:
        log = f.read()
    assert "preemption checkpoint saved" in log
    assert f"received signal {int(signal.SIGTERM)}" in log
    assert signal.getsignal(signal.SIGTERM) == prev
    stored = checkpoint.load(trainer.ckpt.latest())
    assert stored["step"] == trainer.state.step
    resumed = Trainer(TrainConfig(**{**cfg.__dict__, "resume": True}),
                      device="cpu")
    try:
        assert resumed.start_epoch == stored["epoch"] < 1000
        assert resumed.state.step == trainer.state.step
        resumed.config.max_epoch = resumed.start_epoch + 1
        resumed._preempted = True  # a stale flag is reset on entry
        before = resumed.state.step
        resumed.train()
        assert resumed.state.step > before
    finally:
        resumed.close()


def test_a_signal_during_eval_saves_at_the_next_epoch(fixture_root,
                                                      tmp_path):
    tr = Trainer(_config(fixture_root, tmp_path / "log", max_epoch=5),
                 device="cpu")
    real_eval = tr.eval_one_epoch

    def eval_then_signal(epoch):
        loss = real_eval(epoch)
        signal.raise_signal(signal.SIGTERM)
        return loss

    tr.eval_one_epoch = eval_then_signal
    try:
        tr.train()
        tree = checkpoint.load(tr.ckpt.latest())
        assert tree["epoch"] == 1 and tree["step"] == len(tr.train_pipe)
        assert tr.ckpt.latest().endswith("model.ckpt")
    finally:
        tr.close()


def test_a_second_signal_restores_the_handlers_and_interrupts(fixture_root,
                                                              tmp_path):
    tr = Trainer(_config(fixture_root, tmp_path / "log"), device="cpu")
    prev = signal.getsignal(signal.SIGINT)
    restore = tr._install_signal_handlers()
    try:
        assert signal.getsignal(signal.SIGINT) != prev
        signal.raise_signal(signal.SIGINT)
        assert tr._preempted and tr._preempt_signum == signal.SIGINT
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)
        assert signal.getsignal(signal.SIGINT) == prev
    finally:
        restore()
        tr.close()


def test_signal_handlers_are_a_no_op_outside_the_main_thread(fixture_root,
                                                             tmp_path):
    tr = Trainer(_config(fixture_root, tmp_path / "log"), device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    out = []
    t = threading.Thread(target=lambda: out.append(
        tr._install_signal_handlers()))
    t.start()
    t.join()
    try:
        assert signal.getsignal(signal.SIGTERM) == before
        out[0]()  # the no-op restore
        assert signal.getsignal(signal.SIGTERM) == before
    finally:
        tr.close()


def test_close_finishes_pending_saves_and_is_idempotent(fixture_root,
                                                        tmp_path):
    tr = Trainer(_config(fixture_root, tmp_path / "log", max_epoch=1),
                 device="cpu")
    tr._save("best", 0)
    tr._save("periodic", 0)
    # A best and a periodic save of one step share one snapshot.
    snap = tr._snap_cache
    assert snap is not None and snap[0] == tr.state.step
    tr.close()
    tr.close()
    a = checkpoint.load(str(tmp_path / "log" / "best_model_epoch_000.ckpt"))
    b = checkpoint.load(str(tmp_path / "log" / "model.ckpt"))
    _equal_trees(a, b)
    assert a["epoch"] == 1
