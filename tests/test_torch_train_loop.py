"""The port's training loop and its support on the CPU: cli/train.py's
parser and main, the Trainer on a write_fixture dataset (num_point 64,
batch 4), checkpoints and --resume, InferenceSession on a saved
checkpoint, the config's refusals, and the data modules against the JAX
package's copies.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu import config as jconfig
from pointnet_autoencoder_tpu.cli import train as jcli
from pointnet_autoencoder_tpu.data import shapenet_part as jshapenet
from pointnet_autoencoder_tpu.data import synthetic as jsynthetic
from pointnet_autoencoder_tpu_torch.cli import train as cli
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data import shapenet_part, synthetic
from pointnet_autoencoder_tpu_torch.data.pipeline import BatchPipeline
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.train import checkpoint
from pointnet_autoencoder_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 4


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """30 Chair shapes: 25 trainval (6 batches of 4), 5 test (1 batch)."""
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 30, NUM_POINT, categories=["Chair"])


def _argv(fixture_root, log_dir, *extra):
    return ["--data_path", fixture_root, "--category", "Chair",
            "--num_point", str(NUM_POINT), "--batch_size", str(BATCH),
            "--log_dir", log_dir, "--log_every", "3", "--device", "cpu",
            *extra]


@pytest.fixture(scope="module")
def trained(fixture_root, tmp_path_factory):
    """A 2-epoch f32 run through cli.main; returns its log dir."""
    log_dir = str(tmp_path_factory.mktemp("run") / "log")
    assert cli.main(_argv(fixture_root, log_dir, "--max_epoch", "2",
                          "--no-bf16")) == 0
    return log_dir


def test_cli_run_logs_and_saves(trained):
    with open(os.path.join(trained, "log_train.txt")) as f:
        text = f.read()
    for line in ("**** EPOCH 000 ****", " -- 003 / 006 --", " -- 006 / 006 --",
                 "mean loss: ", "mean pc loss: ", "epoch throughput: ",
                 "---- EPOCH 001 EVALUATION ----", "eval mean loss: ",
                 "eval mean pc loss: ", "Model saved in file: ",
                 "done; best eval loss "):
        assert line in text, line
    for name in ("best_model_epoch_000.ckpt", "model.ckpt", "LATEST",
                 "config.json", "scalars.jsonl"):
        assert os.path.exists(os.path.join(trained, name)), name
    assert sorted(os.listdir(os.path.join(trained, "source_snapshot"))) == [
        "autoencoder.py", "loop.py", "registry.py"]
    with open(os.path.join(trained, "source_snapshot", "loop.py")) as f:
        assert "pointnet_autoencoder_tpu_torch" in f.read()
    with open(os.path.join(trained, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["split"] == "train"]
    assert [r["step"] for r in train] == [3, 6, 9, 12]
    assert {"loss", "pcloss", "learning_rate", "bn_decay"} <= set(train[0])
    assert train[0]["loss"] == pytest.approx(100 * train[0]["pcloss"])
    tree = checkpoint.load(os.path.join(trained, "model.ckpt"))
    assert tree["epoch"] == 1 and tree["step"] == 6
    assert set(tree) == {"model", "optimizer", "step", "epoch", "best_loss"}


def test_resume_restarts_at_the_stored_epoch_and_step(trained, fixture_root):
    latest = checkpoint.CheckpointManager(trained).latest()
    stored = checkpoint.load(latest)
    cfg = cli.config_from_args(cli.build_parser().parse_args(_argv(
        fixture_root, trained, "--max_epoch", "3", "--no-bf16",
        "--resume")))
    trainer = Trainer(cfg, device="cpu")
    try:
        assert trainer.start_epoch == stored["epoch"] == 2
        assert trainer.state.step == stored["step"] == 12
        assert trainer.best_loss == stored["best_loss"]
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(v, stored["model"][k]), k
        trainer.train()
        assert trainer.state.step == 18
    finally:
        trainer.close()


def test_session_loads_a_training_checkpoint(trained, fixture_root):
    path = checkpoint.CheckpointManager(trained).latest()
    session = InferenceSession("model", path, NUM_POINT, batch_size=BATCH,
                               device="cpu")
    model = session.model
    stored = checkpoint.load(path)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, stored[k]), k
    pts = np.random.RandomState(0).randn(3, NUM_POINT, 3).astype(np.float32)
    with torch.no_grad():
        want, _ = model(torch.from_numpy(pts), train=False)
    np.testing.assert_allclose(session.reconstruct(pts), want.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_chamfer_falls_over_a_few_dozen_steps(fixture_root, tmp_path):
    """36 bf16 steps (the default) on the fixture: the train pcloss of the
    last log window is well below the first's."""
    log_dir = str(tmp_path / "log")
    assert cli.main(_argv(fixture_root, log_dir, "--max_epoch", "6")) == 0
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        train = [json.loads(line) for line in f]
    train = [r for r in train if r["split"] == "train"]
    assert len(train) == 12 and all(np.isfinite(r["loss"]) for r in train)
    assert train[-1]["pcloss"] < 0.5 * train[0]["pcloss"]


def test_parser_has_the_reference_flags_and_device():
    ours = {a.dest for a in cli.build_parser()._actions} - {"help"}
    theirs = {a.dest for a in jcli.build_parser()._actions} - {"help"}
    assert ours == theirs | {"device"}
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda" and args.bf16
    cfg = cli.config_from_args(args)
    defaults = jconfig.TrainConfig()
    for field in jconfig.TrainConfig.__dataclass_fields__:
        if field in ("input_mode", "async_checkpoints"):
            continue
        assert getattr(cfg, field) == getattr(defaults, field), field
    assert cfg.input_mode == "host" and not cfg.async_checkpoints


@pytest.mark.parametrize("field,value", [
    ("input_mode", "device"), ("data_parallel", 2), ("model_parallel", 2),
    ("point_parallel", True), ("bf16_params", True), ("bf16_moments", True),
    ("async_checkpoints", True), ("profile_dir", "/nonexistent/prof"),
    ("compilation_cache_dir", "/nonexistent/cache")])
def test_config_refuses_what_is_not_ported(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(**{field: value}).validate()
    TrainConfig(data_parallel=1).validate()


def test_trainer_defaults_to_the_card(fixture_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default would run on it")
    cfg = TrainConfig(data_path=fixture_root, log_dir=str(tmp_path / "log"))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg)


def test_checkpoint_refuses_foreign_paths_and_falls_back(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest() is None
    foreign = tmp_path / "model.ckpt"
    foreign.mkdir()
    (foreign / "precious.txt").write_text("keep")
    with pytest.raises(ValueError, match="refusing"):
        mgr.save_periodic({"step": 1})
    assert (foreign / "precious.txt").read_text() == "keep"
    mgr.save_best(3, {"step": 3})
    mgr.save_best(7, {"step": 7})
    assert mgr.latest() == str(tmp_path / "best_model_epoch_007.ckpt")
    # A crash mid-swap: the pointed name is gone, its .old sibling holds it.
    os.rename(tmp_path / "best_model_epoch_007.ckpt",
              tmp_path / "best_model_epoch_007.ckpt.old")
    assert mgr.latest() == str(tmp_path / "best_model_epoch_007.ckpt.old")
    os.remove(tmp_path / "LATEST")
    assert mgr.latest() == str(tmp_path / "best_model_epoch_003.ckpt")
    with pytest.raises(ValueError, match="not a checkpoint"):
        checkpoint.load(str(foreign))


def test_fixture_and_dataset_match_the_jax_package(tmp_path):
    ours = synthetic.write_fixture(str(tmp_path / "a"), 6, 50, seed=3,
                                   variable_points=True)
    theirs = jsynthetic.write_fixture(str(tmp_path / "b"), 6, 50, seed=3,
                                      variable_points=True)
    cmp = filecmp.dircmp(ours, theirs)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    for sub in cmp.subdirs.values():
        for leaf in [sub, *sub.subdirs.values()]:
            assert not leaf.diff_files and not leaf.left_only
    for split, seed in (("trainval", 0), ("test", 1)):
        a = shapenet_part.PartDataset(ours, npoints=40, split=split,
                                      seed=seed)
        b = jshapenet.PartDataset(ours, npoints=40, split=split, seed=seed)
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            for x, y in zip(a[i], b[i]):
                np.testing.assert_array_equal(x, y)
    batch = np.random.RandomState(0).randn(3, 10, 3).astype(np.float32)
    np.testing.assert_array_equal(
        shapenet_part.rotate_point_cloud(batch, np.random.default_rng(4)),
        jshapenet.rotate_point_cloud(batch, np.random.default_rng(4)))


def test_dataset_disk_cache_serves_the_same_shapes(fixture_root, tmp_path):
    cached = shapenet_part.PartDataset(fixture_root, npoints=20, seed=0,
                                       cache_dir=str(tmp_path / "c"))
    plain = shapenet_part.PartDataset(fixture_root, npoints=20, seed=0)
    for i in range(3):
        np.testing.assert_array_equal(cached[i][0], plain[i][0])
    assert len(os.listdir(tmp_path / "c")) == 3
    again = shapenet_part.PartDataset(fixture_root, npoints=20, seed=0,
                                      cache_dir=str(tmp_path / "c"))
    np.testing.assert_array_equal(again[0][0], cached._load(0)[0][
        np.random.default_rng(0).integers(0, NUM_POINT, 20)])


class _Shapes:
    """A dataset of fixed clouds; index ``bad`` raises."""

    def __init__(self, n, bad=None):
        self.npoints = 5
        self.items = np.random.RandomState(0).randn(n, 5, 3).astype(
            np.float32)
        self.bad = bad

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError(f"unreadable shape {i}")
        return self.items[i], None


def test_pipeline_epochs_and_producer_errors():
    data = _Shapes(10)
    pipe = BatchPipeline(data, 4, rotate=False, shuffle=False)
    batches = list(pipe.epoch())
    assert len(pipe) == 2 and len(batches) == 2  # the remainder dropped
    np.testing.assert_array_equal(batches[1].numpy(), data.items[4:8])
    assert batches[0].dtype == torch.float32
    shuffled = BatchPipeline(data, 4, rotate=True, shuffle=True, seed=1)
    assert [b.shape for b in shuffled.epoch()] == [(4, 5, 3)] * 2
    broken = BatchPipeline(_Shapes(10, bad=5), 4, rotate=False,
                           shuffle=False)
    with pytest.raises(OSError, match="unreadable shape 5"):
        list(broken.epoch())
