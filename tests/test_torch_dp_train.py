"""Data-parallel training of the port on the CPU over gloo: both input
pipelines' rank slices against the one-device batch, a 2-rank Trainer
(weights bit-equal across ranks, one log and one set of checkpoints from
rank 0, resume at 2 ranks and at 1), a SIGTERM that reaches one rank only,
and cli/train.py --data_parallel 2 --device cpu through mesh.launch.

The Trainer runs f32 at num_point 64 and a global batch of 8 (4 rows per
rank) on a 60-shape Chair fixture: 50 trainval shapes (6 batches per
epoch) and 10 test shapes (1 eval batch). Ranks are spawned processes
whose bodies are in tests/torch_dp_workers.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from pointnet_autoencoder_tpu_torch.cli import train as cli
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.data.device_pipeline import (
    DeviceBatchIterator,
    DeviceDataset,
    assemble_batch,
)
from pointnet_autoencoder_tpu_torch.data.pipeline import BatchPipeline
from pointnet_autoencoder_tpu_torch.data.shapenet_part import PartDataset
from pointnet_autoencoder_tpu_torch.parallel import mesh
from pointnet_autoencoder_tpu_torch.train import checkpoint
from pointnet_autoencoder_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 8
STEPS_PER_EPOCH = 6


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 60, NUM_POINT, categories=["Chair"])


def _config(fixture_root, log_dir, **overrides):
    fields = dict(data_path=fixture_root, category="Chair",
                  num_point=NUM_POINT, batch_size=BATCH, bf16=False,
                  log_dir=str(log_dir), log_every=2, max_epoch=1)
    return TrainConfig(**dict(fields, **overrides))


def _launch(fn, tmp_path, *args):
    out = tmp_path / "ranks"
    out.mkdir()
    mesh.launch(fn, devices=["cpu", "cpu"], backend="gloo",
                init_method=f"file://{tmp_path / 'store'}",
                args=(*args[:1], str(out), *args[1:]))
    return workers.load_ranks(str(out), 2)


# -- the pipelines' rank slices ----------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_host_pipeline_slices_concatenate_to_the_global_batch(fixture_root,
                                                              k):
    """Shuffled, rotated, two epochs: every rank draws the global batch
    as one device does and keeps its rows."""
    def pipe(shard):
        ds = PartDataset(fixture_root, npoints=NUM_POINT,
                         class_choice=["Chair"], split="trainval", seed=3)
        return BatchPipeline(ds, BATCH, rotate=True, shuffle=True, seed=5,
                             shard=shard)

    one = pipe((0, 1))
    ranks = [pipe((r, k)) for r in range(k)]
    for _ in range(2):
        epochs = [list(p.epoch()) for p in ranks]
        want = list(one.epoch())
        assert len(want) == STEPS_PER_EPOCH
        for step, batch in enumerate(want):
            parts = [e[step] for e in epochs]
            assert all(p.shape == (BATCH // k, NUM_POINT, 3) for p in parts)
            assert torch.equal(torch.cat(parts), batch)


@pytest.mark.parametrize("k", [2, 4])
def test_device_pipeline_slices_concatenate_to_the_global_batch(
        fixture_root, k):
    """Device input: every rank draws the global indices, u and angles
    from the same generator and assembles its rows only."""
    ds = PartDataset(fixture_root, npoints=NUM_POINT, class_choice=["Chair"],
                     split="trainval", seed=3)
    data = DeviceDataset(ds, device="cpu")
    per = BATCH // k

    def batches(rows):
        it = DeviceBatchIterator(data.num_shapes, BATCH, shuffle=True,
                                 seed=7)
        return [assemble_batch(data.data, data.lengths, idxs, it.generator,
                               NUM_POINT, True, rows=rows)
                for _ in range(2) for idxs in it.epoch()]

    want = batches(slice(None))
    got = [batches(slice(r * per, (r + 1) * per)) for r in range(k)]
    assert len(want) == 2 * STEPS_PER_EPOCH
    for step, batch in enumerate(want):
        assert torch.equal(torch.cat([g[step] for g in got]), batch)


# -- the Trainer on 2 ranks --------------------------------------------------


def _log_lines(log_dir):
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        return f.read().splitlines()


def test_two_rank_trainer_writes_once_and_resumes_at_two_and_one(
        fixture_root, tmp_path):
    """Rank 0 alone logs and saves; the weights stay bit-equal across the
    ranks; the checkpoint is the one-device format, resumed by 2 ranks
    and by one device."""
    log_dir = tmp_path / "log"
    snapshot = tmp_path / "after_epoch_0"
    cfg = _config(fixture_root, log_dir)
    ranks = _launch(workers.trainer_rank, tmp_path, cfg.to_json(),
                    str(snapshot), 2)
    for stage in ("first", "resumed"):
        a, b = (r[stage] for r in ranks)
        assert a["step"] == b["step"]
        for name, t in a["state"].items():
            assert torch.equal(t, b["state"][name]), (stage, name)
    assert ranks[0]["first"]["step"] == STEPS_PER_EPOCH
    assert ranks[0]["resumed_at"]["start_epoch"] == 1
    assert ranks[0]["resumed_at"]["step"] == STEPS_PER_EPOCH
    assert ranks[0]["resumed"]["step"] == 2 * STEPS_PER_EPOCH

    # One log, written once: each epoch's header and eval line appear once.
    lines = _log_lines(log_dir)
    for line in ("**** EPOCH 000 ****", "**** EPOCH 001 ****",
                 "---- EPOCH 000 EVALUATION ----"):
        assert lines.count(line) == 1, line
    assert sum(line.startswith("resumed from") for line in lines) == 1
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        records = [json.loads(line) for line in f]
    keys = [(r["split"], r["step"]) for r in records]
    assert len(keys) == len(set(keys))
    assert ("train", 2) in keys and ("test", STEPS_PER_EPOCH) in keys

    # The epoch-0 checkpoint holds the ranks' weights at step 6 and
    # restores into one device.
    snap_log = os.path.join(snapshot, "log_train.txt")
    assert os.path.exists(snap_log)
    latest = checkpoint.CheckpointManager(str(snapshot)).latest()
    stored = checkpoint.load(latest)
    assert stored["step"] == STEPS_PER_EPOCH and stored["epoch"] == 1
    for name, t in ranks[0]["first"]["state"].items():
        assert torch.equal(stored["model"][name], t), name
    one = Trainer(_config(fixture_root, snapshot, resume=True, max_epoch=2),
                  device="cpu")
    try:
        assert one.start_epoch == 1 and one.state.step == STEPS_PER_EPOCH
        for name, t in one.model.state_dict().items():
            assert torch.equal(t, ranks[0]["first"]["state"][name]), name
    finally:
        one.close()


@pytest.mark.parametrize("input_mode", ["host", "device"])
def test_sigterm_to_one_rank_stops_both_at_the_same_step(
        fixture_root, tmp_path, input_mode):
    """Rank 1 alone is signalled after its step 3. Host input agrees at
    the next log line (step 4, mid-epoch: the epoch restarts on resume);
    device input at the epoch's end (step 6: the epoch is done). Rank 0
    writes the one preemption checkpoint, and a resume at 2 ranks
    continues from that step to max_epoch."""
    cfg = _config(fixture_root, tmp_path / "log", input_mode=input_mode,
                  max_epoch=2)
    ranks = _launch(workers.preempt_rank, tmp_path, [cfg.to_json()], 3)
    (a,), (b,) = ranks
    stop, stored_epoch = {"host": (4, 0), "device": (6, 1)}[input_mode]
    assert a["stopped"]["step"] == b["stopped"]["step"] == stop
    for name, t in a["stopped"]["state"].items():
        assert torch.equal(t, b["stopped"]["state"][name]), name
    lines = _log_lines(tmp_path / "log")
    assert sum("preemption checkpoint saved" in line for line in lines) == 1
    assert sum(line.startswith("received signal 15") for line in lines) == 0
    assert sum("a signal on another rank" in line for line in lines) == 1
    for r in (a, b):
        assert r["resumed_at"]["step"] == stop
        assert r["resumed_at"]["start_epoch"] == stored_epoch
        assert r["resumed"]["step"] == (
            stop + (2 - stored_epoch) * STEPS_PER_EPOCH)


# -- cli/train.py -------------------------------------------------------------


def test_cli_data_parallel_rank_devices(fixture_root):
    parse = cli.build_parser().parse_args
    cpu = torch.device("cpu")
    assert cli.rank_devices(parse(["--device", "cpu"])) is None
    assert cli.rank_devices(parse(["--device", "cpu", "--data_parallel",
                                   "1"])) is None
    assert cli.rank_devices(parse(["--device", "cpu", "--data_parallel",
                                   "3"])) == [cpu] * 3
    assert cli.rank_devices(parse(["--device", "cpu"]),
                            devices=["cpu", "cpu"]) == [cpu] * 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 CUDA device"):
            cli.rank_devices(parse(["--data_parallel", "2"]))
        # One card or none: the default trains in this process (and the
        # Trainer raises without a card).
        assert cli.rank_devices(parse([])) is None
    dp_help, = [a.help for a in cli.build_parser()._actions
                if a.dest == "data_parallel"]
    assert "Not ported" not in dp_help and "every visible card" in dp_help


def test_cli_trains_two_cpu_ranks_through_launch(fixture_root, tmp_path):
    log_dir = str(tmp_path / "log")
    assert cli.main(["--data_path", fixture_root, "--category", "Chair",
                     "--num_point", str(NUM_POINT), "--batch_size",
                     str(BATCH), "--log_dir", log_dir, "--log_every", "3",
                     "--max_epoch", "1", "--no-bf16", "--device", "cpu",
                     "--data_parallel", "2"]) == 0
    lines = _log_lines(log_dir)
    assert lines.count("**** EPOCH 000 ****") == 1
    assert sum(line.startswith("done; best eval loss") for line in lines) == 1
    assert sum(line.startswith("pid: ") for line in lines) == 1
    stored = checkpoint.load(checkpoint.CheckpointManager(log_dir).latest())
    assert stored["step"] == STEPS_PER_EPOCH
    assert np.isfinite(stored["best_loss"])
