"""Point-parallel training and bf16 master weights on ranks, on the CPU:
both input pipelines' point slices against the one-device batch, the
Trainer's degree-1 path bit-equal to the plain one, the refusal of
point parallelism with model parallelism, ``cli/train.py
--point_parallel --data_parallel 2 --device cpu`` for 2 epochs (the
ranks' weights bit-equal, rank 0's checkpoint serving on one device), and
``bf16_params`` on 2 ranks under data and under point parallelism (the
ranks' bf16 weights bit-equal after 3 steps: equal gradients after the
all-reduce, and the same rounding noise on every rank).

The Trainer runs at num_point 64 and a batch of 8 on a 60-shape Chair
fixture: 50 trainval shapes (6 batches per epoch) and 10 test shapes.
Ranks are spawned processes whose bodies are in tests/torch_dp_workers.py.
"""

import functools

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
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.parallel import mesh, sp
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


# -- the pipelines' point slices ----------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_host_pipeline_point_slices_concatenate_to_the_batch(fixture_root,
                                                             k):
    """Shuffled, rotated, two epochs: every rank draws the global batch
    as one device does and keeps its points of every shape."""
    def pipe(point_shard):
        ds = PartDataset(fixture_root, npoints=NUM_POINT,
                         class_choice=["Chair"], split="trainval", seed=3)
        return BatchPipeline(ds, BATCH, rotate=True, shuffle=True, seed=5,
                             point_shard=point_shard)

    one = pipe((0, 1))
    ranks = [pipe((r, k)) for r in range(k)]
    for _ in range(2):
        epochs = [list(p.epoch()) for p in ranks]
        want = list(one.epoch())
        assert len(want) == STEPS_PER_EPOCH
        for step, batch in enumerate(want):
            parts = [e[step] for e in epochs]
            assert all(p.shape == (BATCH, NUM_POINT // k, 3) for p in parts)
            assert torch.equal(torch.cat(parts, dim=1), batch)


@pytest.mark.parametrize("k", [2, 4])
def test_device_pipeline_point_slices_concatenate_to_the_batch(
        fixture_root, k):
    ds = PartDataset(fixture_root, npoints=NUM_POINT, class_choice=["Chair"],
                     split="trainval", seed=3)
    data = DeviceDataset(ds, device="cpu")

    def batches(points):
        it = DeviceBatchIterator(data.num_shapes, BATCH, shuffle=True,
                                 seed=7)
        return [assemble_batch(data.data, data.lengths, idxs, it.generator,
                               NUM_POINT, True, points=points)
                for _ in range(2) for idxs in it.epoch()]

    want = batches(slice(None))
    got = [batches(sp.point_slice(NUM_POINT, r, k)) for r in range(k)]
    for step, batch in enumerate(want):
        assert torch.equal(torch.cat([g[step] for g in got], dim=1), batch)


# -- the Trainer -------------------------------------------------------------


def test_degree_one_runs_the_plain_step_bit_for_bit(fixture_root, tmp_path):
    """point_parallel without a group (degree 1) trains exactly as the
    plain Trainer (the JAX package's tests/test_parallel.py:700)."""
    states = []
    for flag in (True, False):
        tr = Trainer(_config(fixture_root, tmp_path / f"log{flag}",
                             point_parallel=flag, data_parallel=1),
                     device="cpu")
        assert tr.sp_active is False
        best = tr.train()
        states.append((best, tr.model.state_dict()))
        tr.close()
    assert states[0][0] == states[1][0]
    for k, v in states[0][1].items():
        assert torch.equal(v, states[1][1][k]), k


def test_point_parallel_with_model_parallel_raises():
    with pytest.raises(ValueError, match="does not compose"):
        TrainConfig(point_parallel=True, model_parallel=2).validate()
    TrainConfig(point_parallel=True, data_parallel=2).validate()


def test_cli_point_parallel_trains_two_cpu_ranks(fixture_root, tmp_path):
    """cli.train --point_parallel --data_parallel 2 --device cpu: 2 epochs
    on 2 spawned ranks, each with 32 of every shape's 64 points; the
    ranks' weights bit-equal, one log, rank 0's checkpoint served by a
    one-device session."""
    log_dir = str(tmp_path / "log")
    out = tmp_path / "ranks"
    out.mkdir()
    assert cli.main(["--data_path", fixture_root, "--category", "Chair",
                     "--num_point", str(NUM_POINT), "--batch_size",
                     str(BATCH), "--log_dir", log_dir, "--log_every", "3",
                     "--max_epoch", "2", "--no-bf16", "--device", "cpu",
                     "--point_parallel", "--data_parallel", "2"],
                    after=functools.partial(workers.save_state,
                                            str(out))) == 0
    ranks = workers.load_ranks(str(out), 2)
    assert all(r["sp"] for r in ranks)
    assert ranks[0]["step"] == ranks[1]["step"] == 2 * STEPS_PER_EPOCH
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    with open(f"{log_dir}/log_train.txt") as f:
        lines = f.read().splitlines()
    assert lines.count("**** EPOCH 001 ****") == 1
    evals = [float(line.split()[-1]) for line in lines
             if line.startswith("eval mean pc loss: ")]
    assert len(evals) == 2 and np.isfinite(evals).all()
    latest = checkpoint.CheckpointManager(log_dir).latest()
    stored = checkpoint.load(latest)["model"]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(stored[k], v), k
    sess = InferenceSession("model", latest, NUM_POINT, batch_size=4,
                            device="cpu")
    pts = np.random.RandomState(2).randn(5, NUM_POINT, 3).astype(np.float32)
    rec = sess.reconstruct(pts)
    assert rec.shape == pts.shape and np.isfinite(rec).all()


def test_bf16_params_ranks_stay_bit_equal_under_dp_and_sp(fixture_root,
                                                          tmp_path):
    """bf16 master weights with bf16 moments on 2 ranks: after 3 steps
    the ranks' bf16 weights and slots are bit-equal, under data and under
    point parallelism, and the ranks saw their own shares of the batch."""
    configs = [_config(fixture_root, tmp_path / name, bf16_params=True,
                       bf16_moments=True, data_parallel=2, **extra).to_json()
               for name, extra in (("dp", {}),
                                   ("sp", dict(point_parallel=True)))]
    out = tmp_path / "ranks"
    out.mkdir()
    mesh.launch(workers.bf16_ranks_rank, devices=["cpu", "cpu"],
                backend="gloo", init_method=f"file://{tmp_path / 'store'}",
                args=(configs, str(out), 3))
    ranks = workers.load_ranks(str(out), 2)
    for i, (sp_active, shape) in enumerate(
            ((False, (BATCH // 2, NUM_POINT, 3)),
             (True, (BATCH, NUM_POINT // 2, 3)))):
        a, b = ranks[0][i], ranks[1][i]
        assert a["sp"] is b["sp"] is sp_active
        assert a["batch_shape"] == shape
        assert a["state"]["step"] == 3
        w = a["state"]["model"]["decoder.fc3.dense.weight"]
        assert w.dtype == torch.bfloat16
        for k, v in a["state"]["model"].items():
            assert torch.equal(v, b["state"]["model"][k]), (i, k)
        for n, slots in a["state"]["optimizer"]["slots"].items():
            for s, v in slots.items():
                assert torch.equal(
                    v, b["state"]["optimizer"]["slots"][n][s]), (i, n, s)
