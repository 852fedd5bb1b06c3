"""Tensor-parallel training through the port's Trainer and cli/train.py on
gloo CPU ranks: one Trainer step on 1 x 2 and 2 x 2 (data x model) grids
against the one-device Trainer's step on the same batch (its logged
metrics at rtol 1e-4, the BN statistics of its gathered state at rtol
1e-4, atol 2e-5: JAX's test_tp_matches_single_device), and ``cli.train
--model_parallel 2`` (alone, with ``--data_parallel 2`` and with
``--bf16_params``) for 2 epochs: the checkpoint holds the full tensors,
serves in a one-device session and resumes, under TP and on one device.

num_point 64, batch 8 on a 60-shape Chair fixture: 50 trainval shapes (6
batches per epoch), 10 test shapes.
"""

import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from pointnet_autoencoder_tpu_torch.cli import train as cli
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
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
                  log_dir=str(log_dir), log_every=2, max_epoch=1,
                  input_mode="host")
    return TrainConfig(**dict(fields, **overrides))


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_trainer_step_matches_one_device(fixture_root, tmp_path, data,
                                         model):
    batch = np.random.RandomState(4).randn(BATCH, NUM_POINT, 3).astype(
        np.float32)
    one = Trainer(_config(fixture_root, tmp_path / "one"), device="cpu")
    metrics = one.train_step(torch.from_numpy(batch))
    want = {k: float(v) for k, v in metrics.items()}
    stats = {k: v.clone() for k, v in one.model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    one.close()
    cfg = _config(fixture_root, tmp_path / "tp", data_parallel=data,
                  model_parallel=model)
    out = tmp_path / "ranks"
    out.mkdir()
    mesh.launch(workers.tp_trainer_step_rank, devices=["cpu"] * (data * model),
                backend="gloo", init_method=f"file://{tmp_path / 'store'}",
                args=(cfg.to_json(), batch, str(out)))
    for r in workers.load_ranks(str(out), data * model):
        for key in ("loss", "pcloss"):
            np.testing.assert_allclose(r["means"][key], want[key],
                                       rtol=1e-4, err_msg=key)
        for n, w in stats.items():
            np.testing.assert_allclose(r["model"][n].numpy(), w.numpy(),
                                       rtol=1e-4, atol=2e-5, err_msg=n)


@pytest.mark.parametrize("flags", [
    [], ["--data_parallel", "2"], ["--bf16_params"]])
def test_cli_train_model_parallel(fixture_root, tmp_path, flags):
    """cli.train --model_parallel 2 --device cpu for 2 epochs: one log and
    one set of checkpoints (rank 0), the best checkpoint in the one-device
    format serving within 1e-5 of InferenceSession(model_parallel=2) on
    it, and resumes, under TP and on one device."""
    log_dir = tmp_path / "log"
    argv = ["--device", "cpu", "--model", "model", "--category", "Chair",
            "--num_point", str(NUM_POINT), "--batch_size", str(BATCH),
            "--data_path", fixture_root, "--log_dir", str(log_dir),
            "--max_epoch", "2", "--log_every", "2", "--model_parallel", "2",
            "--no-bf16", *flags]
    assert cli.main(argv) == 0
    text = (log_dir / "log_train.txt").read_text()
    assert text.count("**** EPOCH 001 ****") == 1
    best = sorted(p.name for p in log_dir.iterdir()
                  if p.name.startswith("best_model_epoch_"))[-1]
    tree = checkpoint.load(str(log_dir / best))
    full = Trainer(_config(fixture_root, tmp_path / "shape"), device="cpu")
    for n, t in full.model.state_dict().items():
        assert tuple(tree["model"][n].shape) == tuple(t.shape), n
    full.close()
    one = InferenceSession("model", str(log_dir / best), NUM_POINT,
                           batch_size=4, device="cpu")
    split = InferenceSession("model", str(log_dir / best), NUM_POINT,
                             batch_size=4, device="cpu", model_parallel=2)
    x = np.random.RandomState(2).randn(4, NUM_POINT, 3).astype(np.float32)
    np.testing.assert_allclose(split.reconstruct(x), one.reconstruct(x),
                               rtol=1e-5, atol=1e-5)
    steps = 2 * STEPS_PER_EPOCH
    assert int(tree["step"]) == steps
    assert cli.main(argv + ["--resume", "--max_epoch", "3"]) == 0
    again = checkpoint.load(checkpoint.CheckpointManager(
        str(log_dir)).latest())
    assert int(again["step"]) == steps + STEPS_PER_EPOCH
    # The TP checkpoint resumes on one device too.
    tr = Trainer(_config(fixture_root, log_dir, resume=True, max_epoch=4,
                         bf16_params="--bf16_params" in flags),
                 device="cpu")
    assert tr.state.step == steps + STEPS_PER_EPOCH
    tr.close()
