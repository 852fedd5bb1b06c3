"""The port's device-resident input (data/device_pipeline.py) and the
Trainer's device-input epochs, against the JAX package on the CPU.

Held:
- ``DeviceDataset`` data (cyclically padded) and lengths bit-equal to
  the JAX package's on the same fixture, with ragged shapes;
- ``assemble_from`` fed the ``u`` and angles that ``jax.random`` draws
  inside the JAX ``assemble_batch`` (from its own ``k_sel, k_rot =
  jax.random.split(key)``): the selected point indices bit-equal, the
  rotated points within 1e-6 (JAX rotates in f32 products of its own
  order and f32 cos/sin, the port in f64 cos/sin rounded to f32);
- the epochs' shape orders (``epoch`` and ``epoch_chunks`` with its tail)
  equal to the JAX iterator's for the same seed;
- a device-input training epoch logs what a host-input one logs.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.data import device_pipeline as jdp
from pointnet_autoencoder_tpu.data import shapenet_part as jshapenet
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data import device_pipeline as dp
from pointnet_autoencoder_tpu_torch.data import shapenet_part, synthetic
from pointnet_autoencoder_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

BATCH = 8
NUM_POINT = 96


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Ragged shapes (variable point counts), three categories."""
    return synthetic.write_fixture(
        str(tmp_path_factory.mktemp("fix") / "data"), 10, 60, seed=2,
        variable_points=True)


def test_device_dataset_equals_the_jax_package_s(root):
    ours = dp.DeviceDataset(shapenet_part.PartDataset(root, npoints=32))
    theirs = jdp.DeviceDataset(jshapenet.PartDataset(root, npoints=32))
    assert ours.num_shapes == theirs.num_shapes > BATCH
    assert ours.data.dtype == torch.float32
    assert ours.lengths.dtype == torch.int32
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(theirs.data))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(theirs.lengths))
    assert len(set(ours.lengths.tolist())) > 1  # ragged
    assert ours.nbytes() == theirs.nbytes()


def test_upload_drops_the_item_cache_and_keeps_the_dataset(root):
    ds = shapenet_part.PartDataset(root, npoints=32, seed=0)
    first = ds[0][0]
    assert ds._cache
    dd = dp.DeviceDataset(ds, max_shapes=3)
    assert dd.num_shapes == 3 and not ds._cache
    assert ds[0][0].shape == first.shape  # decodes again lazily
    # Cyclic padding: past its true length a shape repeats from its start.
    n = int(dd.lengths[0])
    if dd.data.shape[1] > n:
        assert torch.equal(dd.data[0, n], dd.data[0, 0])


def _index_data(d=6, p=40, lengths=(40, 7, 13, 40, 1, 29)):
    """Points that encode their own (shape, point) index, so a batch's
    points name the indices selected."""
    data = np.zeros((d, p, 3), np.float32)
    data[:, :, 0] = np.arange(d)[:, None]
    data[:, :, 1] = np.arange(p)[None, :]
    return data, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_from_selects_the_jax_indices(seed):
    data, lengths = _index_data()
    idxs = np.asarray([3, 1, 4, 1, 5, 0, 2, 4], np.int32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jdp.assemble_batch(
        jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(idxs), key,
        NUM_POINT, rotate=False))
    k_sel, _ = jax.random.split(key)
    u = np.array(jax.random.uniform(k_sel, (len(idxs), NUM_POINT)))
    got = dp.assemble_from(torch.from_numpy(data), torch.from_numpy(lengths),
                           torch.from_numpy(idxs), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    sel = got[..., 1].numpy().astype(np.int64)
    assert (sel < lengths[idxs][:, None]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_from_rotates_as_the_jax_package(root, seed):
    ds = shapenet_part.PartDataset(root, npoints=32)
    dd = dp.DeviceDataset(ds)
    data, lengths = dd.data.numpy(), dd.lengths.numpy()
    idxs = np.random.RandomState(seed).randint(
        0, dd.num_shapes, BATCH).astype(np.int32)
    key = jax.random.PRNGKey(10 + seed)
    want = np.asarray(jdp.assemble_batch(
        jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(idxs), key,
        NUM_POINT, rotate=True))
    k_sel, k_rot = jax.random.split(key)
    u = np.array(jax.random.uniform(k_sel, (BATCH, NUM_POINT)))
    angles = np.array(jax.random.uniform(k_rot, (BATCH,), minval=0.0,
                                           maxval=2.0 * jnp.pi))
    got = dp.assemble_from(dd.data, dd.lengths, torch.from_numpy(idxs),
                           torch.from_numpy(u), torch.from_numpy(angles))
    assert got.shape == (BATCH, NUM_POINT, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # Unrotated, the same draw selects the same points exactly.
    plain = dp.assemble_from(dd.data, dd.lengths, torch.from_numpy(idxs),
                             torch.from_numpy(u))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(
        jdp.assemble_batch(jnp.asarray(data), jnp.asarray(lengths),
                           jnp.asarray(idxs), key, NUM_POINT,
                           rotate=False)))
    # The rotation is about Y: y kept, x-z radii kept.
    np.testing.assert_array_equal(got[..., 1], plain[..., 1])
    np.testing.assert_allclose(
        torch.hypot(got[..., 0], got[..., 2]).numpy(),
        torch.hypot(plain[..., 0], plain[..., 2]).numpy(), atol=1e-6)


def test_draw_ranges_and_generator_determinism():
    gen = torch.Generator().manual_seed(5)
    u, angles = dp.draw(gen, 4, 1000, rotate=True)
    assert u.shape == (4, 1000) and angles.shape == (4,)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert 0.0 <= float(angles.min()) and float(angles.max()) < 2 * math.pi
    u2, angles2 = dp.draw(gen, 4, 1000, rotate=True)
    assert not torch.equal(u, u2)  # fresh randomness on every draw
    again = torch.Generator().manual_seed(5)
    u3, angles3 = dp.draw(again, 4, 1000, rotate=True)
    assert torch.equal(u, u3) and torch.equal(angles, angles3)
    assert dp.draw(gen, 2, 3, rotate=False)[1] is None


def test_assemble_batch_samples_only_real_points(root):
    dd = dp.DeviceDataset(shapenet_part.PartDataset(root, npoints=32))
    idxs = torch.arange(4)
    batch = dp.assemble_batch(dd.data, dd.lengths, idxs,
                              torch.Generator().manual_seed(0), 64,
                              rotate=False)
    assert batch.shape == (4, 64, 3)
    for b in range(4):
        real = dd.data[b, :int(dd.lengths[b])]
        d2 = ((batch[b][:, None] - real[None]) ** 2).sum(-1)
        assert float(d2.min(dim=1).values.max()) < 1e-10


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_orders_equal_the_jax_iterator_s(shuffle):
    ours = dp.DeviceBatchIterator(23, 4, shuffle=shuffle, seed=3)
    theirs = jdp.DeviceBatchIterator(23, 4, shuffle=shuffle, seed=3)
    assert len(ours) == len(theirs) == 5
    for _ in range(2):
        got = [i.tolist() for i in ours.epoch()]
        want = [np.asarray(i).tolist() for i, _ in theirs.epoch()]
        assert got == want


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 7])
def test_epoch_chunks_carry_the_tail_as_jax(chunk):
    ours = dp.DeviceBatchIterator(23, 4, shuffle=True, seed=1)
    theirs = jdp.DeviceBatchIterator(23, 4, shuffle=True, seed=1)
    for _ in range(2):
        got = [c.tolist() for c in ours.epoch_chunks(chunk)]
        want = [c.tolist() for c, _ in theirs.epoch_chunks(chunk)]
        assert got == want
        assert [len(c) for c in got][-1] == (5 % chunk or chunk)
    with pytest.raises(ValueError):
        next(ours.epoch_chunks(0))


def _trainer(root, tmp_path, mode, **kw):
    cfg = TrainConfig(**{**dict(data_path=root, num_point=64, batch_size=4,
                                log_dir=str(tmp_path / mode), log_every=2,
                                input_mode=mode, bf16=False), **kw})
    return Trainer(cfg, device="cpu")


def test_device_and_host_epochs_log_the_same_lines(root, tmp_path):
    """One epoch in each mode: the same log lines but for the numbers, the
    same scalar records (steps and keys), finite values, and the device
    input built on the device."""
    logs, scalars = {}, {}
    for mode in ("device", "host"):
        tr = _trainer(root, tmp_path, mode, max_epoch=1)
        try:
            if mode == "device":
                assert isinstance(tr.train_pipe, dp.DeviceBatchIterator)
                assert tr.train_device.num_shapes == len(tr.train_dataset)
            tr.train()
        finally:
            tr.close()
        with open(os.path.join(tmp_path, mode, "log_train.txt")) as f:
            logs[mode] = [line.split(":")[0] for line in f]
        with open(os.path.join(tmp_path, mode, "scalars.jsonl")) as f:
            scalars[mode] = [json.loads(line) for line in f]
    assert logs["device"] == logs["host"]
    assert " -- 002 / 006 --\n" in logs["device"]
    strip = [[(r["split"], r["step"], sorted(r)) for r in scalars[m]]
             for m in ("device", "host")]
    assert strip[0] == strip[1]
    assert all(np.isfinite(r["loss"]) for r in scalars["device"])


def test_device_input_with_a_ragged_epoch_tail(root, tmp_path):
    """log_every 4 over 6 batches: one full window logged (the reference
    logs full windows only), every step taken."""
    tr = _trainer(root, tmp_path, "device", max_epoch=1, log_every=4)
    try:
        tr.train()
        assert tr.state.step == len(tr.train_pipe) == 6
    finally:
        tr.close()
    with open(os.path.join(tmp_path, "device", "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [(r["split"], r["step"]) for r in recs
            if r["split"] == "train"] == [("train", 4)]
