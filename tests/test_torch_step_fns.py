"""The port's library step, ``train.loop.make_step_fns``, and
``fetch_metric_means``, against the JAX package's on the CPU (the kernels'
plain versions; weights cross by ``convert.from_flax_variables``), and
the library loop of ``examples/minimal_train.py`` written against the
port.

Tolerances, those of ``tests/test_torch_train.py`` for the same step:
loss and pcloss rtol 1e-4; new BN moving statistics rtol 1e-4, atol
1e-5; learning_rate and bn_decay equal in f32; the eval metrics rtol
1e-4. The updated parameters within 2 x the learning rate, absolute:
Adam's first step moves each entry by about +-lr, so an entry whose
gradient is near 0 may move either way on the two sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.train import schedules as jschedules
from pointnet_autoencoder_tpu.train.loop import (
    fetch_metric_means as jfetch_metric_means,
)
from pointnet_autoencoder_tpu.train.loop import make_step_fns as jmake_step_fns
from pointnet_autoencoder_tpu.train.state import TrainState as JTrainState
from pointnet_autoencoder_tpu.train.state import make_optimizer as jopt
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.data.device_pipeline import (
    DeviceBatchIterator,
    DeviceDataset,
    assemble_batch,
)
from pointnet_autoencoder_tpu_torch.data.shapenet_part import PartDataset
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.train import schedules
from pointnet_autoencoder_tpu_torch.train.loop import (
    fetch_metric_means,
    make_step_fns,
)
from pointnet_autoencoder_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
)

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 4
BASE_LR = 0.001


def _schedules():
    return (schedules.learning_rate_schedule(BASE_LR, 0.7, BATCH, 200000),
            schedules.bn_momentum_schedule(BATCH, 200000))


def _state(name, optimizer="adam", seed=0, dtype=torch.float32):
    model = get_model_spec(name).make(
        NUM_POINT, dtype=dtype, generator=torch.Generator().manual_seed(seed))
    lr, _ = _schedules()
    return TrainState(model, make_optimizer(optimizer, model.parameters()),
                      lr)


@pytest.mark.parametrize("name", ["model", "model_cpu", "model_emd",
                                  "model_hierachy"])
def test_make_step_fns_matches_jax(name):
    spec = jspec(name)
    module, variables = spec.init_variables(jax.random.PRNGKey(0), NUM_POINT)
    variables = jax.device_get(variables)
    batch = np.random.RandomState(3).randn(BATCH, NUM_POINT, 3).astype(
        np.float32)
    jlr = jschedules.learning_rate_schedule(BASE_LR, 0.7, BATCH, 200000)
    jbn = jschedules.bn_momentum_schedule(BATCH, 200000)
    tx = jopt("adam", jlr, 0.9)
    jtrain, jeval = jmake_step_fns(module, spec, tx, jbn, jlr)
    jstate = JTrainState.create(variables, tx)
    want_eval = jeval(jstate, batch)
    new_state, want = jtrain(jstate, batch)

    state = _state(name)
    state.model.load_state_dict(from_flax_variables(variables))
    _, bn = _schedules()
    train_step, eval_step = make_step_fns(state, name, bn)
    x = torch.from_numpy(batch)
    got_eval = eval_step(x)
    got = train_step(x)
    assert state.step == 1
    assert sorted(got) == sorted(want)
    assert sorted(got_eval) == sorted(want_eval)
    for key in want_eval:
        np.testing.assert_allclose(float(got_eval[key]),
                                   float(want_eval[key]), rtol=1e-4,
                                   err_msg=key)
    for key in set(want) - {"learning_rate", "bn_decay"}:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    for key in ("learning_rate", "bn_decay"):
        assert np.float32(got[key]) == np.asarray(want[key]), key
    want_sd = from_flax_variables(jax.device_get(
        {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    for n, buf in state.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_sd[n].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[n].numpy(),
                                   rtol=0, atol=2 * BASE_LR, err_msg=n)


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
@pytest.mark.parametrize("name", ["model", "model_emd"])
def test_make_step_fns_is_the_train_state_step_on_the_cpu(name, optimizer):
    """compiled=True on the CPU is the eager step: bit-equal to
    ``TrainState.train_step`` and ``eval_step`` over two steps."""
    lr, bn = _schedules()
    a, b = _state(name, optimizer), _state(name, optimizer)
    train_step, eval_step = make_step_fns(a, name, bn, compiled=True)
    assert not hasattr(train_step, "programs")
    loss_fn = get_model_spec(name).loss_fn
    rng = np.random.RandomState(5)
    for _ in range(2):
        x = torch.from_numpy(rng.randn(BATCH, NUM_POINT, 3).astype(
            np.float32))
        got, want = train_step(x), b.train_step(x, loss_fn, bn)
        assert sorted(got) == sorted(want)
        for key in got:
            assert torch.equal(got[key], want[key]), key
        got, want = eval_step(x), b.eval_step(x, loss_fn)
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert a.step == b.step == 2
    for (n, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), n


def test_fetch_metric_means_matches_jax():
    rng = np.random.RandomState(7)
    rows = [{k: np.float32(rng.randn() * 10) for k in
             ("loss", "pcloss", "learning_rate", "bn_decay")}
            for _ in range(10)]
    want = jfetch_metric_means([{k: jnp.asarray(v) for k, v in r.items()}
                                for r in rows])
    got = fetch_metric_means([{k: torch.tensor(v) for k, v in r.items()}
                              for r in rows])
    assert got == want


def test_the_library_loop_of_the_minimal_example_trains(tmp_path):
    """``examples/minimal_train.py`` against the port: registry,
    schedules, optimizer, ``make_step_fns``, the dataset on the device,
    5 epochs of bf16 steps at B=8, N=256; the epoch's mean loss falls."""
    batch_size, num_point, epochs = 8, 256, 5
    root = synthetic.write_fixture(str(tmp_path / "data"),
                                   shapes_per_category=40)
    dataset = PartDataset(root, npoints=num_point, split="trainval",
                          class_choice=["Chair"], seed=0)
    device_data = DeviceDataset(dataset)
    batches = DeviceBatchIterator(device_data.num_shapes, batch_size,
                                  shuffle=True)
    lr = schedules.learning_rate_schedule(1e-3, 0.7, batch_size, 200000)
    bn = schedules.bn_momentum_schedule(batch_size, 200000)
    name = "model"
    model = get_model_spec(name).make(
        num_point, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer("adam", model.parameters()), lr)
    train_step, _ = make_step_fns(state, name, bn)
    means = []
    for _ in range(epochs):
        pending = [train_step(assemble_batch(
            device_data.data, device_data.lengths, idxs, batches.generator,
            num_point, rotate=True)) for idxs in batches.epoch()]
        means.append(fetch_metric_means(pending))
    assert state.step == epochs * len(batches) > 0
    losses = [m["loss"] for m in means]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < 0.8 * losses[0], losses
    assert means[-1]["pcloss"] < means[0]["pcloss"]
