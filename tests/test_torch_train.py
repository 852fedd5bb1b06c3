"""The port's training path against the JAX package, on the CPU with the
kernels' plain versions: training BatchNorm, the encoder's train branch,
one whole train step of the port's Trainer, the schedules and the
optimizers. Weights cross by convert.from_flax_variables.

Tolerances, each the JAX package's own for the same comparison:
- training BN output and moving statistics: rtol 1e-5 (atol 1e-6 for
  values near 0);
- encoder train branch: outputs rtol 1e-4, atol 1e-5; gradients rtol
  5e-3, atol 2e-3 (tests/test_fused_head.py:275: the statistics come from
  moments on one side and directly on the other, and bias-type gradients
  through BN are pure cancellation, rounding noise at the 1e-3 scale);
- train step: loss and pcloss rtol 1e-4; gradients of pcloss (the loss
  is pcloss x 100) as the encoder's; new BN moving statistics rtol 1e-4,
  atol 1e-5 (the decoder's statistics see the encoder feature, which the
  two heads round differently by up to the head's 1e-5); learning_rate
  and bn_decay equal in f32;
- optimizers, fed identical gradients: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.nn.encoder import PointNetEncoder as JEncoder
from pointnet_autoencoder_tpu.nn.layers import PointMLP as JPointMLP
from pointnet_autoencoder_tpu.train import schedules as jschedules
from pointnet_autoencoder_tpu.train.loop import make_step_fns
from pointnet_autoencoder_tpu.train.state import TrainState as JTrainState
from pointnet_autoencoder_tpu.train.state import make_optimizer as jopt
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.nn.encoder import PointNetEncoder
from pointnet_autoencoder_tpu_torch.nn.layers import FC, PointMLP
from pointnet_autoencoder_tpu_torch.train import schedules
from pointnet_autoencoder_tpu_torch.train.loop import Trainer
from pointnet_autoencoder_tpu_torch.train.state import make_optimizer

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 4


def _perturbed(variables, seed=0):
    """Variables as numpy with BN parameters and statistics moved off
    their init values (a quarter of the gammas negative)."""
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "gamma":
            return (a * np.where(rng.rand(*a.shape) < 0.25, -1, 1)
                    * (1 + 0.2 * rng.rand(*a.shape))).astype(np.float32)
        if name == "var":
            return (a + 0.5 * rng.rand(*a.shape)).astype(np.float32)
        if a.ndim == 1:
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


def _load(module, variables, prefix=""):
    sd = {k[len(prefix):]: v for k, v in from_flax_variables(variables).items()
          if k.startswith(prefix)}
    module.load_state_dict(sd)
    return module


# -- training BatchNorm -----------------------------------------------------


@pytest.mark.parametrize("layer,shape", [("point", (3, 40, 8)),
                                         ("fc", (6, 8))])
@pytest.mark.parametrize("momentum", [0.5, 0.99])
def test_training_bn_matches_jax(layer, shape, momentum):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 2 + 1
    jmod = JPointMLP(16)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0), x, train=False))
    want, mutated = jmod.apply(variables, x, train=True,
                               bn_momentum=momentum, mutable=["batch_stats"])
    cls = PointMLP if layer == "point" else FC
    mod = _load(cls(8, 16, bn=True), {"params": variables["params"],
                                      "batch_stats": variables["batch_stats"]})
    got = mod(torch.from_numpy(x), train=True, bn_momentum=momentum)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(mod.bn, name).numpy(),
            np.asarray(mutated["batch_stats"]["bn"][name]), rtol=1e-5,
            atol=1e-6, err_msg=name)


def test_eval_bn_leaves_moving_statistics_alone():
    mod = PointMLP(3, 8)
    before = (mod.bn.mean.clone(), mod.bn.var.clone())
    mod(torch.randn(2, 5, 3), train=False)
    assert torch.equal(mod.bn.mean, before[0])
    assert torch.equal(mod.bn.var, before[1])
    mod(torch.randn(2, 5, 3), train=True, bn_momentum=0.5)
    assert not torch.equal(mod.bn.mean, before[0])


# -- encoder train branch ---------------------------------------------------


def test_encoder_train_branch_matches_jax_pallas_head():
    x = np.random.RandomState(5).randn(2, 64, 3).astype(np.float32)
    jenc = JEncoder(head_impl="pallas")
    variables = _perturbed(jenc.init(jax.random.PRNGKey(0), x, train=False,
                                     bn_momentum=0.9))
    r = np.random.RandomState(6).randn(2, 1024).astype(np.float32)

    def jloss(params):
        out, mutated = jenc.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, bn_momentum=0.75, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, mutated["batch_stats"])

    (_, (want, want_stats)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(variables["params"])

    enc = _load(PointNetEncoder(), variables)
    out = enc(torch.from_numpy(x), train=True, bn_momentum=0.75)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    want_grads = from_flax_variables({"params": jgrads})
    for name, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=5e-3, atol=2e-3, err_msg=name)
    want_sd = from_flax_variables({"params": variables["params"],
                                   "batch_stats": want_stats})
    for name, buf in enc.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_encoder_bf16_train_branch_stays_near_jax():
    """bf16 through five layers: each framework rounds each layer's
    product, bias, BN affine and ReLU to bf16 at its own places (XLA fuses
    the elementwise chain in f32), so single values differ by a few bf16
    steps; the bound is 3% of the output's scale."""
    x = np.random.RandomState(7).randn(2, 64, 3).astype(np.float32)
    jenc = JEncoder(dtype=jnp.bfloat16, head_impl="pallas")
    variables = _perturbed(jenc.init(jax.random.PRNGKey(0), x, train=False,
                                     bn_momentum=0.9))
    want, _ = jenc.apply(variables, x, train=True, bn_momentum=0.5,
                         mutable=["batch_stats"])
    enc = _load(PointNetEncoder(dtype=torch.bfloat16), variables)
    got = enc(torch.from_numpy(x), train=True, bn_momentum=0.5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


# -- one train step of the Trainer -----------------------------------------


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 12, NUM_POINT, categories=["Chair"])


def _trainer(tmp_path, fixture_root, **overrides):
    cfg = TrainConfig(data_path=fixture_root, category="Chair",
                      num_point=NUM_POINT, batch_size=BATCH, bf16=False,
                      log_dir=str(tmp_path / "log"), **overrides)
    return Trainer(cfg, device="cpu")


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_one_train_step_matches_jax(tmp_path, fixture_root, optimizer):
    spec = jspec("model")
    module, variables = spec.init_variables(jax.random.PRNGKey(0), NUM_POINT)
    variables = _perturbed(variables)
    batch = np.random.RandomState(3).randn(BATCH, NUM_POINT, 3).astype(
        np.float32)
    lr = jschedules.learning_rate_schedule(0.001, 0.7, BATCH, 200000)
    bn = jschedules.bn_momentum_schedule(BATCH, 200000)
    tx = jopt(optimizer, lr, 0.9)
    train_step, _ = make_step_fns(module, spec, tx, bn, lr)
    new_state, metrics = train_step(JTrainState.create(variables, tx), batch)

    def jloss(params):
        (pred, ep), _ = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, bn_momentum=bn(0), mutable=["batch_stats"])
        return spec.loss_fn(pred, batch, ep)[0]

    jgrads = from_flax_variables({"params": jax.grad(jloss)(
        variables["params"])})

    trainer = _trainer(tmp_path, fixture_root, optimizer=optimizer)
    _load(trainer.model, variables)
    got = trainer.train_step(torch.from_numpy(batch))
    trainer.close()
    assert trainer.state.step == 1
    for key in ("loss", "pcloss"):
        np.testing.assert_allclose(float(got[key]), float(metrics[key]),
                                   rtol=1e-4, err_msg=key)
    for key in ("learning_rate", "bn_decay"):
        assert np.float32(got[key]) == np.asarray(metrics[key]), key
    # Gradients of the loss, each leaf held by its relative error norm.
    # Entries of a leaf span six decades (up to ~300 in conv1's weight), so
    # an elementwise atol either passes a wrong small entry or fails on the
    # rounding of a large one. The biases of every layer followed by a
    # training BN (and conv5's beta, which fc1's BN cancels) have a
    # gradient that is zero in exact arithmetic: both sides must read as
    # rounding noise against the whole gradient.
    total = np.sqrt(sum(float(np.sum(g.numpy().astype(np.float64) ** 2))
                        for g in jgrads.values()))
    for name, p in trainer.model.named_parameters():
        got_g = p.grad.numpy().astype(np.float64)
        want_g = jgrads[name].numpy().astype(np.float64)
        if np.linalg.norm(want_g) < 1e-5 * total:
            assert np.linalg.norm(got_g) < 1e-5 * total, name
            continue
        # Largest reading, f32 on the CPU: 1.8e-4 (conv2's gamma).
        rel = np.linalg.norm(got_g - want_g) / np.linalg.norm(want_g)
        assert rel < 1e-3, (name, rel)
    want_sd = from_flax_variables(jax.device_get(
        {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    for name, buf in trainer.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# -- schedules and optimizers ----------------------------------------------


@pytest.mark.parametrize("floor", [None, 6e-4])
def test_schedules_match_jax(floor):
    steps = [0, 1, 2, 3, 4, 5, 9, 10, 50]
    lr = schedules.learning_rate_schedule(0.001, 0.7, 8, 20, floor=floor)
    jlr = jschedules.learning_rate_schedule(0.001, 0.7, 8, 20, floor=floor)
    bn = schedules.bn_momentum_schedule(8, 20)
    jbn = jschedules.bn_momentum_schedule(8, 20)
    for s in steps:
        np.testing.assert_allclose(lr(s), float(jlr(s)), rtol=1e-6)
        assert np.float32(bn(s)) == np.float32(jbn(s)), s
    assert bn(50) == 0.99 and lr(0) == 0.001


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_optimizer_matches_optax_across_a_staircase(name):
    """Three steps with identical gradients; the LR staircase (batch 8,
    decay_step 16) drops between step 1 and step 2."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) for _ in range(3)]
    lr = schedules.learning_rate_schedule(0.01, 0.5, 8, 16)
    jlr = jschedules.learning_rate_schedule(0.01, 0.5, 8, 16)
    assert lr(1) != lr(2)

    tx = jopt(name, jlr, 0.9)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(name, [param], 0.9)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for group in opt.param_groups:
            group["lr"] = lr(step)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7, err_msg=str(step))
