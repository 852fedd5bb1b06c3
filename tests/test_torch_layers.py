"""The rest of the port's layer library and encoder against the JAX
package, on the CPU in f32, with weights moved by
convert.from_flax_variables:

- ``PointNetEncoder(moment_stats=True)``'s training branch (conv1-4's
  statistics from input moments, ``MomentStatsPointMLP``) against JAX's
  ``PointNetEncoder(moment_stats=True)``: the feature, every gradient, the
  input's gradient and the new BN moving statistics, at the port's f32
  tolerances for the encoder's train branch (tests/test_torch_train.py:
  outputs rtol 1e-4, atol 1e-5; gradients rtol 5e-3, atol 2e-3; BN
  statistics rtol 1e-4, atol 1e-6);
- moment against direct statistics in the port, at JAX's tolerances
  (tests/test_fused_encoder.py:217-226: features rtol/atol 2e-3,
  statistics rtol 1e-3, atol 1e-4);
- ``Conv`` in 1-D, 2-D and 3-D with SAME and VALID padding at strides 1
  and 2 (BN in training), and both pools, against flax's: rtol 1e-5,
  atol 1e-6 (one product sum per output, summed in another order);
- ``Dropout``: about half kept at keep_prob 0.5, the kept values scaled by
  1/keep_prob, eval the identity (JAX tests/test_layers.py:118-127).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.nn.encoder import PointNetEncoder as JEncoder
from pointnet_autoencoder_tpu.nn.layers import Conv as JConv
from pointnet_autoencoder_tpu.nn.layers import avg_pool as javg_pool
from pointnet_autoencoder_tpu.nn.layers import max_pool as jmax_pool
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.nn import layers
from pointnet_autoencoder_tpu_torch.nn.encoder import (MomentStatsPointMLP,
                                                       PointNetEncoder)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


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


# -- moment statistics ------------------------------------------------------


def test_moment_stats_encoder_matches_jax():
    x = np.random.RandomState(15).randn(3, 96, 3).astype(np.float32)
    jenc = JEncoder(head_impl="pallas", moment_stats=True)
    variables = _perturbed(jenc.init(jax.random.PRNGKey(1), x, train=False,
                                     bn_momentum=0.9), seed=2)
    r = np.random.RandomState(16).randn(3, 1024).astype(np.float32)

    def jloss(params, pts):
        out, mutated = jenc.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, pts,
            train=True, bn_momentum=0.75, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, mutated["batch_stats"])

    (_, (want, want_stats)), (jgrads, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"], x)

    enc = _load(PointNetEncoder(moment_stats=True), variables)
    assert all(isinstance(getattr(enc, f"conv{i}"), MomentStatsPointMLP)
               for i in range(1, 5))
    assert not isinstance(enc.conv5, MomentStatsPointMLP)
    pts = torch.from_numpy(x).requires_grad_(True)
    out = enc(pts, train=True, bn_momentum=0.75)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pts.grad.numpy(), np.asarray(jgx),
                               rtol=5e-3, atol=2e-3)
    want_grads = from_flax_variables({"params": jgrads})
    for name, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=5e-3, atol=2e-3, err_msg=name)
    want_sd = from_flax_variables({"params": variables["params"],
                                   "batch_stats": want_stats})
    for name, buf in enc.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_moment_stats_eval_is_the_plain_encoder():
    enc = PointNetEncoder(moment_stats=True,
                          generator=torch.Generator().manual_seed(3))
    plain = PointNetEncoder(generator=torch.Generator().manual_seed(3))
    pts = torch.from_numpy(
        np.random.RandomState(4).randn(2, 50, 3).astype(np.float32))
    assert torch.equal(enc(pts), plain(pts))
    layer = enc.conv2
    x = torch.randn(2, 50, 64, generator=torch.Generator().manual_seed(5))
    assert torch.equal(layer(x, False), layers.PointMLP.forward(layer, x,
                                                                False))


def test_moment_stats_against_direct_stats():
    """The same weights with and without moment statistics: features and
    the new moving statistics at JAX's tolerances; the gradients at the
    fused head's (rtol 5e-3, atol 2e-3: bias-type gradients through BN
    are cancellation)."""
    gen = np.random.RandomState(21)
    x = torch.from_numpy(gen.randn(4, 128, 3).astype(np.float32))
    r = torch.from_numpy(gen.randn(4, 1024).astype(np.float32))
    encs = [PointNetEncoder(moment_stats=m,
                            generator=torch.Generator().manual_seed(8))
            for m in (True, False)]
    outs = []
    for enc in encs:
        out = enc(x, train=True, bn_momentum=0.5)
        (out * r).sum().backward()
        outs.append(out.detach().numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-3, atol=2e-3)
    (mom, direct) = encs
    for (name, a), (_, b) in zip(mom.named_buffers(), direct.named_buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    for (name, a), (_, b) in zip(mom.named_parameters(),
                                 direct.named_parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=5e-3, atol=2e-3, err_msg=name)


# -- Conv and the pools -------------------------------------------------------

# (input shape without batch and channels, kernel) per rank: odd and even
# extents, so SAME's odd pad lands after the data.
CONV_CASES = {1: ((9,), (3,)), 2: ((7, 8), (3, 2)), 3: ((5, 6, 4), (2, 3, 3))}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_conv_matches_flax(rank, padding, stride):
    spatial, kernel = CONV_CASES[rank]
    strides = (stride,) * rank
    rng = np.random.RandomState(rank * 10 + stride)
    x = rng.randn(2, *spatial, 4).astype(np.float32)
    jmod = JConv(6, kernel, strides=strides, padding=padding, bn=True)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(rank), x, False,
                                     0.9), seed=rank)
    want, mutated = jmod.apply(variables, x, True, 0.6,
                               mutable=["batch_stats"])
    tree = {"params": {"layer": variables["params"]},
            "batch_stats": {"layer": variables["batch_stats"]}}
    conv = _load(layers.Conv(4, 6, kernel, strides=strides, padding=padding,
                             bn=True), tree, prefix="layer.")
    got = conv(torch.from_numpy(x), train=True, bn_momentum=0.6)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    stats = from_flax_variables({"params": {}, "batch_stats": {
        "layer": mutated["batch_stats"]}})
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(conv.bn, name).numpy(),
                                   stats[f"layer.bn.{name}"].numpy(), **TOL)
    # Eval: normalized by the moving statistics.
    want_eval = jmod.apply(variables, x, False, 0.6)
    np.testing.assert_allclose(
        _load(layers.Conv(4, 6, kernel, strides=strides, padding=padding,
                          bn=True), tree, prefix="layer.")(
            torch.from_numpy(x), train=False).detach().numpy(),
        np.asarray(want_eval), **TOL)


def test_conv_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="1-, 2- or 3-D"):
        layers.Conv(3, 4, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="SAME' or 'VALID"):
        layers.Conv(3, 4, (3,), padding="CIRCULAR")(torch.zeros(1, 5, 3))
    with pytest.raises(ValueError, match="conv kernel"):
        from_flax_variables({"params": {"layer": {"conv": {
            "kernel": np.zeros((3, 4), np.float32)}}}})


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_pools_match_flax(rank, kind, padding):
    spatial, _ = CONV_CASES[rank]
    x = np.random.RandomState(rank).randn(2, *spatial, 3).astype(np.float32)
    window = (3, 2, 2)[:rank]
    strides = (2, 1, 2)[:rank]
    jfn, fn = ((jmax_pool, layers.max_pool) if kind == "max"
               else (javg_pool, layers.avg_pool))
    want = np.asarray(jfn(jnp.asarray(x), window, strides, padding))
    got = fn(torch.from_numpy(x), window, strides, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_pools_default_strides_to_the_window():
    x = torch.arange(32.0).reshape(1, 4, 4, 2)
    mx = layers.max_pool(x, (2, 2))
    av = layers.avg_pool(x, (2, 2))
    assert mx.shape == av.shape == (1, 2, 2, 2)
    assert float(mx[0, 0, 0, 0]) == 10.0   # max of {0,2,8,10}
    assert float(av[0, 0, 0, 0]) == 5.0    # mean of {0,2,8,10}


# -- default arguments --------------------------------------------------------


def _default_call_cases():
    """(name, JAX module, the port's module, input) of each layer whose
    call defaults to training, every one with BN so that the default
    shows; inputs from a numpy seed, shifted off zero mean so that batch
    and moving statistics differ."""
    from pointnet_autoencoder_tpu.nn.layers import FC as JFC
    from pointnet_autoencoder_tpu.nn.layers import PointMLP as JPointMLP
    from pointnet_autoencoder_tpu.nn.layers import UpConv as JUpConv

    rng = np.random.RandomState(0)
    points = (rng.randn(2, 16, 3) * 3 + 1).astype(np.float32)
    rows = (rng.randn(4, 5) * 3 + 1).astype(np.float32)
    image = (rng.randn(2, 2, 3, 4) * 3 + 1).astype(np.float32)
    return {
        "PointMLP": (JPointMLP(8), layers.PointMLP(3, 8), points),
        "FC": (JFC(6, bn=True), layers.FC(5, 6, bn=True), rows),
        "UpConv": (JUpConv(6, (3, 3), (2, 2)),
                   layers.UpConv(4, 6, (3, 3), (2, 2)), image),
        "Conv": (JConv(8, (3,), bn=True), layers.Conv(3, 8, (3,), bn=True),
                 points),
    }


@pytest.mark.parametrize("name", ["PointMLP", "FC", "UpConv", "Conv"])
def test_default_call_trains_as_flax(name):
    """A layer called with default arguments trains, as flax's does
    (``apply(v, x, mutable=["batch_stats"])``): the same output and the
    same moving statistics, at rtol and atol 1e-5."""
    jmod, mod, x = _default_call_cases()[name]
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), x))
    want, mutated = jmod.apply(variables, x, mutable=["batch_stats"])
    tree = {"params": {"layer": variables["params"]},
            "batch_stats": {"layer": variables["batch_stats"]}}
    _load(mod, tree, prefix="layer.")
    got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stats = from_flax_variables({"params": {}, "batch_stats": {
        "layer": mutated["batch_stats"]}})
    for stat in ("mean", "var"):
        np.testing.assert_allclose(getattr(mod.bn, stat).numpy(),
                                   stats[f"layer.bn.{stat}"].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=stat)


# -- Dropout ----------------------------------------------------------------


def test_dropout_train_vs_eval():
    m = layers.Dropout(keep_prob=0.5,
                       generator=torch.Generator().manual_seed(2))
    x = torch.ones(64, 64)
    assert torch.equal(m(x, False), x)
    y = m(x, True)
    zeros = float((y == 0).float().mean())
    assert 0.3 < zeros < 0.7  # about half dropped
    np.testing.assert_allclose(y[y != 0].numpy(), 2.0, rtol=1e-6)
    # The generator decides the mask: the same seed, the same mask.
    again = layers.Dropout(0.5, torch.Generator().manual_seed(2))(x)
    assert torch.equal(y, again)
    assert torch.equal(layers.Dropout(1.0)(x), x)
    assert not layers.Dropout(0.0)(x).any()
    with pytest.raises(ValueError, match="keep_prob"):
        layers.Dropout(1.5)
