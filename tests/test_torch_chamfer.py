"""Port's Chamfer forward (pointnet_autoencoder_tpu_torch/ops/chamfer.py)
against the JAX package's nn_distance (dense XLA and the Pallas kernel in
interpret mode) and the numpy oracles, on the CPU with the plain version.

Distances: rtol 1e-6 (both sides compute the same f32 outer differences;
only an FMA contraction on the XLA side could move the last bit).
Indices: exactly equal, ties included (the first minimum wins).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.ops import chamfer as jchamfer
from pointnet_autoencoder_tpu.ops import oracles
from pointnet_autoencoder_tpu_torch.ops import chamfer

torch.set_num_threads(2)

SHAPES = [(2, 5, 6), (1, 37, 129), (3, 128, 64)]


def _clouds(b, n, m, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3).astype(np.float32),
            rng.randn(b, m, 3).astype(np.float32))


def _tied(seed=1):
    """Every target point twice (lower index first) and queries that copy
    targets exactly: zero-distance and duplicate ties."""
    rng = np.random.RandomState(seed)
    half = rng.randn(2, 20, 3).astype(np.float32)
    x2 = np.concatenate([half, half[:, ::-1]], axis=1)
    x1 = np.concatenate([half[:, ::2], rng.randn(2, 7, 3).astype(np.float32)],
                        axis=1)
    return x1, x2


def _port(x1, x2):
    return [t.numpy() for t in chamfer.nn_distance(torch.from_numpy(x1),
                                                   torch.from_numpy(x2))]


def _assert_same(got, want):
    d1, i1, d2, i2 = got
    np.testing.assert_allclose(d1, want[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(d2, want[2], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(i1, np.asarray(want[1]))
    np.testing.assert_array_equal(i2, np.asarray(want[3]))
    assert i1.dtype == np.int32 and i2.dtype == np.int32
    assert d1.dtype == np.float32 and d2.dtype == np.float32


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("b,n,m", SHAPES)
def test_nn_distance_matches_jax(impl, b, n, m):
    x1, x2 = _clouds(b, n, m)
    want = jax.jit(lambda a, c: jchamfer.nn_distance(a, c, impl=impl))(x1, x2)
    _assert_same(_port(x1, x2), [np.asarray(w) for w in want])


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_nn_distance_matches_oracle(b, n, m):
    x1, x2 = _clouds(b, n, m, seed=2)
    _assert_same(_port(x1, x2), oracles.nn_distance_np(x1, x2))


@pytest.mark.parametrize("impl", ["xla", "pallas", "oracle"])
def test_ties_pick_first_index(impl):
    x1, x2 = _tied()
    got = _port(x1, x2)
    if impl == "oracle":
        want = oracles.nn_distance_np(x1, x2)
    else:
        want = [np.asarray(w) for w in jchamfer.nn_distance(x1, x2, impl=impl)]
    _assert_same(got, want)
    # The copies sit at distance 0 and resolve to the lower index.
    assert np.all(got[0][:, :10] == 0.0)
    np.testing.assert_array_equal(
        got[1][:, :10], np.broadcast_to(np.arange(0, 20, 2), (2, 10)))


def test_plain_is_the_cpu_path_and_bf16_is_cast_first():
    x1, x2 = _clouds(2, 9, 11, seed=3)
    a = torch.from_numpy(x1).bfloat16()
    b = torch.from_numpy(x2).bfloat16()
    got = chamfer.nn_distance(a, b)
    want = chamfer.nn_distance_plain(a.float(), b.float())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,m", [(16, 16), (16, 24)])
def test_chamfer_loss_matches_jax(n, m):
    x1, x2 = _clouds(2, n, m, seed=4)
    got = chamfer.chamfer_loss(torch.from_numpy(x1), torch.from_numpy(x2))
    want = jchamfer.chamfer_loss(jnp.asarray(x1), jnp.asarray(x2), impl="xla")
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("threshold", [0.3, 0.8])
def test_fscore_matches_oracle_and_jax(threshold):
    x1, x2 = _clouds(3, 40, 50, seed=5)
    got = chamfer.fscore(torch.from_numpy(x1), torch.from_numpy(x2),
                         threshold).numpy()
    np.testing.assert_allclose(got, oracles.fscore_np(x1, x2, threshold),
                               rtol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jchamfer.fscore(x1, x2, threshold, impl="xla")),
        rtol=1e-6)
    assert 0.0 < got.mean() < 1.0


def test_rejects_grad_and_bad_shapes():
    """Inputs that require grad are no longer refused (the gradient is
    ported; tests/test_torch_chamfer_grad.py holds its values); bad shapes
    still are."""
    x1, x2 = _clouds(1, 4, 5)
    a = torch.from_numpy(x1).requires_grad_(True)
    d1, _, d2, _ = chamfer.nn_distance(a, torch.from_numpy(x2))
    (d1.sum() + d2.sum()).backward()
    assert a.grad.shape == a.shape and torch.isfinite(a.grad).all()
    with pytest.raises(ValueError, match="expected"):
        chamfer.nn_distance(torch.zeros(1, 4, 2), torch.zeros(1, 5, 3))
    with pytest.raises(ValueError, match="empty"):
        chamfer.nn_distance(torch.zeros(1, 0, 3), torch.zeros(1, 5, 3))


def test_cuda_wrapper_refuses_cpu_tensors():
    x1, x2 = _clouds(1, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        chamfer.nn_distance_cuda(torch.from_numpy(x1), torch.from_numpy(x2))
