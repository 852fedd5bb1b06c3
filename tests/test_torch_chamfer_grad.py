"""Port's Chamfer gradient (the autograd Function of
pointnet_autoencoder_tpu_torch/ops/chamfer.py, whose plain version runs
on the CPU) against the JAX package's nn_distance gradients (dense XLA,
and the Pallas kernel in interpret mode) and the numpy oracle
nn_distance_grad_np.

Tolerance rtol 1e-4, atol 1e-5, the JAX package's own for this gradient
(tests/test_chamfer.py:56): the one-hot matmul path and the scatter sum
each row's terms in a different order.
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

RTOL, ATOL = 1e-4, 1e-5


def _clouds(b, n, m, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3).astype(np.float32),
            rng.randn(b, m, 3).astype(np.float32))


def _tied(seed=1):
    """Every target point twice (lower index first), queries that copy
    targets exactly, and a tight cluster of queries near few targets:
    ties and many-to-one matches."""
    rng = np.random.RandomState(seed)
    half = rng.randn(2, 20, 3).astype(np.float32)
    x2 = np.concatenate([half, half[:, ::-1]], axis=1)
    cluster = half[:, :3].repeat(4, axis=1) + 1e-3 * rng.randn(
        2, 12, 3).astype(np.float32)
    x1 = np.concatenate([half[:, ::2], cluster], axis=1)
    return x1, x2


def _cotangents(b, n, m, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n).astype(np.float32),
            rng.randn(b, m).astype(np.float32))


def _port_grads(x1, x2, g1, g2):
    a = torch.from_numpy(x1).requires_grad_(True)
    b = torch.from_numpy(x2).requires_grad_(True)
    d1, _, d2, _ = chamfer.nn_distance(a, b)
    ((d1 * torch.from_numpy(g1)).sum()
     + (d2 * torch.from_numpy(g2)).sum()).backward()
    return a.grad.numpy(), b.grad.numpy()


def _jax_grads(x1, x2, g1, g2, impl):
    def f(a, b):
        d1, _, d2, _ = jchamfer.nn_distance(a, b, impl=impl)
        return jnp.sum(d1 * g1) + jnp.sum(d2 * g2)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(x1, x2)]


CASES = [("N=M", 2, 33, 33), ("N<M", 2, 17, 23), ("N>M", 3, 64, 20),
         ("ties", 2, None, None)]


def _case(kind, b, n, m):
    if kind == "ties":
        x1, x2 = _tied()
        return x1, x2, *_cotangents(2, x1.shape[1], x2.shape[1])
    return (*_clouds(b, n, m), *_cotangents(b, n, m))


@pytest.mark.parametrize("impl", ["xla", "pallas", "oracle"])
@pytest.mark.parametrize("kind,b,n,m", CASES)
def test_grad_matches_jax_and_oracle(impl, kind, b, n, m):
    x1, x2, g1, g2 = _case(kind, b, n, m)
    got = _port_grads(x1, x2, g1, g2)
    if impl == "oracle":
        _, i1, _, i2 = oracles.nn_distance_np(x1, x2)
        want = oracles.nn_distance_grad_np(x1, x2, i1, i2, g1, g2)
    else:
        want = _jax_grads(x1, x2, g1, g2, impl)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_many_to_one_rows_collect_every_match():
    """Three queries whose nearest target is the same point: that target's
    gradient row is the sum of their three -t terms plus its own t."""
    x2 = np.array([[[0.0, 0.0, 0.0], [10.0, 10.0, 10.0]]], np.float32)
    x1 = np.array([[[0.1, 0.0, 0.0], [0.0, 0.2, 0.0], [0.0, 0.0, 0.3]]],
                  np.float32)
    g1 = np.ones((1, 3), np.float32)
    g2 = np.ones((1, 2), np.float32)
    gx1, gx2 = _port_grads(x1, x2, g1, g2)
    # x2[0]'s match is x1[0] (distance 0.01); x2[1]'s is x1[2].
    t1 = 2.0 * (x1[0] - x2[0, 0])
    want0 = 2.0 * (x2[0, 0] - x1[0, 0]) - t1.sum(axis=0)
    np.testing.assert_allclose(gx2[0, 0], want0, rtol=1e-6, atol=1e-7)
    _, i1, _, i2 = oracles.nn_distance_np(x1, x2)
    want = oracles.nn_distance_grad_np(x1, x2, i1, i2, g1, g2)
    np.testing.assert_allclose(gx1, want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gx2, want[1], rtol=1e-6, atol=1e-7)


def test_bf16_cloud_gets_a_bf16_gradient_of_the_f32_values():
    """The f32 cast sits outside the Function, as in the reference, so the
    gradient of a bf16 cloud comes back bf16: the f32 gradient rounded."""
    x1, x2 = _clouds(2, 9, 11, seed=3)
    a = torch.from_numpy(x1).bfloat16().requires_grad_(True)
    b = torch.from_numpy(x2)
    loss = chamfer.chamfer_loss(a, b)
    loss.backward()
    assert a.grad.dtype == torch.bfloat16
    ref = torch.from_numpy(a.detach().float().numpy()).requires_grad_(True)
    chamfer.chamfer_loss(ref, b).backward()
    assert torch.equal(a.grad, ref.grad.bfloat16())


def test_chamfer_loss_grad_matches_jax():
    x1, x2 = _clouds(2, 24, 30, seed=4)
    a = torch.from_numpy(x1).requires_grad_(True)
    chamfer.chamfer_loss(a, torch.from_numpy(x2)).backward()
    want = jax.grad(lambda p: jchamfer.chamfer_loss(p, x2, impl="xla"))(x1)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# -- the CUDA kernel's order, emulated ----------------------------------------
#
# csrc/chamfer.cu writes each output row once, as its own t plus the sum,
# from 0, of the -t of every source matched to it in ascending source
# index. On the CPU index_add_ adds in index order too, so the emulation
# equals nn_distance_grad_plain bit for bit; against the JAX package it is
# held at this file's tolerance.


def _owner_order_grad(x1, x2, i1, i2, g1, g2):
    """numpy f32 emulation of the kernel's owner order: bucket the sources
    by target row, then gx = t + ((0 + -t_a) + -t_b) + ... by index."""
    f32 = np.float32

    def t_of(q, r, idx, g):
        return (f32(2) * g)[..., None] * (q - np.take_along_axis(
            r, idx[..., None].astype(np.int64), axis=1))

    t1, t2 = t_of(x1, x2, i1, g1), t_of(x2, x1, i2, g2)
    out = []
    for t_own, t_src, idx in ((t1, t2, i2), (t2, t1, i1)):
        gx = np.empty_like(t_own)
        for b in range(t_own.shape[0]):
            buckets = [[] for _ in range(t_own.shape[1])]
            for l, k in enumerate(idx[b]):
                buckets[k].append(l)  # ascending l
            for i, bucket in enumerate(buckets):
                acc = np.zeros(3, f32)
                for l in bucket:
                    acc = acc + (-t_src[b, l])
                gx[b, i] = t_own[b, i] + acc
        out.append(gx)
    return out


def _crowded(seed=5):
    """Many-to-one both ways: 60 queries in 3 tight clusters, each near
    one of 4 targets, and targets that share their nearest query."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(2, 4, 3).astype(np.float32)
    x1 = (centers[:, :3].repeat(20, axis=1)
          + 1e-2 * rng.randn(2, 60, 3)).astype(np.float32)
    return x1, centers


def test_cpu_index_add_adds_in_index_order():
    """What the kernel's bit-equality with the plain version rests on."""
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(rng.randint(0, 7, 500))
    src = torch.from_numpy(rng.randn(500, 3).astype(np.float32))
    got = torch.zeros(7, 3).index_add_(0, idx, src).numpy()
    want = np.zeros((7, 3), np.float32)
    for k, row in zip(idx.numpy(), src.numpy()):
        want[k] = want[k] + row
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,b,n,m", CASES + [("crowded", 2, None, None)])
def test_owner_order_equals_plain_and_matches_jax(kind, b, n, m):
    if kind == "crowded":
        x1, x2 = _crowded()
        g1, g2 = _cotangents(2, x1.shape[1], x2.shape[1])
    else:
        x1, x2, g1, g2 = _case(kind, b, n, m)
    _, i1, _, i2 = oracles.nn_distance_np(x1, x2)
    if kind == "crowded":
        assert np.bincount(i1[0]).max() >= 20
    got = _owner_order_grad(x1, x2, i1, i2, g1, g2)
    plain = chamfer.nn_distance_grad_plain(
        *(torch.from_numpy(np.asarray(v)) for v in (x1, x2, i1, i2, g1, g2)))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())
    for g, w in zip(got, _jax_grads(x1, x2, g1, g2, "xla")):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_grad_cuda_wrapper_refuses_cpu_tensors():
    x1, x2 = _clouds(1, 4, 5)
    i1 = torch.zeros((1, 4), dtype=torch.int32)
    i2 = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        chamfer.nn_distance_grad_cuda(
            torch.from_numpy(x1), torch.from_numpy(x2), i1, i2,
            torch.zeros(1, 4), torch.zeros(1, 5))
