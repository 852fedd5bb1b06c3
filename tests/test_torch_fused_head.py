"""Port's fused encoder head (pointnet_autoencoder_tpu_torch/ops/
fused_head.py, plain versions on the CPU) against the JAX package's
fused_dense_bn_relu_max (impl="pallas", run interpreted on the CPU, and
impl="xla") and head_stats.

Tolerances, the JAX package's own (tests/test_fused_head.py):
- outputs rtol 1e-5, atol 1e-5 (:74);
- gradients for x, w, b, gamma, beta, mean and var rtol 1e-4, atol 1e-5
  (:118): the dense products sum in another order;
- bf16 rtol and atol 2e-2 (:234): one bf16 rounding of x @ w or of a
  gradient value can differ between the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.ops import fused_head as jhead
from pointnet_autoencoder_tpu.ops import oracles
from pointnet_autoencoder_tpu_torch.ops import fused_head

torch.set_num_threads(2)

EPS = 1e-3
NAMES = ["x", "w", "b", "gamma", "beta", "mean", "var"]


def _inputs(b=3, n=48, c=16, f=128, seed=0):
    """Head inputs with batch statistics, a gamma == 0 channel (1) and a
    dead channel (0: beta far below zero, so relu is 0 everywhere)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    w = (rng.randn(c, f) * 0.3).astype(np.float32)
    bias = (rng.randn(f) * 0.1).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(f)).astype(np.float32)
    beta = (0.1 * rng.randn(f)).astype(np.float32)
    gamma[1] = 0.0
    beta[0] = -1e4
    y = x.reshape(-1, c).astype(np.float64) @ w + bias
    mean = y.mean(axis=0).astype(np.float32)
    var = y.var(axis=0).astype(np.float32)
    return x, w, bias, gamma, beta, mean, var


def _torch(args, dtype=torch.float32):
    x, w, b, *rest = (torch.from_numpy(a) for a in args)
    return [x.to(dtype), w.to(dtype), b.to(dtype), *rest]


def _jax(args, dtype=jnp.float32):
    x, w, b, *rest = (jnp.asarray(a) for a in args)
    return [x.astype(dtype), w.astype(dtype), b.astype(dtype), *rest]


@pytest.mark.parametrize("impl", ["pallas", "xla", "oracle"])
@pytest.mark.parametrize("b,n,c,f", [(3, 48, 16, 128), (2, 64, 8, 256)])
def test_forward_matches_jax(impl, b, n, c, f):
    args = _inputs(b, n, c, f, seed=11)
    out = fused_head.fused_dense_bn_relu_max(*_torch(args), eps=EPS)
    if impl == "oracle":
        want, want_arg = oracles.fused_head_np(*args, eps=EPS)
        scale, shift = fused_head.fold_affine(
            *(torch.from_numpy(a) for a in args[2:]), EPS)
        _, arg = fused_head.head_max_plain(
            torch.from_numpy(args[0]), torch.from_numpy(args[1]), scale,
            shift)
        np.testing.assert_array_equal(arg.numpy(), want_arg)
    else:
        want = jhead.fused_dense_bn_relu_max(*_jax(args), eps=EPS,
                                             impl=impl)
    assert out.dtype == torch.float32 and out.shape == (b, f)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(out[:, 0].abs().max()) == 0.0  # the dead channel


def _port_grads(args, r, dtype=torch.float32):
    ts = [t.requires_grad_(True) for t in _torch(args, dtype)]
    out = fused_head.fused_dense_bn_relu_max(*ts, eps=EPS)
    (out * torch.from_numpy(r)).sum().backward()
    return out, [t.grad for t in ts]


def _jax_grads(args, r, impl, dtype=jnp.float32):
    def loss(*a):
        return jnp.sum(jhead.fused_dense_bn_relu_max(
            *a, eps=EPS, impl=impl) * r)

    return jax.grad(loss, argnums=tuple(range(7)))(*_jax(args, dtype))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_all_seven_grads_match_jax(impl):
    args = _inputs()
    r = np.random.RandomState(1).randn(3, 128).astype(np.float32)
    _, got = _port_grads(args, r)
    want = _jax_grads(args, r, impl)
    for g, w_, name in zip(got, want, NAMES):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # gamma == 0 contributes nothing to dgamma and dvar; the dead
    # channel's parameters get no gradient at all.
    for name in ("gamma", "var"):
        assert float(got[NAMES.index(name)][1]) == 0.0
    for name in ("b", "gamma", "beta", "mean", "var"):
        assert float(got[NAMES.index(name)][0]) == 0.0, name


def test_bf16_outputs_and_grads_match_jax():
    args = _inputs(seed=5)
    r = np.random.RandomState(6).randn(3, 128).astype(np.float32)
    out, got = _port_grads(args, r, torch.bfloat16)
    want_out = jhead.fused_dense_bn_relu_max(*_jax(args, jnp.bfloat16),
                                             eps=EPS, impl="pallas")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=2e-2, atol=2e-2)
    want = _jax_grads(args, r, "pallas", jnp.bfloat16)
    for g, w_, name in zip(got, want, NAMES):
        assert g.dtype == (torch.bfloat16 if name in ("x", "w", "b")
                           else torch.float32), name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w_, np.float32), rtol=2e-2,
                                   atol=2e-2, err_msg=name)


def test_plain_backward_rounds_gvals_to_the_activation_type():
    """dx and dw of the plain K4 equal the dense one-hot products of
    gvals rounded to bf16 (fused_head.py:190), not of the f32 values."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 16, 8).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(8, 256).astype(np.float32)).bfloat16()
    gvals = torch.from_numpy(rng.randn(2, 256).astype(np.float32) / 3)
    arg = torch.from_numpy(rng.randint(0, 16, (2, 256)).astype(np.int32))
    dx, dw = fused_head.head_bwd_plain(x, w, gvals, arg)
    g = gvals.bfloat16().float()
    want_dw = torch.zeros(8, 256)
    want_dx = torch.zeros(2, 16, 8)
    for bi in range(2):
        for f in range(256):
            row = int(arg[bi, f])
            want_dw[:, f] += x[bi, row].float() * g[bi, f]
            want_dx[bi, row] += w[:, f].float() * g[bi, f]
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dx, want_dx.bfloat16(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_head_stats_matches_jax(dtype):
    x, w, b, *_ = _inputs(b=2, n=40, c=16, f=128, seed=8)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    mean, var = fused_head.head_stats(
        *(torch.from_numpy(a).to(tdt) for a in (x, w, b)))
    jmean, jvar = jhead.head_stats(*(jnp.asarray(a, jdt) for a in (x, w, b)))
    assert mean.dtype == torch.float32 and var.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-4,
                               atol=1e-4)


def test_head_stats_then_head_grads_match_jax():
    """The composition the encoder's conv5 runs: statistics from moments
    under autograd, then the fused head; gradients for x, w and b carry
    the through-the-statistics terms."""
    x, w, b, gamma, beta, _, _ = _inputs(seed=9)
    r = np.random.RandomState(10).randn(3, 128).astype(np.float32)

    def jloss(xa, wa, ba):
        mean, var = jhead.head_stats(xa, wa, ba)
        return jnp.sum(jhead.fused_dense_bn_relu_max(
            xa, wa, ba, gamma, beta, mean, var, eps=EPS, impl="pallas") * r)

    want = jax.grad(jloss, argnums=(0, 1, 2))(x, w, b)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    mean, var = fused_head.head_stats(*ts)
    out = fused_head.fused_dense_bn_relu_max(
        *ts, torch.from_numpy(gamma), torch.from_numpy(beta), mean, var,
        eps=EPS)
    (out * torch.from_numpy(r)).sum().backward()
    for t, w_, name in zip(ts, want, NAMES):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_shapes():
    x, w, b, gamma, beta, mean, var = _torch(_inputs())
    s = torch.ones(128)
    with pytest.raises(ValueError, match="CUDA"):
        fused_head.head_max_cuda(x, w, s, s)
    with pytest.raises(ValueError, match="CUDA"):
        fused_head.head_bwd_cuda(x, w, torch.zeros(3, 128),
                                 torch.zeros(3, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        fused_head.fused_dense_bn_relu_max(x, w[:4], b, gamma, beta, mean,
                                           var)
