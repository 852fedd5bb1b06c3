"""Port's approximate EMD (pointnet_autoencoder_tpu_torch/ops/emd.py)
against the JAX package's ops/emd.py (the dense scan, the streaming
row-chunked form, the Pallas kernel in interpret mode) and the numpy
oracles of the reference GPU op, on the CPU with the plain versions.

Tolerances:
- against the JAX package's dense scan, chunked form and Pallas kernel
  (the same f32 algorithm, sums in another order): cost rtol 1e-5;
  gradients within 2e-5 of the largest gradient entry (largest reading
  1.6e-6), not elementwise: the annealing amplifies a last-bit difference
  at a few entries;
- the port's chunked form against its dense form: cost rtol 1e-5;
  gradients within 1e-4 of the largest entry (the two forms sum in other
  orders, and differ by up to 2.9e-5 of it in the JAX package too);
- against the numpy oracles: rtol 1e-3, atol 1e-4, the JAX package's own
  (tests/test_emd_fused.py:24,65-70);
- plan-based functions against JAX: match rtol 1e-5, atol 1e-7; cost and
  gradients as the dense scan.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.ops import emd as jemd
from pointnet_autoencoder_tpu.ops import oracles
from pointnet_autoencoder_tpu.ops.emd_pallas import emd_forward_pallas
from pointnet_autoencoder_tpu_torch.ops import emd

torch.set_num_threads(2)

# N = M, N = 2M (capacities 1 and 2), M = 2N (2 and 1), N > M with
# capacity 1 (37 // 29), and a wider square.
SHAPES = [(2, 24, 24), (2, 32, 16), (2, 16, 32), (3, 37, 29), (2, 64, 64)]


def _clouds(b, n, m, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, n, 3).astype(np.float32),
            rng.rand(b, m, 3).astype(np.float32))


def _coincident(seed=9):
    """xyz2 holds every point of xyz1 (permuted) and a few of its own:
    pairs at d2 = 0."""
    rng = np.random.RandomState(seed)
    x1 = rng.rand(2, 24, 3).astype(np.float32)
    x2 = np.concatenate([x1[:, rng.permutation(24)],
                         rng.rand(2, 8, 3).astype(np.float32)], axis=1)
    return x1, x2


def _port_forward(fn, x1, x2):
    return [t.numpy() for t in fn(torch.from_numpy(x1), torch.from_numpy(x2))]


def _assert_forward(got, want, cost_rtol=1e-5, grad_tol=2e-5):
    """Cost by rtol; each gradient within grad_tol of the largest entry."""
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=cost_rtol)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want[1:])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == np.asarray(w).shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=grad_tol * scale)


def _assert_oracle(got, x1, x2):
    match = oracles.approx_match_np(x1, x2)
    np.testing.assert_allclose(got[0], oracles.match_cost_np(x1, x2, match),
                               rtol=1e-3, atol=1e-4)
    for g, w in zip(got[1:], oracles.match_cost_grad_np(x1, x2, match)):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4)


# -- the fused forward --------------------------------------------------------


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_plain_matches_jax_dense_scan(b, n, m):
    x1, x2 = _clouds(b, n, m, seed=n + m)
    want = jemd._emd_forward(jnp.asarray(x1), jnp.asarray(x2))
    _assert_forward(_port_forward(emd.emd_forward_plain, x1, x2), want)


@pytest.mark.parametrize("b,n,m", [(2, 16, 16), (1, 32, 8), (2, 32, 24)])
def test_plain_matches_jax_pallas_kernel(b, n, m):
    """The TPU kernel run as the JAX package's tests run it on the CPU."""
    x1, x2 = _clouds(b, n, m, seed=6)
    want = emd_forward_pallas(jnp.asarray(x1), jnp.asarray(x2),
                              interpret=True)
    assert want is not None
    _assert_forward(_port_forward(emd.emd_forward_plain, x1, x2), want)


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_plain_matches_oracles(b, n, m):
    x1, x2 = _clouds(b, n, m, seed=2 * n + m)
    _assert_oracle(_port_forward(emd.emd_forward_plain, x1, x2), x1, x2)


def test_coincident_points():
    """d2 = 0 pairs: the gradient's rsqrt clamp (max(d2, 1e-20)) leaves
    them no gradient; everything else as the JAX dense scan and oracle."""
    x1, x2 = _coincident()
    got = _port_forward(emd.emd_forward_plain, x1, x2)
    assert all(np.all(np.isfinite(t)) for t in got)
    _assert_forward(got, jemd._emd_forward(jnp.asarray(x1), jnp.asarray(x2)))
    _assert_oracle(got, x1, x2)


@pytest.mark.parametrize("b,n,m", [(2, 48, 32), (1, 13, 40), (1, 40, 13)])
def test_chunked_matches_jax_chunked_and_dense(b, n, m):
    x1, x2 = _clouds(b, n, m, seed=11)
    got = _port_forward(emd.emd_forward_chunked, x1, x2)
    want = jax.jit(jemd._emd_forward_chunked)(jnp.asarray(x1),
                                              jnp.asarray(x2))
    _assert_forward(got, want)
    _assert_forward(got, _port_forward(emd.emd_forward_plain, x1, x2),
                    grad_tol=1e-4)


@pytest.mark.parametrize("b,n,m,budget", [(2, 40, 32, 4 * 2 * 16 * 32),
                                          (1, 13, 40, 64),
                                          (2, 53, 24, 4 * 2 * 20 * 24)])
def test_chunked_pads_rows_under_a_small_budget(b, n, m, budget, monkeypatch):
    """A small budget forces several chunks, and N not a chunk multiple
    pads the last one with zero-capacity rows; the same picker budget is
    given to the JAX form."""
    chunk = emd._pick_row_chunk(b, n, m, budget_bytes=budget)
    assert -(-n // chunk) >= 2 and n % chunk != 0
    assert chunk == jemd._pick_row_chunk(b, n, m, budget_bytes=budget)
    for mod in (emd, jemd):
        monkeypatch.setattr(mod, "_pick_row_chunk", functools.partial(
            mod._pick_row_chunk, budget_bytes=budget))
    x1, x2 = _clouds(b, n, m, seed=21)
    got = _port_forward(emd.emd_forward_chunked, x1, x2)
    assert got[1].shape == (b, n, 3)
    _assert_forward(got, jemd._emd_forward_chunked(jnp.asarray(x1),
                                                   jnp.asarray(x2)))
    _assert_forward(got, _port_forward(emd.emd_forward_plain, x1, x2),
                    grad_tol=1e-4)
    _assert_oracle(got, x1, x2)


@pytest.mark.parametrize("b,n,m,budget", [
    (1, 16, 16, 1 << 30), (4, 16384, 16384, 256 << 20), (1, 13, 1 << 20, 64),
    (32, 32768, 32768, 256 << 20), (2, 12289, 12289, 256 << 20),
    (1, 101, 103, 256 << 20)])
def test_pick_row_chunk_matches_jax(b, n, m, budget):
    got = emd._pick_row_chunk(b, n, m, budget_bytes=budget)
    assert got == jemd._pick_row_chunk(b, n, m, budget_bytes=budget)
    assert got % 8 == 0 and got >= min(n, 8)


def test_levels_and_capacities_match_jax():
    assert emd._LEVELS == jemd._LEVELS and len(emd._LEVELS) == 10
    for n, m in [(16, 16), (32, 16), (16, 32), (37, 29), (29, 37), (5, 2048)]:
        assert emd._capacities(n, m) == jemd._capacities(n, m)


# -- plan-based functions -----------------------------------------------------


@pytest.mark.parametrize("b,n,m", [(2, 24, 24), (2, 32, 16), (1, 13, 29)])
def test_approx_match_matches_jax_and_oracle(b, n, m):
    x1, x2 = _clouds(b, n, m, seed=3)
    got = emd.approx_match(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == (b, m, n) and not got.requires_grad
    want = jemd.approx_match(jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.numpy(), oracles.approx_match_np(x1, x2),
                               rtol=1e-3, atol=1e-4)


def test_match_cost_and_its_gradient_match_jax():
    x1, x2 = _clouds(2, 20, 28, seed=4)
    match = oracles.approx_match_np(x1, x2)
    a = torch.from_numpy(x1).requires_grad_(True)
    c = torch.from_numpy(x2).requires_grad_(True)
    plan = torch.from_numpy(match).requires_grad_(True)
    cost = emd.match_cost(a, c, plan)
    weights = torch.tensor([1.5, -0.5])
    (cost * weights).sum().backward()
    assert plan.grad is None

    def jloss(p, q):
        return jnp.sum(jemd.match_cost(p, q, jnp.asarray(match))
                       * jnp.asarray([1.5, -0.5]))

    want_cost = jemd.match_cost(jnp.asarray(x1), jnp.asarray(x2),
                                jnp.asarray(match))
    want_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    _assert_forward([cost.detach().numpy(), a.grad.numpy(), c.grad.numpy()],
                    [want_cost, *want_g])
    np.testing.assert_allclose(cost.detach().numpy(),
                               oracles.match_cost_np(x1, x2, match),
                               rtol=1e-3, atol=1e-4)
    w = np.array([1.5, -0.5], np.float32)[:, None, None]
    for g, r in zip((a.grad, c.grad),
                    oracles.match_cost_grad_np(x1, x2, match)):
        np.testing.assert_allclose(g.numpy(), w * r, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,m", [(20, 20), (24, 12)])
def test_fused_loss_equals_the_plan_based_loss(n, m):
    x1, x2 = _clouds(2, n, m, seed=5)
    pred, label = torch.from_numpy(x2), torch.from_numpy(x1)
    fused = emd.emd_loss(pred, label)
    via_match = emd.emd_loss_via_match(pred, label)
    np.testing.assert_allclose(fused.item(), via_match.item(), rtol=1e-5)
    want = jemd.emd_loss_via_match(jnp.asarray(x2), jnp.asarray(x1))
    np.testing.assert_allclose(fused.item(), float(want), rtol=1e-5)


def test_fused_gradients_equal_the_plan_based_gradients():
    x1, x2 = _clouds(1, 24, 24, seed=3)
    fused = [torch.from_numpy(x).requires_grad_(True) for x in (x1, x2)]
    emd.emd_cost(*fused).sum().backward()
    plan = [torch.from_numpy(x).requires_grad_(True) for x in (x1, x2)]
    emd.match_cost(*plan, emd.approx_match(*plan)).sum().backward()
    for f, p in zip(fused, plan):
        np.testing.assert_allclose(f.grad.numpy(), p.grad.numpy(),
                                   rtol=1e-4, atol=1e-6)


# -- the loss under autograd --------------------------------------------------


@pytest.mark.parametrize("n,m", [(32, 32), (40, 20), (20, 40)])
def test_emd_loss_gradients_match_jax_grad(n, m):
    """emd_loss(pred, label) = mean(emd_cost(label, pred)): the prediction
    is xyz2, so its gradient is grad2."""
    label, pred = _clouds(3, n, m, seed=7)
    p = torch.from_numpy(pred).requires_grad_(True)
    q = torch.from_numpy(label).requires_grad_(True)
    loss = emd.emd_loss(p, q)
    loss.backward()
    want, (gp, gq) = jax.value_and_grad(jemd.emd_loss, argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(label))
    _assert_forward([loss.detach().numpy(), p.grad.numpy(), q.grad.numpy()],
                    [want, gp, gq])


def test_cotangent_scales_the_gradients():
    x1, x2 = _clouds(2, 10, 10, seed=5)
    weights = torch.tensor([2.5, -1.0])
    a = torch.from_numpy(x1).requires_grad_(True)
    (emd.emd_cost(a, torch.from_numpy(x2)) * weights).sum().backward()
    _, g1, _ = emd.emd_forward_plain(torch.from_numpy(x1),
                                     torch.from_numpy(x2))
    np.testing.assert_allclose(a.grad.numpy(),
                               (weights[:, None, None] * g1).numpy(),
                               rtol=1e-6)


def test_bf16_prediction_gets_a_bf16_gradient():
    """The f32 cast happens outside the autograd Function: the cost is the
    f32 cost of the bf16 values, and the gradient comes back in bf16."""
    label, pred = _clouds(2, 16, 16, seed=8)
    p = torch.from_numpy(pred).bfloat16().requires_grad_(True)
    loss = emd.emd_loss(p, torch.from_numpy(label))
    assert loss.dtype == torch.float32
    loss.backward()
    assert p.grad.dtype == torch.bfloat16
    p32 = p.detach().float().requires_grad_(True)
    emd.emd_loss(p32, torch.from_numpy(label)).backward()
    assert torch.equal(p.grad, p32.grad.bfloat16())


# -- dispatch -----------------------------------------------------------------


def test_cpu_dispatch_streams_past_the_dense_limit(monkeypatch):
    calls = []
    orig = emd.emd_forward_chunked

    def spy(x1, x2):
        calls.append(tuple(x1.shape))
        return orig(x1, x2)

    monkeypatch.setattr(emd, "emd_forward_chunked", spy)
    x1, x2 = (torch.from_numpy(x) for x in _clouds(2, 16, 16, seed=13))
    dense = emd.emd_cost(x1, x2)
    assert not calls
    monkeypatch.setattr(emd, "_DENSE_BYTES_LIMIT", 4 * 2 * 16 * 16 - 1)
    auto = emd.emd_cost(x1, x2)
    assert calls == [(2, 16, 3)]
    np.testing.assert_allclose(auto.numpy(), dense.numpy(), rtol=1e-5)


def test_rejects_bad_impl_shapes_and_cpu_tensors_in_the_kernel():
    x1, x2 = (torch.from_numpy(x) for x in _clouds(1, 4, 5))
    with pytest.raises(ValueError, match="expected"):
        emd.emd_cost(torch.zeros(1, 4, 2), x2)
    with pytest.raises(ValueError, match="empty"):
        emd.emd_cost(torch.zeros(1, 0, 3), x2)
    with pytest.raises(ValueError, match="CUDA"):
        emd.emd_forward_cuda(x1, x2)
