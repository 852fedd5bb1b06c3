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
import sys

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


# -- the CUDA kernel's schedule, emulated -------------------------------------
#
# csrc/emd.cu fuses pass B of level li with pass A of level li + 1, which
# reorders sums but not the arithmetic, and takes K_li from the next
# level's exp2: K_li = ((K_{li+1})^2)^2 for li <= 7, exp2 of its own for
# li = 8, 1 for li = 9, with exp2 flushing results under 2^-126 to 0
# (ex2.approx.ftz); d2 is fma(dz, dz, fma(dy, dy, dx*dx)), and pass B's
# sums are factored by the owned point's ratio. _kernel_schedule is that
# arithmetic in plain f32 PyTorch. Tolerances against emd_forward_plain and the JAX dense scan:
# cost rtol 1e-5; gradients within 1e-4 of the largest entry, the chunked
# form's tolerance: K moves by a few ulp, and the annealing carries that
# to a few entries as it carries a summation order (largest reading
# 3.0e-5 of the largest entry at 2x24x24, gradient error norm 7.7e-6).

_LOG2E = 1.4426950408889634


def _level2(li):
    """level * log2(e) in f32 as the kernel computes it; 0 for li = 9."""
    return np.float32(0.0 if li == 9 else -_LOG2E * 4.0 ** (7 - li))


def _ex2_ftz(x, flush=True):
    y = torch.exp2(x)
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y) if flush \
        else y


def _kernel_k(d2, li, flush=True):
    """K of level li as the kernel computes it, for pass A and pass B."""
    if li == 9:
        return torch.ones_like(d2)
    if li == 8:
        return _ex2_ftz(float(_level2(8)) * d2, flush)
    e = _ex2_ftz(float(_level2(li + 1)) * d2, flush)
    e2 = e * e
    return e2 * e2


def _fma_sqdist(xyz1, xyz2):
    """d2 as the kernel rounds it, fma(dz, dz, fma(dy, dy, dx*dx)): each
    fma in float64 (the f32 product is exact there), then rounded to f32;
    up to a rare double rounding, the hardware fma."""
    dx, dy, dz = (xyz1[:, :, None, c] - xyz2[:, None, :, c] for c in range(3))
    d2 = dx * dx
    for d in (dy, dz):
        d2 = (d.double() * d.double() + d2.double()).float()
    return d2


def _kernel_schedule(xyz1, xyz2, flush=True):
    """emd_forward_plain's scan with the kernel's K and d2 (see above), and
    its factoring of pass B: each orientation sums K times the streamed
    point's ratio and multiplies the sums by the owned point's ratio."""
    d2 = _fma_sqdist(xyz1, xyz2)
    rinv = torch.rsqrt(torch.clamp_min(d2, 1e-20))
    remain_l, remain_r = emd._init_remains(xyz1, xyz2)
    cost = xyz1.new_zeros(xyz1.shape[0])
    grad1 = torch.zeros_like(xyz1)
    grad2 = torch.zeros_like(xyz2)
    for li in range(10):
        k = _kernel_k(d2, li, flush)
        ratio_l, ratio_r, remain_r = emd._level_weights(k, remain_l, remain_r)
        w_rows = k * ratio_r[:, None, :]  # the row kernel's sums, / ratioL
        w_cols = k * ratio_l[:, :, None]  # the column kernel's, / ratioR
        remain_l = torch.clamp_min(remain_l - w_rows.sum(dim=2) * ratio_l,
                                   0.0)
        wr_rows, wr_cols = w_rows * rinv, w_cols * rinv
        cost = cost + torch.einsum("bnm,bnm->bn", wr_rows, d2).mul(
            ratio_l).sum(dim=1)
        for c in range(3):
            diff = xyz1[:, :, None, c] - xyz2[:, None, :, c]
            grad1[:, :, c] += (wr_rows * diff).sum(dim=2) * ratio_l
            grad2[:, :, c] -= (wr_cols * diff).sum(dim=1) * ratio_r
    return cost, grad1, grad2


def test_kernel_levels_differ_by_exact_powers_of_four():
    """The premise of K_li = ((K_{li+1})^2)^2: level2 of li is exactly 4x
    that of li + 1 for li <= 7, and so is its f32 product with any d2."""
    d2 = np.random.RandomState(1).rand(1000).astype(np.float32) * 3
    for li in range(8):
        assert _level2(li) == np.float32(4) * _level2(li + 1)
        np.testing.assert_array_equal(_level2(li) * d2,
                                      np.float32(4) * (_level2(li + 1) * d2))
    assert [float(-_level2(li) / _LOG2E) for li in range(10)] == pytest.approx(
        [-lv for lv in emd._LEVELS], rel=1e-7)


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_kernel_schedule_matches_plain_and_jax(b, n, m):
    x1, x2 = _clouds(b, n, m, seed=n + m)
    got = _port_forward(_kernel_schedule, x1, x2)
    _assert_forward(got, _port_forward(emd.emd_forward_plain, x1, x2),
                    grad_tol=1e-4)
    _assert_forward(got, jemd._emd_forward(jnp.asarray(x1), jnp.asarray(x2)),
                    grad_tol=1e-4)


def test_kernel_schedule_coincident_points():
    x1, x2 = _coincident()
    got = _port_forward(_kernel_schedule, x1, x2)
    assert all(np.all(np.isfinite(t)) for t in got)
    _assert_forward(got, _port_forward(emd.emd_forward_plain, x1, x2))
    _assert_forward(got, jemd._emd_forward(jnp.asarray(x1), jnp.asarray(x2)))
    _assert_oracle(got, x1, x2)


def _exp2_each_level(d2, li, flush=False):
    """K as exp2 of each level's own level * log2(e) times d2: one exp2
    per level, without the squaring."""
    if li == 9:
        return torch.ones_like(d2)
    return _ex2_ftz(float(_level2(li)) * d2, flush)


@pytest.mark.parametrize("b,n,m", [(2, 64, 64), (3, 37, 29), (4, 128, 128)])
def test_kernel_k_shortcuts_cost_no_accuracy(b, n, m, monkeypatch):
    """exp2 results under 2^-126 flushed to 0 or kept: the early levels
    make many such K, and they move cost and gradients by under 1e-6 of
    their scale. And K_li from the next level's K squared twice is as far
    from the float64 plain scan as exp2 of each level's own exponent,
    within 2x: the f32 exponent level * log2(e) * d2, not the squaring,
    sets that error (the plain f32 scan's level * d2 is exact, so at small
    shapes it sits closer to float64 than either)."""
    x1, x2 = _clouds(b, n, m, seed=3 * n + m)
    a, c = torch.from_numpy(x1), torch.from_numpy(x2)
    d2 = emd.sqdist_matrix(a, c)
    small = torch.exp2(float(_level2(1)) * d2)
    assert bool(((small > 0) & (small < 2.0 ** -126)).any())
    fused = _kernel_schedule(a, c)
    kept = _kernel_schedule(a, c, flush=False)
    _assert_forward([t.numpy() for t in fused], kept, cost_rtol=1e-6,
                    grad_tol=1e-6)
    monkeypatch.setattr(sys.modules[__name__], "_kernel_k", _exp2_each_level)
    each = _kernel_schedule(a, c)
    exact = [t.numpy() for t in emd.emd_forward_plain(a.double(), c.double())]

    def gap(got):
        got = [t.numpy() for t in got]
        cost = np.abs(got[0] - exact[0]).max() / np.abs(exact[0]).max()
        num = sum(np.sum((g.astype(np.float64) - e) ** 2)
                  for g, e in zip(got[1:], exact[1:]))
        den = sum(np.sum(e ** 2) for e in exact[1:])
        return cost, np.sqrt(num / den)

    (f_cost, f_grad), (e_cost, e_grad) = gap(fused), gap(each)
    assert f_cost <= 2 * e_cost + 1e-7 and f_grad <= 2 * e_grad + 1e-7


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
