"""Property-based (hypothesis) fuzz tests of the port's loss ops against
its numpy oracle copy (ops/oracles.py): the twin of the JAX package's
tests/test_fuzz.py, with its settings and tolerances.

Randomized shapes, including n != m, tiny clouds and quantized
coordinates that force exact distance ties, through the plain PyTorch
versions on the CPU:

- Chamfer (tf_ops/nn_distance/tf_nndistance.cpp:21-43): squared L2,
  first-minimum tie-break, int32 idx; the analytic VJP of
  tf_nndistance_g.cu:132-151. ``nn_distance`` (the kernel's route) and
  ``nn_distance_dense`` (the dense form) both.
- approx_match (tf_ops/approxmatch/tf_approxmatch_g.cu:1-179): GPU
  annealing semantics incl. integer-division capacity factors.
- The fused EMD cost equal to the cost of the explicit plan.
"""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from pointnet_autoencoder_tpu_torch.ops import chamfer, emd, oracles

torch.set_num_threads(2)

FUZZ = settings(max_examples=10, deadline=None, derandomize=True)

_NN = {"kernel": chamfer.nn_distance, "dense": chamfer.nn_distance_dense}


def _clouds(b, n, m, seed, quantize=False):
    rng = np.random.RandomState(seed)
    x1 = rng.randn(b, n, 3).astype(np.float32)
    x2 = rng.randn(b, m, 3).astype(np.float32)
    if quantize:
        # Multiples of 0.25: squared distances become exactly representable
        # sums of exact squares, so duplicate points produce *exact* ties --
        # the first-minimum tie-break must match the oracle bit for bit.
        x1 = np.round(x1 * 2.0) / 4.0
        x2 = np.round(x2 * 2.0) / 4.0
    return x1, x2


@FUZZ
@given(
    impl=st.sampled_from(["dense", "kernel"]),
    b=st.integers(1, 2),
    n=st.integers(1, 96),
    m=st.integers(1, 96),
    seed=st.integers(0, 2**16),
    quantize=st.booleans(),
)
def test_chamfer_forward_fuzz(impl, b, n, m, seed, quantize):
    x1, x2 = _clouds(b, n, m, seed, quantize)
    d1, i1, d2, i2 = _NN[impl](torch.from_numpy(x1), torch.from_numpy(x2))
    rd1, ri1, rd2, ri2 = oracles.nn_distance_np(x1, x2)
    np.testing.assert_allclose(d1.numpy(), rd1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), rd2, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i1.numpy(), ri1)
    np.testing.assert_array_equal(i2.numpy(), ri2)


@FUZZ
@given(
    impl=st.sampled_from(["dense", "kernel"]),
    n=st.integers(1, 48),
    m=st.integers(1, 48),
    seed=st.integers(0, 2**16),
)
def test_chamfer_vjp_fuzz(impl, n, m, seed):
    x1, x2 = _clouds(1, n, m, seed)
    rng = np.random.RandomState(seed + 1)
    ct1 = rng.randn(1, n).astype(np.float32)
    ct2 = rng.randn(1, m).astype(np.float32)
    a = torch.from_numpy(x1).requires_grad_()
    c = torch.from_numpy(x2).requires_grad_()
    d1, _, d2, _ = _NN[impl](a, c)
    head = (d1 * torch.from_numpy(ct1)).sum() \
        + (d2 * torch.from_numpy(ct2)).sum()
    g1, g2 = torch.autograd.grad(head, (a, c))
    _, ri1, _, ri2 = oracles.nn_distance_np(x1, x2)
    rg1, rg2 = oracles.nn_distance_grad_np(x1, x2, ri1, ri2, ct1, ct2)
    np.testing.assert_allclose(g1.numpy(), rg1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), rg2, rtol=1e-4, atol=1e-5)


@FUZZ
@given(
    n=st.integers(1, 40),
    m=st.integers(1, 40),
    seed=st.integers(0, 2**16),
)
def test_approx_match_fuzz(n, m, seed):
    x1, x2 = _clouds(1, n, m, seed)
    match = emd.approx_match(torch.from_numpy(x1),
                             torch.from_numpy(x2)).numpy()
    ref = oracles.approx_match_np(x1, x2)
    # rtol=1e-3 is the documented oracle tolerance for the annealing loop
    # (docs/RESULTS.md "Numerical parity"): 10 levels of f32 exp/sum
    # reordering between the vectorized form and numpy.
    np.testing.assert_allclose(match, ref, rtol=1e-3, atol=1e-5)
    # Transported mass is bounded by the initialized capacities.
    assert match.min() >= 0.0
    cap_l = 1 if n >= m else m // n
    assert match.sum(axis=1).max() <= cap_l + 1e-3


@FUZZ
@given(
    n=st.integers(2, 40),
    m=st.integers(2, 40),
    seed=st.integers(0, 2**16),
)
def test_emd_fused_equals_plan_path_fuzz(n, m, seed):
    x1, x2 = (torch.from_numpy(x) for x in _clouds(1, n, m, seed))
    fused = emd.emd_cost(x1, x2).numpy()
    plan = emd.match_cost(x1, x2, emd.approx_match(x1, x2)).numpy()
    np.testing.assert_allclose(fused, plan, rtol=1e-4, atol=1e-5)
