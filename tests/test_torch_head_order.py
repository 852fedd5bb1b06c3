"""The order in which K3's bf16 tensor-core kernel (csrc/fused_head.cu,
head_fwd_mma_kernel) reduces max and argmax over points, emulated in numpy
on the plain version's own activations, against head_max_plain and the
JAX package's fused_dense_bn_relu_max (impl="pallas", interpreted on the
CPU, and impl="xla").

In the kernel a warp computes every point of each 64-point tile for its
16 channels, and a thread owns the points p with p % 8 == g (its lane
group), scanned in increasing point order with a strict '>'; the 8 lane
groups combine by shuffles (xor 4, 8, 16), each combine keeping the larger
value or, at an equal value, the lower point index. The emulation must
give the plain version's first maximum bit for bit, exact ties
(duplicated points) and all-zero columns included. Against the JAX
package: values rtol 1e-5, atol 1e-5 (its own tolerance,
tests/test_fused_head.py:74), argmax equal where the maximum is clear of
the second value or exactly tied.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.ops import fused_head as jhead
from pointnet_autoencoder_tpu_torch.ops import fused_head

torch.set_num_threads(2)

GROUPS = 8  # lane groups g (lane // 4) of a warp
NO_POINT = np.iinfo(np.int32).max


def _beats(v, p, best, best_p):
    """The kernel's head_beats, elementwise."""
    return (v > best) | ((v == best) & (p < best_p))


def _mma_order_max(o):
    """(max, argmax) over axis 1 of o (B, N, F) f32 in the kernel's order."""
    b, n, f = o.shape
    best = np.full((GROUPS, b, f), -np.inf, np.float32)
    best_p = np.full((GROUPS, b, f), NO_POINT, np.int64)
    for p in range(n):  # every thread scans its own rows in point order
        g = p % GROUPS
        take = o[:, p] > best[g]  # strict '>'
        best[g] = np.where(take, o[:, p], best[g])
        best_p[g] = np.where(take, p, best_p[g])
    for bit in range(3):  # shuffles xor 4, 8, 16 flip the bits of g
        partner = np.arange(GROUPS) ^ (1 << bit)
        v, q = best[partner], best_p[partner]
        take = _beats(v, q, best, best_p)
        best, best_p = np.where(take, v, best), np.where(take, q, best_p)
    # Every lane group now holds the same result.
    assert (best == best[0]).all() and (best_p == best_p[0]).all()
    return best[0], best_p[0].astype(np.int32)


def _inputs(kind, b=2, n=200, c=16, f=128, seed=0):
    """x (B, N, C) relu'd like conv4's output, w, folded scale and shift.
    kind "random": ragged N (200 = 3 tiles + 8); "ties": the second half
    of the points copies the first (every value tied with a later point);
    "flat": channels whose every output is 0 (shift far below zero) or
    one constant (a zero weight column)."""
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(b, n, c), 0.0).astype(np.float32)
    if kind == "ties":
        x = np.concatenate([x[:, : n // 2], x[:, : n // 2]], axis=1)
    w = (0.3 * rng.randn(c, f)).astype(np.float32)
    scale = (rng.uniform(0.5, 1.5, f) * np.where(rng.rand(f) < 0.2, -1, 1)
             ).astype(np.float32)
    shift = (0.1 * rng.randn(f)).astype(np.float32)
    if kind == "flat":
        shift[::4] = -1e4  # all-zero columns: argmax is point 0
        w[:, 1::4] = 0.0  # constant columns: o = relu(shift)
        shift[1::4] = np.abs(shift[1::4]) + 0.5
    return x, w, scale, shift


def _plain_o(x, w, scale, shift):
    """The activations as head_max_plain computes them."""
    y = torch.matmul(x.float(), w.float())
    return torch.clamp_min(y * scale + shift, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,n", [("random", 200), ("random", 64),
                                    ("random", 5), ("ties", 200),
                                    ("flat", 130)])
def test_mma_order_equals_plain(kind, n, dtype):
    x, w, scale, shift = (torch.from_numpy(a) for a in _inputs(kind, n=n))
    x, w = x.to(dtype), w.to(dtype)
    val, arg = _mma_order_max(_plain_o(x, w, scale, shift).numpy())
    pval, parg = fused_head.head_max_plain(x, w, scale, shift)
    np.testing.assert_array_equal(val.view(np.int32),
                                  pval.numpy().view(np.int32))
    np.testing.assert_array_equal(arg, parg.numpy())
    if kind == "ties":  # the lower copy wins every tie
        assert arg.max() < n // 2
    if kind == "flat":
        assert np.all(val[:, ::4] == 0.0) and np.all(arg[:, ::4] == 0)
        assert np.all(val[:, 1::4] > 0.0) and np.all(arg[:, 1::4] == 0)


def test_fragment_rows_are_the_points_of_one_residue():
    """mma.m16n8k16's accumulator: lane 4g + t holds rows g and g + 8 of
    each 16-row block, so over a 64-point tile (4 blocks) a thread sees
    exactly the points p with p % 8 == g, in increasing order."""
    for g in range(GROUPS):
        rows = [16 * mi + 8 * h + g for mi in range(4) for h in range(2)]
        assert rows == sorted(rows) == list(range(g, 64, GROUPS))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["random", "ties", "flat"])
def test_mma_order_matches_jax(impl, kind):
    """The JAX head with the same folded affine: gamma = scale, beta =
    shift, mean 0, var 1 - eps and no bias give o = y * scale + shift up
    to the rounding of the fold."""
    eps = 1e-3
    x, w, scale, shift = _inputs(kind, seed=3)
    f = w.shape[1]
    val, arg = _mma_order_max(_plain_o(
        *(torch.from_numpy(a) for a in (x, w, scale, shift))).numpy())
    want, want_arg = jhead._head_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.zeros(f, jnp.float32),
        jnp.asarray(scale), jnp.asarray(shift), jnp.zeros(f, jnp.float32),
        jnp.full(f, 1.0 - eps, jnp.float32), eps, impl, True)
    want, want_arg = np.asarray(want), np.asarray(want_arg)
    np.testing.assert_allclose(val, want, rtol=1e-5, atol=1e-5)
    o = np.sort(_plain_o(*(torch.from_numpy(a) for a in (
        x, w, scale, shift))).numpy(), axis=1)
    clear = (o[:, -1] - o[:, -2]) > 1e-5 + 1e-5 * np.abs(o[:, -1])
    # Exact ties (copies, flat columns) go to the first point, as in JAX.
    tied = o[:, -1] == o[:, -2]
    assert clear.mean() > 0.9 if kind == "random" else tied.any()
    held = clear | tied
    np.testing.assert_array_equal(arg[held], want_arg[held])
