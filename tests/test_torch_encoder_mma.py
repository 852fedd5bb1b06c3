"""K5's bf16 route (csrc/fused_encoder.cu, encoder_mma_kernel) emulated in
numpy, against encoder_extrema_plain and the JAX package's
fused_encoder_eval (bf16, run interpreted on the CPU); and the chain's
kernel layout.

The kernel runs conv1 (K=3) as three fmaf per output, as the f32 route
does, and conv2-5 on the tensor cores: mma.sync m16n8k16 adds each k16
step's products into the f32 accumulator, so each output is summed in
16-channel chunks, in another f32 order than the plain version's matmul.
bf16 products are exact in f32, so the order is the only difference; it
can flip one bf16 rounding of an inner activation, which the next layers
carry. The emulation sums each chunk in float64, rounds it to f32 and adds
the chunks in order in f32; it must stay within TOL["bf16"] of chip_smoke.py
(rtol 3e-2, atol 3e-2, the JAX package's own bf16 tolerance,
tests/test_fused_encoder.py) of both references. That is the tolerance at
which the kernel is held on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.ops import fused_encoder as jfe
from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe

torch.set_num_threads(2)

EPS = 1e-3
TOL = dict(rtol=3e-2, atol=3e-2)


def _layers(seed):
    """Glorot-scale weights and BN statistics with about a quarter of the
    gammas negative (the min branch of the last fold), as chip_smoke.py
    draws them."""
    rng = np.random.RandomState(seed)
    layers, widths = [], fe.KERNEL_WIDTHS
    for c, f in zip(widths[:-1], widths[1:]):
        a = np.sqrt(6.0 / (c + f))
        gamma = rng.uniform(0.5, 1.5, f) * np.where(rng.rand(f) < 0.25, -1, 1)
        layers.append(tuple(np.asarray(x, np.float32) for x in (
            rng.uniform(-a, a, (c, f)), 0.1 * rng.randn(f), gamma,
            0.1 * rng.randn(f), 0.1 * rng.randn(f),
            rng.uniform(0.5, 1.5, f))))
    return layers


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float(
        ).numpy()


def _chunked_matmul(x, w):
    """x (P, C) @ w (C, F), f32 sums of float64 16-channel chunk sums."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], 16):
        part = x[:, k0:k0 + 16].astype(np.float64) @ w[k0:k0 + 16].astype(
            np.float64)
        acc = acc + part.astype(np.float32)
    return acc


def _mma_route_extrema(points, chain):
    """(max, min) over points of raw conv5, (B, 1024) f32, in the kernel's
    order."""
    b, n, _ = points.shape
    x = _bf16(points.reshape(b * n, 3))
    w = [t.float().numpy() for t in chain.weights]
    acc = np.zeros((b * n, w[0].shape[1]), np.float32)
    for c in range(3):  # fmaf(x_c, w_c, acc): the product is exact
        acc = (x[:, c:c + 1].astype(np.float64) * w[0][c]
               + acc).astype(np.float32)
    for i in range(len(w)):
        if i:
            acc = _chunked_matmul(x, w[i])
        if i == len(w) - 1:
            break
        scale, shift = (t.numpy() for t in chain.inner_rows(i))
        x = _bf16(np.maximum((acc * scale).astype(np.float32) + shift, 0.0))
    y = acc.reshape(b, n, -1)
    return torch.from_numpy(y.max(axis=1)), torch.from_numpy(y.min(axis=1))


def _chain(seed):
    return fe.fold_layers([tuple(map(torch.from_numpy, lay))
                           for lay in _layers(seed)], eps=EPS,
                          dtype=torch.bfloat16)


@pytest.mark.parametrize("b,n", [(2, 64), (3, 37), (1, 300)])
def test_mma_order_within_bf16_tolerance_of_plain(b, n):
    chain = _chain(seed=b + n)
    pts = torch.from_numpy(np.random.RandomState(n).randn(b, n, 3).astype(
        np.float32) * 0.5)
    got = _mma_route_extrema(pts, chain)
    want = fe.encoder_extrema_plain(pts, chain)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    np.testing.assert_allclose(fe._finish(chain, *got).numpy(),
                               fe.fused_encoder_eval(pts, chain).numpy(),
                               **TOL)


def test_mma_order_within_bf16_tolerance_of_jax_kernel():
    layers = _layers(seed=11)
    chain = _chain(seed=11)
    pts = (0.5 * np.random.RandomState(12).randn(2, 64, 3)).astype(
        np.float32)
    want = jfe.fused_encoder_eval(
        jnp.asarray(pts), [tuple(map(jnp.asarray, lay)) for lay in layers],
        eps=EPS, dtype=jnp.bfloat16, interpret=True)
    got = fe._finish(chain, *_mma_route_extrema(torch.from_numpy(pts), chain))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


def test_bf16_chain_holds_the_transposed_weights():
    chain = _chain(seed=3)
    assert len(chain.transposed) == len(chain.weights) - 1
    for wt, w in zip(chain.transposed, chain.weights[1:]):
        assert wt.dtype == torch.bfloat16 and wt.is_contiguous()
        assert wt.shape == (w.shape[1], w.shape[0])
        assert torch.equal(wt, w.t())
    f32 = fe.fold_layers([tuple(map(torch.from_numpy, lay))
                          for lay in _layers(seed=3)], eps=EPS)
    assert f32.transposed == ()
