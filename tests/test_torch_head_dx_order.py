"""The order in which K4's dx kernel (csrc/fused_head.cu,
head_bwd_dx_kernel) sums, emulated in numpy, against head_bwd_plain bit
for bit, and head_bwd_plain against the JAX package's head backward
(_backward_pallas run interpreted on the CPU, and the xla branch).

The kernel gives each block a chunk of ROWS rows of one batch element. The
block counts the channels f whose argmax row lies in its chunk per row,
and places them in one bucket per row, stable in f (rounds of 256
channels, each after the earlier rounds); each row's value is ((0 + p_f1)
+ p_f2) + ... over its bucket, with p_f = gy_f * w[:, f] in f32 and gy the
gvals rounded to the matmul type; rows with no channel are 0.
head_bwd_plain adds the same products with index_add_, which on the CPU
adds in index order: both give the same bits. Against the JAX package:
the tolerances of tests/test_torch_fused_head.py (f32 rtol 1e-4, atol
1e-5; bf16 2e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.ops import fused_head as jhead
from pointnet_autoencoder_tpu_torch.ops import fused_head

torch.set_num_threads(2)

ROWS = 128  # rows of dx per block (kDxRows)
ROUND = 256  # channels per placement round (kDxThreads)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _kernel_order_dx(w, gvals, argmax, n, dtype):
    """dx (B, N, C) in ``dtype`` as the kernel sums it."""
    b, f = argmax.shape
    c = w.shape[0]
    gy = gvals.to(dtype).float().numpy()
    wt = w.float().numpy().T  # (F, C): one channel's weights per row
    arg = argmax.numpy()
    dx = np.zeros((b, n, c), np.float32)
    for bi in range(b):
        for r0 in range(0, n, ROWS):
            rows = min(ROWS, n - r0)
            ks = [int(arg[bi, fi]) - r0 for fi in range(f)]
            count = np.zeros(rows, np.int64)
            for k in ks:
                if 0 <= k < rows:
                    count[k] += 1
            start = np.concatenate([[0], np.cumsum(count)])
            fill = np.zeros(rows, np.int64)
            bucket = np.zeros(start[-1], np.int64)
            for f0 in range(0, f, ROUND):  # rounds in order, lanes in order
                for fi in range(f0, min(f0 + ROUND, f)):
                    k = ks[fi]
                    if 0 <= k < rows:
                        bucket[start[k] + fill[k]] = fi
                        fill[k] += 1
            for k in range(rows):
                acc = np.zeros(c, np.float32)  # +0
                for fi in bucket[start[k]:start[k + 1]]:
                    acc = acc + np.float32(gy[bi, fi]) * wt[fi]
                dx[bi, r0 + k] = acc
    return torch.from_numpy(dx).to(dtype)


def _inputs(kind, b=2, n=300, c=128, f=512, seed=0):
    """x (B, N, C), w (C, F), gvals (B, F) f32, argmax (B, F) int32.
    N = 300 is not a multiple of ROWS. kinds: "random"; "shared" (half the
    channels on row 5, a quarter on row 130 of the next chunk); "gy0"
    (every third gvals entry 0, and entries that round to 0 in bf16);
    "last" (many channels on the last row); every kind leaves rows with no
    channel (F < B N)."""
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(b, n, c), 0.0).astype(np.float32)
    w = (0.05 * rng.randn(c, f)).astype(np.float32)
    g = (1e-3 * rng.randn(b, f)).astype(np.float32)
    arg = rng.randint(0, n, (b, f))
    if kind == "shared":
        arg[:, ::2] = 5
        arg[:, 1::4] = 130
    elif kind == "gy0":
        g[:, ::3] = 0.0
        g[:, 1::7] = 1e-42  # a subnormal: 0 once rounded to bf16
        arg[:, ::5] = arg[:, 0:1]
    elif kind == "last":
        arg[:, ::3] = n - 1
    return (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g),
            torch.from_numpy(arg.astype(np.int32)))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["random", "shared", "gy0", "last"])
def test_kernel_order_equals_plain_bit_for_bit(kind, dtype):
    x, w, g, arg = _inputs(kind)
    dt = DTYPES[dtype]
    x, w = x.to(dt), w.to(dt)
    dx, _ = fused_head.head_bwd_plain(x, w, g, arg)
    want = _kernel_order_dx(w, g, arg, x.shape[1], dt)
    assert dx.dtype == dt and dx.shape == x.shape
    assert torch.equal(_bits(dx), _bits(want))
    # Rows no channel points at are exactly +0.
    hit = np.zeros(x.shape[:2], bool)
    for bi in range(x.shape[0]):
        hit[bi, arg[bi].numpy()] = True
    assert (~hit).any() and not _bits(dx)[torch.from_numpy(~hit)].any()
    if kind == "shared":  # many channels on one row: sums of many terms
        assert int((arg[0] == 5).sum()) >= 256


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_order_at_ragged_and_tiny_shapes(dtype):
    """One partial chunk (N < ROWS) and F of a single placement round."""
    x, w, g, arg = _inputs("random", b=3, n=37, c=128, f=256, seed=4)
    dt = DTYPES[dtype]
    x, w = x.to(dt), w.to(dt)
    dx, _ = fused_head.head_bwd_plain(x, w, g, arg)
    want = _kernel_order_dx(w, g, arg, 37, dt)
    assert torch.equal(_bits(dx), _bits(want))


def _jax_backward(x, w, g, arg, impl, jdt):
    """dx, dw of the JAX head backward with gvals = g: gamma 1, var
    1 - eps (scale 1) and every max alive."""
    eps = 1e-3
    f = w.shape[1]
    xj = jnp.asarray(x.float().numpy(), jdt)
    wj = jnp.asarray(w.float().numpy(), jdt)
    zero = jnp.zeros(f, jnp.float32)
    res = (xj, wj, zero, jnp.ones(f, jnp.float32), zero, zero,
           jnp.full(f, 1.0 - eps, jnp.float32),
           jnp.ones((x.shape[0], f), jnp.float32), jnp.asarray(arg.numpy()))
    dx, dw = jhead._head_max_bwd(eps, impl, True, res,
                                 jnp.asarray(g.numpy()))[:2]
    return np.asarray(dx, np.float32), np.asarray(dw, np.float32)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jax_backward(impl, dtype):
    x, w, g, arg = _inputs("shared", b=2, n=64, c=128, f=256, seed=6)
    arg = arg % 64
    dt = DTYPES[dtype]
    x, w = x.to(dt), w.to(dt)
    dx, dw = fused_head.head_bwd_plain(x, w, g, arg)
    want_dx, want_dw = _jax_backward(
        x, w, g, arg, impl, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "f32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(dx.float().numpy(), want_dx, **tol)
    np.testing.assert_allclose(dw.numpy(), want_dw, **tol)
