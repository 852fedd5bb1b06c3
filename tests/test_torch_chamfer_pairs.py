"""The order in which K1's kernel (csrc/chamfer.cu, nn_distance_kernel and
nn_distance_cols_kernel) finds both directions' nearest neighbours from
one d2 per pair, emulated in numpy, against nn_distance_plain (bit for
bit) and the JAX package's nn_distance (dense XLA and the Pallas kernel
interpreted on the CPU; distances rtol 1e-6, indices exactly equal, as
tests/test_torch_chamfer.py holds the port).

In the kernel a block owns 256 queries of xyz1 (lane l of every warp
holds queries l + 32i, i < 8) and its 8 warps split xyz2 into chunks of
16 candidates (warp w takes chunks w, w+8, ...), points past N and M being
NaN. Per pair one d2 = ((dx*dx + dy*dy) + dz*dz), dx = xyz1 - xyz2:
- a query keeps its running minimum over the warp's candidates in
  increasing index (strict '<', from (inf, 0)); the 8 warps' results
  combine as 64-bit keys (bits of d2 << 32 | index), the smallest wins;
- a candidate gets the minimum over the lane's 8 queries (the first query,
  then strict '<'), then a butterfly over the lanes (xor 8, 4, 2, 1, each
  lane keeping the half whose bit matches its own, then xor 16) leaves
  lanes l and l + 16 with candidate l's smallest key over the block's
  queries; a second kernel takes each candidate's smallest key over the
  query tiles.
"""

import jax
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.ops import chamfer as jchamfer
from pointnet_autoencoder_tpu_torch.ops import chamfer

torch.set_num_threads(2)

LANES = 32
QUERIES = 8  # per lane
WARPS = 8
TILE_Q = LANES * QUERIES
CHUNK = 16


def _key(d2, idx):
    """uint64 keys (bits of d2 << 32 | idx) of f32 d2 and int idx."""
    bits = np.asarray(d2, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | np.asarray(idx).astype(np.uint64)


def _unkey(key):
    d2 = (key >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return d2, (key & np.uint64(0xFFFFFFFF)).astype(np.int32)


def _butterfly(cd):
    """(32 lanes, 16 candidates) keys -> (32,): lane l's key after the
    kernel's five exchange steps (position 0 of each lane)."""
    lanes = np.arange(LANES)
    s = CHUNK // 2
    while s >= 1:
        upper = ((lanes & s) != 0)[:, None]
        keep = np.where(upper, cd[:, s:2 * s], cd[:, :s])
        send = np.where(upper, cd[:, :s], cd[:, s:2 * s])
        cd = np.minimum(keep, send[lanes ^ s])
        s //= 2
    return np.minimum(cd[:, 0], cd[lanes ^ CHUNK, 0])


def _pair_order_nn(x1, x2):
    """numpy emulation of the kernel: (dist1, idx1, dist2, idx2)."""
    b, n, _ = x1.shape
    m = x2.shape[1]
    tiles = -(-n // TILE_Q)
    chunks = -(-m // CHUNK)
    nan = np.float32(np.nan)
    q = np.full((b, tiles * TILE_Q, 3), nan, np.float32)
    q[:, :n] = x1
    c = np.full((b, chunks * CHUNK, 3), nan, np.float32)
    c[:, :m] = x2
    with np.errstate(invalid="ignore"):
        diff = [q[:, :, None, k] - c[:, None, :, k] for k in range(3)]
        d2 = (diff[0] * diff[0] + diff[1] * diff[1]) + diff[2] * diff[2]
    dist1 = np.empty((b, n), np.float32)
    idx1 = np.empty((b, n), np.int32)
    part = np.empty((b, tiles, m), np.uint64)
    qpos = np.arange(TILE_Q).reshape(QUERIES, LANES)  # [i, lane]
    for bb in range(b):
        for t in range(tiles):
            q0 = t * TILE_Q
            rows = d2[bb, q0:q0 + TILE_Q]  # (256, chunks * 16)
            row_keys = []
            for w in range(WARPS):
                best = np.full(TILE_Q, np.inf, np.float32)
                best_j = np.zeros(TILE_Q, np.int64)
                for ch in range(w, chunks, WARPS):
                    for j in range(ch * CHUNK, (ch + 1) * CHUNK):
                        take = rows[:, j] < best
                        best = np.where(take, rows[:, j], best)
                        best_j = np.where(take, j, best_j)
                    blk = rows[qpos, ch * CHUNK:(ch + 1) * CHUNK]
                    # blk[i, lane, jj]: the lane's 8 queries in order.
                    cd, ci = blk[0], np.zeros((LANES, CHUNK), np.int64)
                    for i in range(1, QUERIES):
                        take = blk[i] < cd
                        cd = np.where(take, blk[i], cd)
                        ci = np.where(take, i, ci)
                    qi = q0 + LANES * ci + np.arange(LANES)[:, None]
                    got = _butterfly(_key(cd, qi))[:CHUNK]  # lanes < 16
                    js = ch * CHUNK + np.arange(CHUNK)
                    ok = js < m
                    part[bb, t, js[ok]] = got[ok]
                row_keys.append(_key(best, best_j))
            keys = np.minimum.reduce(row_keys)
            valid = min(TILE_Q, n - q0)
            dist1[bb, q0:q0 + valid], idx1[bb, q0:q0 + valid] = _unkey(
                keys[:valid])
    dist2, idx2 = _unkey(np.minimum.reduce(part, axis=1))
    return dist1, idx1, dist2, idx2


def _clouds(b, n, m, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3).astype(np.float32),
            rng.randn(b, m, 3).astype(np.float32))


def _case(kind):
    """random: 2 query tiles (N=300 ragged), a ragged chunk (M=200);
    tiny: N=37, M=5 (seven warps without candidates); tiles: N=600 (three
    tiles combined per column), M=70; dup: every target twice (lower index
    first) and queries copying targets (zero-distance ties); crowd: many
    queries near few targets and one far target no query picks."""
    rng = np.random.RandomState(4)
    if kind == "random":
        return _clouds(2, 300, 200)
    if kind == "tiny":
        return _clouds(1, 37, 5, seed=1)
    if kind == "tiles":
        return _clouds(2, 600, 70, seed=2)
    if kind == "dup":
        half = rng.randn(2, 100, 3).astype(np.float32)
        x2 = np.concatenate([half, half], axis=1)
        x1 = np.concatenate([half[:, ::3], half[:, 1::5],
                             rng.randn(2, 250, 3).astype(np.float32)], axis=1)
        return x1, x2
    centers = rng.randn(2, 5, 3).astype(np.float32)
    centers[:, 4] = 100.0
    x1 = (centers[:, :4].repeat(80, axis=1)
          + 1e-2 * rng.randn(2, 320, 3)).astype(np.float32)
    return x1, centers


KINDS = ["random", "tiny", "tiles", "dup", "crowd"]


@pytest.mark.parametrize("kind", KINDS)
def test_pair_order_equals_plain_bit_for_bit(kind):
    x1, x2 = _case(kind)
    got = _pair_order_nn(x1, x2)
    want = [t.numpy() for t in chamfer.nn_distance_plain(
        torch.from_numpy(x1), torch.from_numpy(x2))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    if kind == "dup":  # copies sit at 0 and resolve to the lower index
        np.testing.assert_array_equal(got[0][:, :34], 0.0)
        assert np.all(got[1][:, :34] < 100)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["random", "dup"])
def test_pair_order_matches_jax(impl, kind):
    x1, x2 = _case(kind)
    got = _pair_order_nn(x1, x2)
    want = [np.asarray(w) for w in jax.jit(
        lambda a, c: jchamfer.nn_distance(a, c, impl=impl))(x1, x2)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])


def test_key_order_is_distance_then_index_order():
    """For d2 >= +0 (subnormal, normal, large, inf) the unsigned order of
    the keys is the (d2, index) order; NaN, a point past N or M, orders
    above everything."""
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    d = np.array([0.0, tiny, 2 * tiny, np.finfo(np.float32).tiny, 1e-30,
                  0.5, 1.0, 1.0, 3e38, np.inf, np.inf, 0.0, tiny],
                 np.float32)
    i = np.array([5, 2, 0, 7, 1, 3, 9, 4, 6, 8, 1, 2, 2**31 - 1])
    by_key = np.argsort(_key(d, i), kind="stable")
    by_pair = np.lexsort((i, d))
    np.testing.assert_array_equal(by_key, by_pair)
    nan = _key(np.float32(np.nan), 0)
    assert nan > _key(np.float32(np.inf), 2**31 - 1)
    # A d2 can be +0 but never -0: squares and sums of +0 are +0.
    z = np.float32(-0.0)
    assert (z * z + z * z).view(np.uint32) == 0


def test_butterfly_leaves_each_lane_its_candidate():
    """After the exchanges lanes l and l + 16 hold the smallest of
    column l."""
    rng = np.random.RandomState(6)
    cd = rng.randint(0, 2**40, size=(LANES, CHUNK)).astype(np.uint64)
    got = _butterfly(cd)
    np.testing.assert_array_equal(got[:CHUNK], cd.min(axis=0))
    np.testing.assert_array_equal(got[CHUNK:], cd.min(axis=0))
