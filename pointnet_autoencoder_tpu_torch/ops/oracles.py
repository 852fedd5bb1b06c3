"""Numpy oracles for the port's kernels: the port's own copy of the JAX
package's ``ops/oracles.py``, used by ``ops/hwcheck.py`` and the tests.

Independent re-derivations of the *behaviour contracts* of the reference
ops (tf_ops/), in numpy only:

- ``nn_distance_np``: brute-force nearest-neighbour squared distances, the
  contract of the reference op registered in
  tf_ops/nn_distance/tf_nndistance.cpp:3-18 (CPU forward ``nnsearch``
  at :21-43). Squared L2, first-minimum tie-break, int32 indices.
- ``nn_distance_grad_np``: the analytic backward of that op
  (tf_ops/nn_distance/tf_nndistance_g.cu:132-151): g = 2*grad_dist*(p-q)
  added to the query point and subtracted (scatter-add) from its match,
  accumulated over both directions.
- ``approx_match_np``: the annealed soft-matching with the *GPU* kernel's
  semantics (tf_ops/approxmatch/tf_approxmatch_g.cu:1-179) -- temperature
  levels j=7..-2 (level = -4^j, final level 0), float32 arithmetic,
  three O(N*M) sweeps per level. This is the variant the reference
  actually trains with; the CPU variant (tf_approxmatch.cpp:23-84) starts
  at j=8 and runs in double precision.
- ``match_cost_np`` / ``match_cost_grad_np``: transport cost
  sum(match * ||p-q||) and its closed-form gradient with the plan held
  constant (tf_approxmatch_g.cu:183-295).
- ``fused_head_np``: the conv5 head (Dense, BatchNorm, ReLU, max over
  points) in float64; ``fscore_np``: the F-score from ``nn_distance_np``.

Everything here is slow, simple and dimension-agnostic on purpose: it is
the ground truth the kernels and their plain PyTorch versions are held to,
as the reference keeps tf_nndistance_cpu.py next to its CUDA op. The same
inputs give the same bits as the JAX package's copy
(``tests/test_torch_hwcheck.py``).
"""

from __future__ import annotations

import numpy as np


def nn_distance_np(xyz1: np.ndarray, xyz2: np.ndarray):
    """Brute-force Chamfer components. xyz1 (B,N,3), xyz2 (B,M,3) float.

    Returns (dist1 (B,N) f32 squared, idx1 (B,N) i32, dist2 (B,M) f32,
    idx2 (B,M) i32). First minimum wins ties (argmin semantics).
    """
    xyz1 = np.asarray(xyz1, dtype=np.float32)
    xyz2 = np.asarray(xyz2, dtype=np.float32)
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    dist1 = np.zeros((b, n), dtype=np.float32)
    idx1 = np.zeros((b, n), dtype=np.int32)
    dist2 = np.zeros((b, m), dtype=np.float32)
    idx2 = np.zeros((b, m), dtype=np.int32)
    for i in range(b):
        d2 = ((xyz1[i][:, None, :] - xyz2[i][None, :, :]) ** 2).sum(-1)
        dist1[i] = d2.min(axis=1)
        idx1[i] = d2.argmin(axis=1)
        dist2[i] = d2.min(axis=0)
        idx2[i] = d2.argmin(axis=0)
    return dist1, idx1, dist2, idx2


def nn_distance_grad_np(xyz1, xyz2, idx1, idx2, grad_dist1, grad_dist2):
    """Analytic VJP of nn_distance wrt (xyz1, xyz2).

    Per direction-1 element k: g = 2 * grad_dist1[k] * (xyz1[k] - xyz2[idx1[k]])
    accumulates +g into grad_xyz1[k] and -g into grad_xyz2[idx1[k]]; symmetric
    for direction 2.
    """
    xyz1 = np.asarray(xyz1, dtype=np.float32)
    xyz2 = np.asarray(xyz2, dtype=np.float32)
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    g1 = np.zeros_like(xyz1)
    g2 = np.zeros_like(xyz2)
    for i in range(b):
        for k in range(n):
            j = idx1[i, k]
            g = 2.0 * grad_dist1[i, k] * (xyz1[i, k] - xyz2[i, j])
            g1[i, k] += g
            g2[i, j] -= g
        for l in range(m):
            j = idx2[i, l]
            g = 2.0 * grad_dist2[i, l] * (xyz2[i, l] - xyz1[i, j])
            g2[i, l] += g
            g1[i, j] -= g
    return g1, g2


def approx_match_np(xyz1: np.ndarray, xyz2: np.ndarray) -> np.ndarray:
    """Annealed soft matching, GPU-kernel semantics, vectorized numpy.

    xyz1 (B,N,3), xyz2 (B,M,3) -> match (B,M,N) f32, where match[b,l,k] is
    transported mass between xyz2 point l and xyz1 point k.

    Capacity factors use integer division of max(n,m) by n/m
    (tf_approxmatch_g.cu:4-11), so unequal cloud sizes are supported.
    """
    xyz1 = np.asarray(xyz1, dtype=np.float32)
    xyz2 = np.asarray(xyz2, dtype=np.float32)
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l = np.float32(1 if n >= m else m // n)
    multi_r = np.float32(n // m if n >= m else 1)

    match = np.zeros((b, m, n), dtype=np.float32)
    for i in range(b):
        d2 = ((xyz1[i][:, None, :] - xyz2[i][None, :, :]) ** 2).sum(-1)
        d2 = d2.astype(np.float32)  # (N, M)
        remain_l = np.full((n,), multi_l, dtype=np.float32)
        remain_r = np.full((m,), multi_r, dtype=np.float32)
        for j in range(7, -3, -1):
            level = np.float32(0.0 if j == -2 else -(4.0**j))
            k_mat = np.exp(level * d2, dtype=np.float32)  # (N, M)
            # Sweep 1: row normalizers.
            suml = np.float32(1e-9) + (k_mat * remain_r[None, :]).sum(
                axis=1, dtype=np.float32
            )
            ratio_l = remain_l / suml  # (N,)
            # Sweep 2: column saturation.
            sumr = (k_mat * ratio_l[:, None]).sum(axis=0, dtype=np.float32)
            sumr = sumr * remain_r
            consumption = np.minimum(remain_r / (sumr + np.float32(1e-9)), 1.0)
            ratio_r = (consumption * remain_r).astype(np.float32)
            remain_r = np.maximum(0.0, remain_r - sumr).astype(np.float32)
            # Sweep 3: accumulate transported mass.
            w = k_mat * ratio_l[:, None] * ratio_r[None, :]  # (N, M)
            match[i] += w.T
            suml3 = w.sum(axis=1, dtype=np.float32)
            remain_l = np.maximum(0.0, remain_l - suml3).astype(np.float32)
    return match


def match_cost_np(xyz1, xyz2, match) -> np.ndarray:
    """cost[b] = sum_{k,l} ||xyz1[k]-xyz2[l]|| * match[l,k]  (true distance)."""
    xyz1 = np.asarray(xyz1, dtype=np.float32)
    xyz2 = np.asarray(xyz2, dtype=np.float32)
    b = xyz1.shape[0]
    out = np.zeros((b,), dtype=np.float32)
    for i in range(b):
        d = np.sqrt(((xyz1[i][:, None, :] - xyz2[i][None, :, :]) ** 2).sum(-1))
        out[i] = (d * match[i].T).sum(dtype=np.float32)
    return out


def match_cost_grad_np(xyz1, xyz2, match):
    """Closed-form grad of match_cost wrt (xyz1, xyz2), plan held constant.

    grad1[k] = sum_l match[l,k] * (xyz1[k]-xyz2[l]) / max(||.||, tiny)
    grad2[l] = sum_k match[l,k] * (xyz2[l]-xyz1[k]) / max(||.||, tiny)
    with the clamp applied to the squared distance as in
    tf_approxmatch_g.cu:244,282 (rsqrt(max(d2, 1e-20))).
    """
    xyz1 = np.asarray(xyz1, dtype=np.float32)
    xyz2 = np.asarray(xyz2, dtype=np.float32)
    b = xyz1.shape[0]
    g1 = np.zeros_like(xyz1)
    g2 = np.zeros_like(xyz2)
    for i in range(b):
        diff = xyz1[i][:, None, :] - xyz2[i][None, :, :]  # (N,M,3)
        d2 = (diff**2).sum(-1)
        rinv = 1.0 / np.sqrt(np.maximum(d2, 1e-20))
        w = match[i].T * rinv  # (N,M)
        g1[i] = (w[:, :, None] * diff).sum(axis=1)
        g2[i] = -(w[:, :, None] * diff).sum(axis=0)
    return g1.astype(np.float32), g2.astype(np.float32)


def fused_head_np(x, w, b, gamma, beta, mean, var, eps=1e-3):
    """Oracle for ops/fused_head.fused_dense_bn_relu_max: max over the
    point axis of relu(batchnorm(x @ w + b)) with externally supplied
    statistics, plus the argmax (first-maximum tie-break) the backward
    keys on. Same composition the reference builds from tf_util.conv2d +
    batch_norm + relu + max-pool (models/model.py:58-64), in float64 for
    a precision margin over the f32 device paths.

    Returns (maxout (B, F), argmax (B, F) int32).
    """
    x64 = np.asarray(x, np.float64)
    y = x64 @ np.asarray(w, np.float64) + np.asarray(b, np.float64)
    inv = 1.0 / np.sqrt(np.asarray(var, np.float64) + eps)
    o = np.asarray(gamma, np.float64) * (y - np.asarray(mean, np.float64)) \
        * inv + np.asarray(beta, np.float64)
    o = np.maximum(o, 0.0)
    return o.max(axis=1), o.argmax(axis=1).astype(np.int32)


def fscore_np(pred: np.ndarray, target: np.ndarray,
              threshold: float) -> np.ndarray:
    """Oracle for ops/chamfer.py:fscore — precision/recall of
    nearest-neighbor membership at ``threshold`` (true distance; the
    squared distances from nn_distance_np compare against threshold**2),
    harmonic-mean combined per shape. Returns (B,) f32."""
    d1, _, d2, _ = nn_distance_np(pred, target)
    t2 = float(threshold) ** 2
    precision = (d1 < t2).mean(axis=1)
    recall = (d2 < t2).mean(axis=1)
    denom = np.maximum(precision + recall, 1e-12)
    return (2.0 * precision * recall / denom).astype(np.float32)
