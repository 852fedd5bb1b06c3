"""Approximate Earth Mover's distance: the annealed matching, its transport
cost and the cost's gradients with the plan held constant.

Counterpart of ``pointnet_autoencoder_tpu/ops/emd.py``, with the reference
GPU op's schedule: 10 levels, j = 7..-2, level = -4^j and the last level 0,
K = exp(level * d2), and integer capacity factors (multiL = M // N or 1,
multiR = N // M or 1). Per level:

  row normalize:   ratioL_k = remainL_k / (1e-9 + sum_l K_kl remainR_l)
  column saturate: sumr_l = (sum_k K_kl ratioL_k) remainR_l,
                   ratioR_l = min(remainR_l / (sumr_l + 1e-9), 1) remainR_l,
                   remainR_l = max(0, remainR_l - sumr_l)
  move mass:       w_kl = K_kl ratioL_k ratioR_l,
                   remainL_k = max(0, remainL_k - sum_l w_kl)

- Plan-based, plain PyTorch: ``approx_match`` (no gradient, (B, M, N)),
  ``match_cost`` (closed-form backward, plan constant) and
  ``emd_loss_via_match``.
- ``earth_mover``: PCN's EMD loss (``models/pcn_emd.py``), the cost of
  its first cloud against its second over the points, averaged over the
  batch.
- Fused, plan-free: ``emd_cost`` folds the moved mass into the cost and
  both gradients level by level. On CUDA tensors it runs the kernel of
  ``csrc/emd.cu`` (``emd_forward_cuda``) for every shape, or raises. On
  CPU tensors it runs ``emd_forward_plain``, the dense (B, N, M) scan and
  the kernel's plain version, or ``emd_forward_chunked``, which streams
  row chunks past ``_DENSE_BYTES_LIMIT``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from pointnet_autoencoder_tpu_torch.csrc import build as _build
from pointnet_autoencoder_tpu_torch.ops.chamfer import _prepare, sqdist_matrix
from pointnet_autoencoder_tpu_torch.utils import roofline

Tensor = torch.Tensor
# cost (B,), grad1 (B, N, 3), grad2 (B, M, 3)
Forward = Tuple[Tensor, Tensor, Tensor]

_LEVELS = tuple(0.0 if j == -2 else -(4.0 ** j) for j in range(7, -3, -1))

# One (B, N, M) f32 buffer past this streams in row chunks instead: the
# dense scan keeps about six such buffers live.
_DENSE_BYTES_LIMIT = 1 << 30

# C entry point of csrc/emd.cu: (argtypes, restype).
_SIGNATURES = {
    "pcae_emd_forward": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        ctypes.c_int),
}


def _capacities(n: int, m: int) -> Tuple[float, float]:
    """(multiL, multiR), by integer division (tf_approxmatch_g.cu:4-11)."""
    if n >= m:
        return 1.0, float(n // m)
    return float(m // n), 1.0


ColumnReduce = Optional[Callable[[Tensor], Tensor]]


def _level_weights(k: Tensor, remain_l: Tensor, remain_r: Tensor,
                   reduce_columns: ColumnReduce = None):
    """One level's row normalizers and column saturation from K (B, N, M):
    (ratioL (B, N), ratioR (B, M), the new remainR). ``reduce_columns``,
    if given, completes the (B, M) column sums over K's rows in place
    (the point-sharded EMD sums them over the ranks that hold the rows)."""
    suml = 1e-9 + torch.einsum("bnm,bm->bn", k, remain_r)
    ratio_l = remain_l / suml
    colsum = torch.einsum("bnm,bn->bm", k, ratio_l)
    if reduce_columns is not None:
        reduce_columns(colsum)
    sumr = colsum * remain_r
    ratio_r = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0) * remain_r
    return ratio_l, ratio_r, torch.clamp_min(remain_r - sumr, 0.0)


def _init_remains(xyz1: Tensor, xyz2: Tensor,
                  n_total: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Initial (remainL (B, N), remainR (B, M)): the capacities, from
    ``n_total`` points in xyz1's cloud (default its own N; the
    point-sharded EMD holds N/k rows of an N-point cloud)."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = _capacities(n if n_total is None else n_total, m)
    return xyz1.new_full((b, n), multi_l), xyz1.new_full((b, m), multi_r)


# ---------------------------------------------------------------------------
# Plan-based functions
# ---------------------------------------------------------------------------


@torch.no_grad()
def approx_match(xyz1: Tensor, xyz2: Tensor) -> Tensor:
    """Soft transport plan of xyz1 (B, N, 3) against xyz2 (B, M, 3):
    (B, M, N) f32, row l and column k the mass moved between xyz2 point l
    and xyz1 point k. Carries no gradient, as the reference op."""
    x1, x2 = _prepare(xyz1, xyz2)
    d2 = sqdist_matrix(x1, x2)
    remain_l, remain_r = _init_remains(x1, x2)
    match = torch.zeros_like(d2)
    for level in _LEVELS:
        k = torch.exp(level * d2)
        ratio_l, ratio_r, remain_r = _level_weights(k, remain_l, remain_r)
        w = k * ratio_l[:, :, None] * ratio_r[:, None, :]
        match += w
        remain_l = torch.clamp_min(remain_l - w.sum(dim=2), 0.0)
    return match.transpose(1, 2)


class _MatchCost(torch.autograd.Function):
    """sum_{k,l} ||xyz1_k - xyz2_l|| match[l, k] per batch element; the
    backward is the closed form with rsqrt(max(d2, 1e-20)) (emd.py:131-148)
    and gives the plan no gradient."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, match):
        ctx.save_for_backward(xyz1, xyz2, match)
        d = torch.sqrt(sqdist_matrix(xyz1, xyz2))
        return torch.einsum("bnm,bmn->b", d, match)

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, match = ctx.saved_tensors
        rinv = torch.rsqrt(torch.clamp_min(sqdist_matrix(xyz1, xyz2), 1e-20))
        w = match.transpose(1, 2) * rinv  # (B, N, M)
        g1 = torch.empty_like(xyz1)
        g2 = torch.empty_like(xyz2)
        for c in range(3):
            wd = w * (xyz1[:, :, None, c] - xyz2[:, None, :, c])
            g1[:, :, c] = wd.sum(dim=2)
            g2[:, :, c] = -wd.sum(dim=1)
        return g1 * g[:, None, None], g2 * g[:, None, None], None


def match_cost(xyz1: Tensor, xyz2: Tensor, match: Tensor) -> Tensor:
    """Transport cost (B,) f32 of the plan ``match`` (B, M, N).
    Differentiable in both clouds; the plan is held constant."""
    x1, x2 = _prepare(xyz1, xyz2)
    return _MatchCost.apply(x1, x2, match.detach().float())


# ---------------------------------------------------------------------------
# Fused forward: cost and plan-constant gradients, no plan
# ---------------------------------------------------------------------------


def emd_forward_plain(xyz1: Tensor, xyz2: Tensor,
                      reduce_columns: ColumnReduce = None,
                      n_total: Optional[int] = None) -> Forward:
    """Plain PyTorch version of the kernel, the dense scan of
    ``_emd_forward`` (emd.py:177-225): (B,N,3), (B,M,3) f32 -> cost (B,),
    grad1 (B,N,3), grad2 (B,M,3) f32, the gradients of the cost with the
    plan held constant. Keeps about six (B, N, M) f32 buffers live.

    ``reduce_columns`` and ``n_total`` make it the per-rank body of the
    point-sharded EMD (``parallel/sp.py``): xyz1 is then a rank's rows of
    an ``n_total``-point cloud, each level's column sums are completed
    over the ranks, and cost and grad2 are this rank's rows' shares."""
    d2 = sqdist_matrix(xyz1, xyz2)
    d = torch.sqrt(d2)
    rinv = torch.rsqrt(torch.clamp_min(d2, 1e-20))
    remain_l, remain_r = _init_remains(xyz1, xyz2, n_total)
    cost = xyz1.new_zeros(xyz1.shape[0])
    grad1 = torch.zeros_like(xyz1)
    grad2 = torch.zeros_like(xyz2)
    for level in _LEVELS:
        k = torch.exp(level * d2)
        ratio_l, ratio_r, remain_r = _level_weights(k, remain_l, remain_r,
                                                    reduce_columns)
        w = k * ratio_l[:, :, None] * ratio_r[:, None, :]
        remain_l = torch.clamp_min(remain_l - w.sum(dim=2), 0.0)
        cost = cost + torch.einsum("bnm,bnm->b", w, d)
        wr = w * rinv
        for c in range(3):
            wd = wr * (xyz1[:, :, None, c] - xyz2[:, None, :, c])
            grad1[:, :, c] += wd.sum(dim=2)
            grad2[:, :, c] -= wd.sum(dim=1)
    return cost, grad1, grad2


def _pick_row_chunk(b: int, n: int, m: int,
                    budget_bytes: int = 256 * 1024 * 1024) -> int:
    """Rows per chunk of the streaming form: the most whose (B, chunk, M)
    f32 buffer fits ``budget_bytes``, rounded up to a multiple of 8. Any
    chunk works, because the caller pads the rows to a chunk multiple with
    zero-capacity rows, which move no mass (ratioL = 0) and so add no cost
    and no gradient; so the budget, not N's divisors, sets the chunk, and
    a prime N needs no 1-row chunks (emd.py:236-261)."""
    limit = max(1, budget_bytes // (4 * b * m))
    chunk = min(n, limit)
    return -8 * (-chunk // 8)


def emd_forward_chunked(xyz1: Tensor, xyz2: Tensor) -> Forward:
    """The same function as ``emd_forward_plain``, streaming over chunks of
    xyz1's rows (emd.py:264-351): per level, pass A recomputes each chunk's
    distances for its row normalizers and the column sums; after the
    column saturation, pass B recomputes them again to move the mass and
    add cost and gradients. Peak memory O(B * chunk * M + B * (N + M))."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    chunk = _pick_row_chunk(b, n, m)
    nc = -(-n // chunk)
    n_pad = nc * chunk
    # Padded rows get zero capacity: their distances never matter.
    x1 = torch.cat([xyz1, xyz1.new_zeros((b, n_pad - n, 3))], dim=1)
    multi_l, multi_r = _capacities(n, m)
    remain_l = x1.new_zeros((b, n_pad))
    remain_l[:, :n] = multi_l
    remain_r = xyz2.new_full((b, m), multi_r)
    cost = xyz1.new_zeros(b)
    grad1 = x1.new_zeros((b, n_pad, 3))
    grad2 = torch.zeros_like(xyz2)
    ratio_l = torch.empty_like(remain_l)
    chunks = [slice(i * chunk, (i + 1) * chunk) for i in range(nc)]
    for level in _LEVELS:
        colsum = xyz2.new_zeros((b, m))
        for s in chunks:
            k = torch.exp(level * sqdist_matrix(x1[:, s], xyz2))
            suml = 1e-9 + torch.einsum("bnm,bm->bn", k, remain_r)
            ratio_l[:, s] = remain_l[:, s] / suml
            colsum += torch.einsum("bnm,bn->bm", k, ratio_l[:, s])
        sumr = colsum * remain_r
        ratio_r = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0) * remain_r
        remain_r = torch.clamp_min(remain_r - sumr, 0.0)
        for s in chunks:
            x1k = x1[:, s]
            d2 = sqdist_matrix(x1k, xyz2)
            w = (torch.exp(level * d2) * ratio_l[:, s, None]
                 * ratio_r[:, None, :])
            remain_l[:, s] = torch.clamp_min(remain_l[:, s] - w.sum(dim=2),
                                             0.0)
            wr = w * torch.rsqrt(torch.clamp_min(d2, 1e-20))
            # w * sqrt(d2) == wr * d2: the rsqrt already paid for the root.
            cost += torch.einsum("bnm,bnm->b", wr, d2)
            for c in range(3):
                wd = wr * (x1k[:, :, None, c] - xyz2[:, None, :, c])
                grad1[:, s, c] += wd.sum(dim=2)
                grad2[:, :, c] -= wd.sum(dim=1)
    return cost, grad1[:, :n].contiguous(), grad2


def emd_forward_cuda(xyz1: Tensor, xyz2: Tensor) -> Forward:
    """The CUDA kernel (all 10 levels, on the current stream) on f32 CUDA
    tensors; same outputs as ``emd_forward_plain`` up to summation order.
    Adds one to ``emd_forward_cuda.launches`` per call."""
    if not (xyz1.is_cuda and xyz2.is_cuda):
        raise ValueError("emd_forward_cuda takes CUDA tensors")
    if xyz1.dtype != torch.float32 or xyz2.dtype != torch.float32:
        raise ValueError("emd_forward_cuda takes float32 clouds")
    xyz1, xyz2 = (t.contiguous() for t in _prepare(xyz1, xyz2))
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    cost = torch.empty(b, dtype=torch.float32, device=xyz1.device)
    grad1 = torch.empty_like(xyz1)
    grad2 = torch.empty_like(xyz2)
    # remainL, ratioL of two levels and the row costs (B, N); remainR and
    # ratioR (B, M).
    scratch = torch.empty(b * (4 * n + 2 * m), dtype=torch.float32,
                          device=xyz1.device)
    lib = _build.load("emd", _SIGNATURES)
    with torch.cuda.device(xyz1.device):
        err = lib.pcae_emd_forward(
            xyz1.data_ptr(), xyz2.data_ptr(), cost.data_ptr(),
            grad1.data_ptr(), grad2.data_ptr(), scratch.data_ptr(), b, n, m,
            torch.cuda.current_stream(xyz1.device).cuda_stream)
    _build.check(lib, err, "emd kernel")
    emd_forward_cuda.launches += 1
    return cost, grad1, grad2


emd_forward_cuda.launches = 0


class _EmdCost(torch.autograd.Function):
    """The cost, with the forward's plan-constant gradients saved and scaled
    by the cotangent in the backward (emd.py:372-389). CUDA tensors run the
    kernel; CPU tensors the dense plain form up to ``_DENSE_BYTES_LIMIT`` of
    one (B, N, M) f32 buffer and the chunked form past it (emd.py:363-369)."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        b, n, _ = xyz1.shape
        m = xyz2.shape[1]
        if xyz1.is_cuda:
            fwd = emd_forward_cuda
        elif 4 * b * n * m > _DENSE_BYTES_LIMIT:
            fwd = emd_forward_chunked
        else:
            fwd = emd_forward_plain
        with roofline.charge("emd_forward", b=b, n=n, m=m):
            cost, grad1, grad2 = fwd(xyz1, xyz2)
        ctx.save_for_backward(grad1, grad2)
        return cost

    @staticmethod
    def backward(ctx, g):
        grad1, grad2 = ctx.saved_tensors
        return g[:, None, None] * grad1, g[:, None, None] * grad2


def emd_cost(xyz1: Tensor, xyz2: Tensor) -> Tensor:
    """Approximate EMD cost (B,) f32 of xyz1 (B, N, 3) against xyz2
    (B, M, 3), differentiable in both clouds with the plan held constant;
    equal to ``match_cost(xyz1, xyz2, approx_match(xyz1, xyz2))`` without
    building the plan. CUDA tensors run the kernel whatever the shape."""
    return _EmdCost.apply(*_prepare(xyz1, xyz2))


def emd_loss(pred: Tensor, label: Tensor) -> Tensor:
    """Mean over the batch of EMD(label -> pred), the reference's EMD
    training loss (models/model_emd.py:86-88): not divided by N, not
    scaled."""
    return emd_cost(label, pred).mean()


def earth_mover(pcd1: Tensor, pcd2: Tensor) -> Tensor:
    """PCN's ``earth_mover``: mean over the batch of
    ``match_cost(pcd1, pcd2, approx_match(pcd1, pcd2)) / N``, pcd1 matched
    against pcd2 in that order (not ``emd_loss``'s label-first order),
    both (B, N, 3) with the same N."""
    if pcd1.shape[1] != pcd2.shape[1]:
        raise ValueError(f"earth_mover takes clouds of one size, got "
                         f"{tuple(pcd1.shape)} and {tuple(pcd2.shape)}")
    return (emd_cost(pcd1, pcd2) / pcd1.shape[1]).mean()


def emd_loss_via_match(pred: Tensor, label: Tensor) -> Tensor:
    """The same loss through the explicit plan, the reference's shape of
    the computation; the tests hold the fused path to it."""
    return match_cost(label, pred, approx_match(label, pred)).mean()
