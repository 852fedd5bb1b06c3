"""Chamfer distance (nearest-neighbour distance) and its gradient.

Counterpart of ``pointnet_autoencoder_tpu/ops/chamfer.py``: for each point
of one cloud, the squared L2 distance to its nearest point in the other
cloud and that point's int32 index, both directions. The first minimum
wins ties. Differentiable in both clouds with the argmin held constant,
as the reference op's registered gradient.

- ``nn_distance`` dispatches on the device of its inputs: CPU tensors go
  to the plain versions; CUDA tensors to the hand-written kernels of
  ``csrc/chamfer.cu`` (forward ``nn_distance_cuda``, gradient
  ``nn_distance_grad_cuda``), or an exception.
- ``nn_distance_dense`` and ``chamfer_loss_dense`` are the dense form on
  every device: the plain forward and gradient, no kernel. They define
  ``--model model_cpu``, the reference's model on its pure-TF Chamfer
  (the JAX package's ``impl="xla"``).
- ``nn_distance_plain`` is the dense (B, N, M) form in plain PyTorch, with
  the outer differences summed in the reference's ``sqdist_matrix`` order
  ((dx*dx + dy*dy) + dz*dz), which the kernel reproduces bit for bit.
- ``chamfer_sqrt`` is PCN's Chamfer (``models/pcn_emd.py``'s
  ``chamfer``): the mean of the square roots of each direction's
  distances, the two means averaged; K2 takes its per-point gradients.
- ``nn_distance_grad_plain`` is the reference's scatter form
  (chamfer.py:392-402): a gather, then ``index_add_`` of -t into zeros,
  plus t. On the CPU ``index_add_`` adds in index order, which is the
  kernel's order, so the two agree bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple, Union

import torch

from pointnet_autoencoder_tpu_torch.csrc import build as _build
from pointnet_autoencoder_tpu_torch.utils import roofline

Tensor = torch.Tensor

# C entry points of csrc/chamfer.cu: (argtypes, restype).
_SIGNATURES = {
    "pcae_nn_distance": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        ctypes.c_int),
    "pcae_nn_distance_scratch": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "pcae_nn_distance_grad": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        ctypes.c_int),
    "pcae_nn_distance_grad_scratch": ([ctypes.c_int] * 3, ctypes.c_longlong),
}


def _prepare(xyz1: Tensor, xyz2: Tensor) -> Tuple[Tensor, Tensor]:
    if (xyz1.dim() != 3 or xyz2.dim() != 3 or xyz1.shape[2] != 3
            or xyz2.shape[2] != 3 or xyz1.shape[0] != xyz2.shape[0]):
        raise ValueError(f"expected (B, N, 3) and (B, M, 3), got "
                         f"{tuple(xyz1.shape)} and {tuple(xyz2.shape)}")
    if 0 in xyz1.shape or 0 in xyz2.shape:
        raise ValueError(f"empty cloud: {tuple(xyz1.shape)}, "
                         f"{tuple(xyz2.shape)}")
    if xyz1.device != xyz2.device:
        raise ValueError(f"clouds on different devices: {xyz1.device}, "
                         f"{xyz2.device}")
    # Distances are always f32, whatever the network's type. The cast
    # happens first and outside the autograd Function, as in the reference
    # (chamfer.py:425-431), so a bf16 cloud gets a bf16 gradient back.
    return xyz1.float(), xyz2.float()


def sqdist_matrix(xyz1: Tensor, xyz2: Tensor) -> Tensor:
    """(B,N,3), (B,M,3) -> (B,N,M) squared distances from the outer
    differences, summed ((dx*dx + dy*dy) + dz*dz) as the reference's
    ``sqdist_matrix`` does; the kernels round d2 the same way."""
    d2 = None
    for c in range(3):
        diff = xyz1[:, :, None, c] - xyz2[:, None, :, c]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def nn_distance_plain(xyz1: Tensor, xyz2: Tensor):
    """Plain PyTorch version: (B,N,3) f32, (B,M,3) f32 -> dist1 (B,N) f32,
    idx1 (B,N) int32, dist2 (B,M) f32, idx2 (B,M) int32."""
    d2 = sqdist_matrix(xyz1, xyz2)
    dist1, idx1 = d2.min(dim=2)  # first minimum wins, like argmin
    dist2, idx2 = d2.min(dim=1)
    return dist1, idx1.int(), dist2, idx2.int()


def nn_distance_cuda(xyz1: Tensor, xyz2: Tensor):
    """The CUDA kernel (both directions from one d2 per pair, and a small
    kernel that combines each xyz2 point's minima over the query tiles) on
    f32 CUDA tensors; same outputs as ``nn_distance_plain``, bit for bit.
    Allocates a scratch of 8 * B * ceil(N/256) * M bytes. Adds one to
    ``nn_distance_cuda.launches`` per call."""
    if not (xyz1.is_cuda and xyz2.is_cuda):
        raise ValueError("nn_distance_cuda takes CUDA tensors")
    if xyz1.dtype != torch.float32 or xyz2.dtype != torch.float32:
        raise ValueError("nn_distance_cuda takes float32 clouds")
    xyz1, xyz2 = xyz1.contiguous(), xyz2.contiguous()
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    dev = xyz1.device
    dist1 = torch.empty((b, n), dtype=torch.float32, device=dev)
    idx1 = torch.empty((b, n), dtype=torch.int32, device=dev)
    dist2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    idx2 = torch.empty((b, m), dtype=torch.int32, device=dev)
    lib = _build.load("chamfer", _SIGNATURES)
    scratch = torch.empty(int(lib.pcae_nn_distance_scratch(b, n, m)),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.pcae_nn_distance(
            xyz1.data_ptr(), xyz2.data_ptr(), dist1.data_ptr(),
            idx1.data_ptr(), dist2.data_ptr(), idx2.data_ptr(),
            scratch.data_ptr(), b, n, m,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "nn_distance kernel")
    nn_distance_cuda.launches += 1
    return dist1, idx1, dist2, idx2


nn_distance_cuda.launches = 0


def _gather(x: Tensor, idx: Tensor) -> Tensor:
    """x (B, K, 3) at idx (B, L) -> (B, L, 3)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, 3))


def _segment_sum(src: Tensor, idx: Tensor, size: int) -> Tensor:
    """out (B, size, 3) with out[b, idx[b, l]] += src[b, l]."""
    b, l, _ = src.shape
    rows = idx.long() + size * torch.arange(b, device=src.device)[:, None]
    out = torch.zeros((b * size, 3), dtype=src.dtype, device=src.device)
    out.index_add_(0, rows.reshape(b * l), src.reshape(b * l, 3))
    return out.reshape(b, size, 3)


def nn_distance_grad_plain(xyz1: Tensor, xyz2: Tensor, idx1: Tensor,
                           idx2: Tensor, g1: Tensor, g2: Tensor):
    """Plain PyTorch version of the gradient: (gx1 (B,N,3), gx2 (B,M,3))
    f32 from the clouds, the forward's indices and the distances'
    cotangents g1 (B,N), g2 (B,M)."""
    t1 = 2.0 * g1[..., None] * (xyz1 - _gather(xyz2, idx1))
    t2 = 2.0 * g2[..., None] * (xyz2 - _gather(xyz1, idx2))
    gx1 = t1 + _segment_sum(-t2, idx2, xyz1.shape[1])
    gx2 = t2 + _segment_sum(-t1, idx1, xyz2.shape[1])
    return gx1, gx2


def nn_distance_grad_scratch_words(b: int, n: int, m: int) -> int:
    """int32 words of scratch the gradient kernel needs at these shapes:
    0 while each block's workspace fits its shared memory."""
    lib = _build.load("chamfer", _SIGNATURES)
    return int(lib.pcae_nn_distance_grad_scratch(b, n, m))


def nn_distance_grad_cuda(xyz1: Tensor, xyz2: Tensor, idx1: Tensor,
                          idx2: Tensor, g1: Tensor, g2: Tensor):
    """The CUDA gradient kernel (both directions in one launch, a
    deterministic segment sum: every output row written once, its terms
    added in ascending source index, the order of ``index_add_`` on the
    CPU). ``idx1``/``idx2`` are the indices ``nn_distance`` returned for
    these clouds. Shapes whose per-block workspace exceeds shared memory
    get a scratch buffer. Adds one to ``nn_distance_grad_cuda.launches``
    per launch."""
    tensors = (xyz1, xyz2, idx1, idx2, g1, g2)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("nn_distance_grad_cuda takes CUDA tensors")
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    want = ((torch.float32, (b, n, 3)), (torch.float32, (b, m, 3)),
            (torch.int32, (b, n)), (torch.int32, (b, m)),
            (torch.float32, (b, n)), (torch.float32, (b, m)))
    for t, (dtype, shape) in zip(tensors, want):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"nn_distance_grad_cuda: expected {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    xyz1, xyz2, idx1, idx2, g1, g2 = (t.contiguous() for t in tensors)
    gx1 = torch.empty_like(xyz1)
    gx2 = torch.empty_like(xyz2)
    lib = _build.load("chamfer", _SIGNATURES)
    words = nn_distance_grad_scratch_words(b, n, m)
    scratch = (torch.empty(words, dtype=torch.int32, device=xyz1.device)
               if words else None)
    with torch.cuda.device(xyz1.device):
        err = lib.pcae_nn_distance_grad(
            xyz1.data_ptr(), xyz2.data_ptr(), idx1.data_ptr(),
            idx2.data_ptr(), g1.data_ptr(), g2.data_ptr(), gx1.data_ptr(),
            gx2.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, n, m, torch.cuda.current_stream(xyz1.device).cuda_stream)
    _build.check(lib, err, "nn_distance gradient kernel")
    nn_distance_grad_cuda.launches += 1
    return gx1, gx2


nn_distance_grad_cuda.launches = 0


class _NnDistance(torch.autograd.Function):
    """Forward and gradient with the argmin held constant
    (chamfer.py:375-405); the index outputs carry no gradient."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, dense):
        ctx.kernel = xyz1.is_cuda and not dense
        ctx.dense = dense
        fwd = nn_distance_cuda if ctx.kernel else nn_distance_plain
        with _charged(dense, "nn_distance", xyz1, xyz2):
            dist1, idx1, dist2, idx2 = fwd(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, idx1, dist2, idx2

    @staticmethod
    def backward(ctx, g_d1, _g_idx1, g_d2, _g_idx2):
        xyz1, xyz2, idx1, idx2 = ctx.saved_tensors
        grad = nn_distance_grad_cuda if ctx.kernel else \
            nn_distance_grad_plain
        with _charged(ctx.dense, "nn_distance_grad", xyz1, xyz2):
            gx1, gx2 = grad(xyz1, xyz2, idx1, idx2, g_d1, g_d2)
        return gx1, gx2, None


def _charged(dense: bool, kernel: str, xyz1: Tensor, xyz2: Tensor):
    """The kernel's charge in a ``utils/roofline.StepCost`` (on every
    device: the CPU's plain version stands for it); the dense form is
    counted op by op."""
    if dense:
        return contextlib.nullcontext()
    return roofline.charge(kernel, b=xyz1.shape[0], n=xyz1.shape[1],
                           m=xyz2.shape[1])


def nn_distance(xyz1: Tensor, xyz2: Tensor):
    """Nearest-neighbour squared distances between two point clouds.

    Args:
      xyz1: (B, N, 3) float tensor, first cloud.
      xyz2: (B, M, 3) float tensor, second cloud, on the same device.

    Returns (dist1 (B,N) f32, idx1 (B,N) int32, dist2 (B,M) f32,
    idx2 (B,M) int32): from each xyz1 point to its nearest xyz2 point, and
    from each xyz2 point to its nearest xyz1 point. Differentiable in both
    clouds through the distances, with the indices held constant.
    """
    return _NnDistance.apply(*_prepare(xyz1, xyz2), False)


def nn_distance_dense(xyz1: Tensor, xyz2: Tensor):
    """``nn_distance`` in the dense form on every device: the plain forward
    (a (B, N, M) distance matrix) and the plain gradient. It launches no
    kernel."""
    return _NnDistance.apply(*_prepare(xyz1, xyz2), True)


def _chamfer_mean(d1: Tensor, d2: Tensor) -> Tensor:
    if d1.shape != d2.shape:
        return d1.mean() + d2.mean()
    return (d1 + d2).mean()


def chamfer_loss(pred: Tensor, label: Tensor) -> Tensor:
    """mean(dist_fwd + dist_bwd), the reference's raw ``pcloss``; the two
    means are taken apart when the clouds differ in size."""
    d1, _, d2, _ = nn_distance(pred, label)
    return _chamfer_mean(d1, d2)


def chamfer_loss_dense(pred: Tensor, label: Tensor) -> Tensor:
    """``chamfer_loss`` through ``nn_distance_dense``: the loss of
    ``--model model_cpu`` on every device."""
    d1, _, d2, _ = nn_distance_dense(pred, label)
    return _chamfer_mean(d1, d2)


def chamfer_sqrt(pcd1: Tensor, pcd2: Tensor) -> Tensor:
    """PCN's Chamfer distance: (mean sqrt(dist1) + mean sqrt(dist2)) / 2,
    each mean over the batch and its cloud's points, through
    ``nn_distance`` (K1 and K2 on the card). No epsilon under the root, as
    PCN has none: a point that lands exactly on its neighbour gives an
    infinite gradient there."""
    d1, _, d2, _ = nn_distance(pcd1, pcd2)
    return (torch.sqrt(d1).mean() + torch.sqrt(d2).mean()) / 2.0


def fscore(pred: Tensor, target: Tensor,
           threshold: Union[float, Tensor] = 0.01) -> Tensor:
    """Per-shape F-score at a distance threshold: the harmonic mean of
    precision (pred points within ``threshold`` of the target) and recall
    (target points within ``threshold`` of the pred). Squared distances
    compare against ``threshold**2``, in f32; ``threshold`` may be a 0-dim
    f32 tensor on the clouds' device (a captured program's input).
    Returns (B,) f32 in [0, 1]."""
    d1, _, d2, _ = nn_distance(pred, target)
    t2 = torch.as_tensor(threshold, dtype=torch.float32,
                         device=d1.device) ** 2
    precision = (d1 < t2).float().mean(dim=1)
    recall = (d2 < t2).float().mean(dim=1)
    return 2.0 * precision * recall / torch.clamp_min(precision + recall,
                                                      1e-12)
