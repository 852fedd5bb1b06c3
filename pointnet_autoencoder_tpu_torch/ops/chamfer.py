"""Chamfer distance (nearest-neighbour distance), forward only.

Counterpart of ``pointnet_autoencoder_tpu/ops/chamfer.py``: for each point
of one cloud, the squared L2 distance to its nearest point in the other
cloud and that point's int32 index, both directions. The first minimum
wins ties.

- ``nn_distance`` dispatches on the device of its inputs: CPU tensors go
  to ``nn_distance_plain``; CUDA tensors to the hand-written kernel
  ``csrc/chamfer.cu`` through ``nn_distance_cuda``, or an exception.
- ``nn_distance_plain`` is the dense (B, N, M) form in plain PyTorch, with
  the outer differences summed in the reference's ``sqdist_matrix`` order
  ((dx*dx + dy*dy) + dz*dz), which the kernel reproduces bit for bit.

There is no gradient yet: the backward kernel comes with the training
slice, so an input that requires grad raises instead of silently
detaching.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointnet_autoencoder_tpu_torch.csrc import build as _build

Tensor = torch.Tensor

# C entry points of csrc/chamfer.cu: (argtypes, restype).
_SIGNATURES = {
    "pcae_nn_distance": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        ctypes.c_int),
}


def _prepare(xyz1: Tensor, xyz2: Tensor) -> Tuple[Tensor, Tensor]:
    if xyz1.requires_grad or xyz2.requires_grad:
        raise NotImplementedError(
            "nn_distance has no backward yet (it arrives with the training "
            "slice); call it on tensors that do not require grad")
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
    # Distances are always f32, whatever the network's type (the cast
    # happens first, as in the reference, chamfer.py:430).
    return xyz1.float(), xyz2.float()


def nn_distance_plain(xyz1: Tensor, xyz2: Tensor):
    """Plain PyTorch version: (B,N,3) f32, (B,M,3) f32 -> dist1 (B,N) f32,
    idx1 (B,N) int32, dist2 (B,M) f32, idx2 (B,M) int32."""
    d2 = None
    for c in range(3):
        diff = xyz1[:, :, None, c] - xyz2[:, None, :, c]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    dist1, idx1 = d2.min(dim=2)  # first minimum wins, like argmin
    dist2, idx2 = d2.min(dim=1)
    return dist1, idx1.int(), dist2, idx2.int()


def nn_distance_cuda(xyz1: Tensor, xyz2: Tensor):
    """The CUDA kernel (both directions in one launch) on contiguous f32
    CUDA tensors; same outputs as ``nn_distance_plain``. Adds one to
    ``nn_distance_cuda.launches`` per launch."""
    if not (xyz1.is_cuda and xyz2.is_cuda):
        raise ValueError("nn_distance_cuda takes CUDA tensors")
    if xyz1.dtype != torch.float32 or xyz2.dtype != torch.float32:
        raise ValueError("nn_distance_cuda takes float32 clouds")
    xyz1, xyz2 = xyz1.contiguous(), xyz2.contiguous()
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    dist1 = torch.empty((b, n), dtype=torch.float32, device=xyz1.device)
    idx1 = torch.empty((b, n), dtype=torch.int32, device=xyz1.device)
    dist2 = torch.empty((b, m), dtype=torch.float32, device=xyz1.device)
    idx2 = torch.empty((b, m), dtype=torch.int32, device=xyz1.device)
    lib = _build.load("chamfer", _SIGNATURES)
    err = lib.pcae_nn_distance(
        xyz1.data_ptr(), xyz2.data_ptr(), dist1.data_ptr(), idx1.data_ptr(),
        dist2.data_ptr(), idx2.data_ptr(), b, n, m,
        torch.cuda.current_stream(xyz1.device).cuda_stream)
    _build.check(lib, err, "nn_distance kernel")
    nn_distance_cuda.launches += 1
    return dist1, idx1, dist2, idx2


nn_distance_cuda.launches = 0


def nn_distance(xyz1: Tensor, xyz2: Tensor):
    """Nearest-neighbour squared distances between two point clouds.

    Args:
      xyz1: (B, N, 3) float tensor, first cloud.
      xyz2: (B, M, 3) float tensor, second cloud, on the same device.

    Returns (dist1 (B,N) f32, idx1 (B,N) int32, dist2 (B,M) f32,
    idx2 (B,M) int32): from each xyz1 point to its nearest xyz2 point, and
    from each xyz2 point to its nearest xyz1 point.
    """
    xyz1, xyz2 = _prepare(xyz1, xyz2)
    if xyz1.is_cuda:
        return nn_distance_cuda(xyz1, xyz2)
    return nn_distance_plain(xyz1, xyz2)


def chamfer_loss(pred: Tensor, label: Tensor) -> Tensor:
    """mean(dist_fwd + dist_bwd), the reference's raw ``pcloss``; the two
    means are taken apart when the clouds differ in size."""
    d1, _, d2, _ = nn_distance(pred, label)
    if d1.shape != d2.shape:
        return d1.mean() + d2.mean()
    return (d1 + d2).mean()


def fscore(pred: Tensor, target: Tensor, threshold: float = 0.01) -> Tensor:
    """Per-shape F-score at a distance threshold: the harmonic mean of
    precision (pred points within ``threshold`` of the target) and recall
    (target points within ``threshold`` of the pred). Squared distances
    compare against ``threshold**2``. Returns (B,) f32 in [0, 1]."""
    d1, _, d2, _ = nn_distance(pred, target)
    t2 = torch.tensor(threshold, dtype=torch.float32, device=d1.device) ** 2
    precision = (d1 < t2).float().mean(dim=1)
    recall = (d2 < t2).float().mean(dim=1)
    return 2.0 * precision * recall / torch.clamp_min(precision + recall,
                                                      1e-12)
