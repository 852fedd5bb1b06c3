"""Whole-encoder fusion for eval and serving: the five-layer per-point MLP
chain and the max over points as one kernel.

Counterpart of ``pointnet_autoencoder_tpu/ops/fused_encoder.py``. In eval
mode BatchNorm is a constant per-channel affine (moving statistics), so the
PointNet encoder is pure per-point math: each tile of points walks conv1..
conv5 on chip and only the per-channel extrema reach device memory.

- ``fold_layers`` folds each layer's bias and BN into f32 (scale, shift)
  rows and lays the weights out for the kernel, once; a session keeps the
  result (``FoldedChain``) instead of folding per call.
- ``fused_encoder_eval`` dispatches on the device of the points: CPU
  tensors go to ``encoder_extrema_plain``; CUDA tensors to the kernel
  ``csrc/fused_encoder.cu`` through ``encoder_extrema_cuda``, or an
  exception. Either way the last layer's monotone affine and ReLU are
  applied here to the running max or min of its raw output, by the sign of
  the scale, as the reference does (fused_encoder.py:173-176).

Eval only: the training forward needs batch statistics, so it runs layer
by layer with the fused conv5 head (``ops/fused_head.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import torch

from pointnet_autoencoder_tpu_torch.csrc import build as _build

Tensor = torch.Tensor
# (w (C, F), b, gamma, beta, mean, var) for one Dense+BN layer.
LayerParams = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]

# The only chain the kernel takes: the PointNet encoder's widths.
KERNEL_WIDTHS = (3, 64, 64, 64, 128, 1024)

# C entry points of csrc/fused_encoder.cu: (argtypes, restype).
_SIGNATURES = {
    "pcae_encoder_tile_n": ([], ctypes.c_int),
    "pcae_fused_encoder_eval": (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
        + [ctypes.c_void_p],
        ctypes.c_int),
}


def fold_affine(b: Tensor, gamma: Tensor, beta: Tensor, mean: Tensor,
                var: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """(scale, shift) f32 rows: o = (x @ w) * scale + shift with the bias,
    the BN normalization and the BN affine all folded."""
    inv = torch.rsqrt(var.float() + eps)
    scale = gamma.float() * inv
    shift = (b.float() - mean.float()) * scale + beta.float()
    return scale, shift


@dataclasses.dataclass(frozen=True)
class FoldedChain:
    """An eval-mode Dense+BN chain prepared for ``fused_encoder_eval``.

    weights: per layer (C, F) row-major in the matmul type.
    affine: the inner layers' folded f32 rows packed [scale1 shift1 scale2
      ...], the layout the kernel reads; the plain version slices the same
      tensor.
    last_scale, last_shift: the last layer's folded f32 rows (F,), applied
      after the max.
    """

    weights: Tuple[Tensor, ...]
    affine: Tensor
    last_scale: Tensor
    last_shift: Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.weights[0].dtype

    @property
    def widths(self) -> Tuple[int, ...]:
        return (self.weights[0].shape[0],) + tuple(
            w.shape[1] for w in self.weights)

    def inner_rows(self, i: int) -> Tuple[Tensor, Tensor]:
        """(scale, shift) of inner layer ``i``, views into ``affine``."""
        widths = self.widths[1:]
        off = 2 * sum(widths[:i])
        f = widths[i]
        return self.affine[off:off + f], self.affine[off + f:off + 2 * f]


def fold_layers(layers: Sequence[LayerParams], eps: float = 1e-3,
                dtype: torch.dtype = torch.float32) -> FoldedChain:
    """Fold ``layers`` (each (w (C, F), b, gamma, beta, mean, var), the
    reference's layout) into a ``FoldedChain`` with weights in ``dtype``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"matmul dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    weights, rows = [], []
    for (w, b, gamma, beta, mean, var) in layers:
        weights.append(w.detach().to(dtype).contiguous())
        rows.append(tuple(t.detach()
                          for t in fold_affine(b, gamma, beta, mean, var, eps)))
    affine = torch.cat([t for pair in rows[:-1] for t in pair]).contiguous()
    return FoldedChain(tuple(weights), affine, *rows[-1])


def encoder_extrema_plain(points: Tensor,
                          chain: FoldedChain) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel: (max, min) over points of the
    last layer's raw output, both (B, F) f32. Products of the matmul type
    are exact in f32, so the matmuls run in f32 on the type's values
    (f32 accumulation, as the kernel)."""
    x = points.to(chain.dtype)
    last = len(chain.weights) - 1
    for i in range(last):
        scale, shift = chain.inner_rows(i)
        y = torch.matmul(x.float(), chain.weights[i].float())
        o = torch.clamp_min(y * scale + shift, 0.0)
        x = o.to(chain.dtype)  # activations rounded to the matmul type
    y = torch.matmul(x.float(), chain.weights[last].float())
    return y.amax(dim=1), y.amin(dim=1)


def encoder_extrema_cuda(points: Tensor,
                         chain: FoldedChain) -> Tuple[Tensor, Tensor]:
    """The CUDA kernel; same outputs as ``encoder_extrema_plain``. Takes
    only the PointNet encoder's widths (``KERNEL_WIDTHS``). Adds one to
    ``encoder_extrema_cuda.launches`` per launch (the tile kernel and its
    reduction over tiles)."""
    dev = points.device
    if not points.is_cuda:
        raise ValueError("encoder_extrema_cuda takes CUDA tensors")
    if chain.widths != KERNEL_WIDTHS:
        raise ValueError(f"the kernel takes widths {KERNEL_WIDTHS}, got "
                         f"{chain.widths}")
    if points.dim() != 3 or points.shape[2] != 3 or 0 in points.shape:
        raise ValueError(f"expected (B, N, 3) points, got "
                         f"{tuple(points.shape)}")
    tensors = chain.weights + (chain.affine,)
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError("chain tensors must be contiguous and on the "
                         "points' device")
    pts = points.to(chain.dtype).contiguous()
    b, n, _ = pts.shape
    lib = _build.load("fused_encoder", _SIGNATURES)
    tiles = -(-n // lib.pcae_encoder_tile_n())
    f = KERNEL_WIDTHS[-1]
    part_max = torch.empty((b, tiles, f), dtype=torch.float32, device=dev)
    part_min = torch.empty_like(part_max)
    ymax = torch.empty((b, f), dtype=torch.float32, device=dev)
    ymin = torch.empty_like(ymax)
    with torch.cuda.device(dev):
        err = lib.pcae_fused_encoder_eval(
            int(chain.dtype == torch.bfloat16), pts.data_ptr(),
            *(w.data_ptr() for w in chain.weights), chain.affine.data_ptr(),
            part_max.data_ptr(), part_min.data_ptr(), ymax.data_ptr(),
            ymin.data_ptr(), b, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused encoder kernel")
    encoder_extrema_cuda.launches += 1
    return ymax, ymin


encoder_extrema_cuda.launches = 0


def _finish(chain: FoldedChain, ymax: Tensor, ymin: Tensor) -> Tensor:
    # The last affine and ReLU are monotone per channel, so they commute
    # with the max: take the max where scale >= 0 and the min elsewhere.
    scale, shift = chain.last_scale, chain.last_shift
    sel = torch.where(scale >= 0.0, ymax, ymin)
    return torch.clamp_min(sel * scale + shift, 0.0)


def fused_encoder_eval(points: Tensor, chain: FoldedChain) -> Tensor:
    """max over points of the eval-mode Dense+BN+ReLU chain -> (B, F) f32.

    points: (B, N, C0), cast to the chain's matmul type. Any N: the
    kernel masks the ragged last tile itself."""
    extrema = encoder_extrema_cuda if points.is_cuda else encoder_extrema_plain
    return _finish(chain, *extrema(points, chain))

