"""PointNet encoder: (B, N, 3) points -> (B, 1024) feature.

Counterpart of ``pointnet_autoencoder_tpu/nn/encoder.py``: five per-point
Dense+BN+ReLU layers (conv1..conv5, 64-64-64-128-1024) and a max over
points.

- Eval always runs as one fused op (``ops/fused_encoder.py``), for every
  N: the CUDA kernel masks the ragged last tile itself, so the reference's
  tile-divisibility gate does not apply here.
- Training runs conv1..conv4 as ``PointMLP`` with direct batch statistics
  (the reference's default, ``moment_stats=False``) and conv5 as the fused
  head the TPU takes (``FusedPointMLPMax`` with ``impl == "pallas"``):
  ``head_stats``, the BN moving update, then ``fused_dense_bn_relu_max``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointnet_autoencoder_tpu_torch.nn.layers import PointMLP
from pointnet_autoencoder_tpu_torch.ops import fused_encoder, fused_head

Tensor = torch.Tensor


class PointNetEncoder(nn.Module):
    """conv1..conv5 as ``PointMLP`` parameter holders (names
    ``conv{i}.dense.{weight,bias}``, ``conv{i}.bn.{gamma,beta,mean,var}``),
    applied through the fused eval op, or in training layer by layer with
    the fused conv5 head."""

    WIDTHS = (64, 64, 64, 128, 1024)

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        c = 3
        for i, f in enumerate(self.WIDTHS):
            self.add_module(f"conv{i + 1}", PointMLP(
                c, f, dtype=dtype, device=device, generator=generator))
            c = f

    def layers(self):
        return [getattr(self, f"conv{i + 1}")
                for i in range(len(self.WIDTHS))]

    def fold(self) -> fused_encoder.FoldedChain:
        """The chain folded for the fused op. A session folds once and
        passes the result to every forward."""
        return fused_encoder.fold_layers(
            [(m.dense.weight.t(), m.dense.bias, m.bn.gamma, m.bn.beta,
              m.bn.mean, m.bn.var) for m in self.layers()],
            eps=self.conv1.bn.epsilon, dtype=self.dtype)

    def forward(self, points: Tensor, train: bool = False,
                bn_momentum: float = 0.9,
                folded: Optional[fused_encoder.FoldedChain] = None) -> Tensor:
        if train:
            return self._train_forward(points, bn_momentum)
        chain = folded if folded is not None else self.fold()
        return fused_encoder.fused_encoder_eval(points, chain).to(self.dtype)

    def _train_forward(self, points: Tensor, bn_momentum: float) -> Tensor:
        x = points
        for layer in self.layers()[:-1]:
            x = layer(x, True, bn_momentum)
        head = self.conv5
        xc = x.to(self.dtype)
        kc = head.dense.weight.t().to(self.dtype).contiguous()  # (C, F)
        bc = head.dense.bias.to(self.dtype)
        # bc, not the f32 bias: the kernel folds the cast bias into its
        # affine, so the statistics describe y = xc @ kc + bc.
        mean, var = fused_head.head_stats(xc, kc, bc)
        head.bn.update(mean.detach(), var.detach(), bn_momentum)
        out = fused_head.fused_dense_bn_relu_max(
            xc, kc, bc, head.bn.gamma, head.bn.beta, mean, var,
            eps=head.bn.epsilon)
        return out.to(x.dtype)
