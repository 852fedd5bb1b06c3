"""PointNet encoder, eval path: (B, N, 3) points -> (B, 1024) feature.

Counterpart of ``pointnet_autoencoder_tpu/nn/encoder.py``: five per-point
Dense+BN+ReLU layers (conv1..conv5, 64-64-64-128-1024) and a max over
points. Eval always runs as one fused op (``ops/fused_encoder.py``), for
every N: the CUDA kernel masks the ragged last tile itself, so the
reference's tile-divisibility gate does not apply here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointnet_autoencoder_tpu_torch.nn.layers import TRAIN_NOT_PORTED, PointMLP
from pointnet_autoencoder_tpu_torch.ops import fused_encoder

Tensor = torch.Tensor


class PointNetEncoder(nn.Module):
    """conv1..conv5 as ``PointMLP`` parameter holders (names
    ``conv{i}.dense.{weight,bias}``, ``conv{i}.bn.{gamma,beta,mean,var}``),
    applied through the fused eval op."""

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
                folded: Optional[fused_encoder.FoldedChain] = None) -> Tensor:
        if train:
            raise NotImplementedError(TRAIN_NOT_PORTED)
        chain = folded if folded is not None else self.fold()
        return fused_encoder.fused_encoder_eval(points, chain).to(self.dtype)
