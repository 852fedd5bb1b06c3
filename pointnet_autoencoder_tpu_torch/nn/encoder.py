"""Encoders: PointNet's, (B, N, 3) points -> (B, 1024) feature; and
PCN's two-stage encoder (``PCNEncoder``), the same shapes.

Counterpart of ``pointnet_autoencoder_tpu/nn/encoder.py``: five per-point
Dense+BN+ReLU layers (conv1..conv5, 64-64-64-128-1024) and a max over
points.

- Eval always runs as one fused op (``ops/fused_encoder.py``), for every
  N: the CUDA kernel masks the ragged last tile itself, so the reference's
  tile-divisibility gate does not apply here.
- Training runs conv1..conv4 as ``PointMLP`` with direct batch statistics
  (the reference's default, ``moment_stats=False``), or with
  ``moment_stats=True`` as ``MomentStatsPointMLP`` (the statistics from the
  layer input's moments, ``head_stats``), and conv5 as the fused head the
  TPU takes (``FusedPointMLPMax`` with ``impl == "pallas"``):
  ``head_stats``, the BN moving update, then ``fused_dense_bn_relu_max``.
- Under point parallelism (``point_group``, set by
  ``PointAutoencoder.set_point_group``) the points are this rank's share:
  the head's max and the eval extrema are combined over the ranks
  (``parallel/sp.py``), so the feature is the whole cloud's on every
  rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from pointnet_autoencoder_tpu_torch.nn.layers import FC, PointMLP
from pointnet_autoencoder_tpu_torch.ops import fused_encoder, fused_head
from pointnet_autoencoder_tpu_torch.parallel import sp

Tensor = torch.Tensor


class MomentStatsPointMLP(PointMLP):
    """Dense + BN + ReLU whose training batch statistics come from the
    moments of the layer INPUT (``fused_head.head_stats``: one (C, P) @
    (P, C) product and O(C·F)) instead of two reductions of the (P, F)
    activation; the same parameters, moving update and eval as
    ``PointMLP``, and its training affine as the card's fused BatchNorm
    applies it: in f32, rounded once to the activation's type. The
    statistics' gradient terms come from ``head_stats``' autograd.
    ``bn.group`` averages the moments over the ranks (data or point
    parallel), so the statistics stay the global batch's."""

    def forward(self, x: Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> Tensor:
        if not train:
            return super().forward(x, train, bn_momentum)
        d = self.dense
        mean, var = fused_head.head_stats(
            x.to(d.dtype), d.weight.t().to(d.dtype), d.bias.to(d.dtype),
            group=self.bn.group)
        self.bn.update(mean.detach(), var.detach(), bn_momentum)
        inv, shift = self.bn.fold(mean, var)
        y = d(x)
        return F.relu(y.float() * inv + shift).to(y.dtype)


class PointNetEncoder(nn.Module):
    """conv1..conv5 as ``PointMLP`` parameter holders (names
    ``conv{i}.dense.{weight,bias}``, ``conv{i}.bn.{gamma,beta,mean,var}``),
    applied through the fused eval op, or in training layer by layer with
    the fused conv5 head. ``moment_stats``: conv1..conv4 take their
    training statistics from input moments (``MomentStatsPointMLP``); off
    by default, as in the JAX package, where the model builds the encoder
    without it."""

    WIDTHS = (64, 64, 64, 128, 1024)

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 moment_stats: bool = False):
        super().__init__()
        self.dtype = dtype
        # A parallel.mesh.DataGroup whose ranks split the points, or None.
        self.point_group = None
        c = 3
        for i, f in enumerate(self.WIDTHS):
            mlp = (MomentStatsPointMLP
                   if moment_stats and i < len(self.WIDTHS) - 1
                   else PointMLP)
            self.add_module(f"conv{i + 1}", mlp(
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
        if self.point_group is not None:
            out = sp.encoder_eval_point_sharded(points, chain,
                                                self.point_group)
        else:
            out = fused_encoder.fused_encoder_eval(points, chain)
        return out.to(self.dtype)

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
        mean, var = fused_head.head_stats(xc, kc, bc, group=head.bn.group)
        head.bn.update(mean.detach(), var.detach(), bn_momentum)
        out = fused_head.fused_dense_bn_relu_max(
            xc, kc, bc, head.bn.gamma, head.bn.beta, mean, var,
            eps=head.bn.epsilon)
        if self.point_group is not None:
            out = sp.max_point_sharded(out, self.point_group)
        return out.to(x.dtype)


class PCNEncoder(nn.Module):
    """PCN's encoder (Yuan et al., 3DV 2018; github.com/wentaoyuan/pcn,
    ``models/pcn_emd.py`` ``create_encoder``): two per-point stages of
    Dense layers with biases and no BatchNorm, each PCN's ``mlp_conv``
    (ReLU between its layers, the last linear). Stage 1 (``conv1``,
    ``conv2``): 3 -> 128 -> 256; its max over points is tiled back onto
    every point and concatenated after the point's own features, 512
    wide; stage 2 (``conv3``, ``conv4``): 512 -> 512 -> 1024, then the max
    over points. Every cloud has its N points (PCN's ragged ``npts``
    batches are fixed-size here)."""

    WIDTHS = ((3, 128, True), (128, 256, False), (512, 512, True),
              (512, 1024, False))

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for i, (c, f, relu) in enumerate(self.WIDTHS):
            self.add_module(f"conv{i + 1}", FC(
                c, f, relu=relu, dtype=dtype, device=device,
                generator=generator))

    def forward(self, points: Tensor) -> Tensor:
        x = self.conv2(self.conv1(points))                  # (B, N, 256)
        pooled = x.amax(dim=1, keepdim=True).expand_as(x)
        x = self.conv4(self.conv3(torch.cat([x, pooled], dim=2)))
        return x.amax(dim=1)                                # (B, 1024)
