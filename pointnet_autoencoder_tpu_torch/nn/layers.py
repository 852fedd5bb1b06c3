"""Layer library: Dense, BatchNorm, PointMLP and FC, train and eval.

Counterpart of ``pointnet_autoencoder_tpu/nn/layers.py``. Parameter names
follow the reference's flax tree, so weights carry across by name:
``<layer>.dense.{weight,bias}`` and ``<layer>.bn.{gamma,beta}`` parameters,
``<layer>.bn.{mean,var}`` buffers. Dense weights are stored (out, in), the
PyTorch habit; ``convert.py`` transposes the reference's (in, out) kernels.

Init follows the reference: Glorot-uniform kernels from an explicit
``torch.Generator``, zero biases, BN gamma 1, beta 0, mean 0, var 1,
eps 1e-3. ``torch.nn.BatchNorm1d`` is not used: it updates its running
variance with the unbiased variance and takes momentum as 1 - m.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

Tensor = torch.Tensor


class Dense(nn.Module):
    """y = x @ weight.T + bias, computed in the module's compute dtype."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_features), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))
        nn.init.xavier_uniform_(self.weight, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """Batch normalization with the momentum passed in at each call (the
    bn_decay schedule), as the reference's nn/layers.py:64-87.

    Training: the batch mean and biased variance E[x^2] - E[x]^2 in f32
    over every axis but the last (the variance clamped at 0) normalize the
    input, and the moving statistics move in place, under no_grad, as
    ``moving = m * moving + (1 - m) * batch``. Eval: the moving statistics
    normalize. Either way the per-channel affine is folded in f32,
    ``inv = rsqrt(var + eps) * gamma`` and ``shift = beta - mean * inv``,
    then applied in the activation's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-3,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(features, device=device))
        self.beta = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: Tensor, train: bool = False,
                momentum: float = 0.9) -> Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = torch.clamp_min(xf.square().mean(dim=axes) - mean.square(),
                                  0.0)
            self.update(mean, var, momentum)
        else:
            mean, var = self.mean.float(), self.var.float()
        inv = torch.rsqrt(var + self.epsilon) * self.gamma.float()
        shift = self.beta.float() - mean * inv
        return x * inv.to(x.dtype) + shift.to(x.dtype)

    @torch.no_grad()
    def update(self, mean: Tensor, var: Tensor, momentum: float) -> None:
        """moving = m * moving + (1 - m) * batch, in place."""
        self.mean.mul_(momentum).add_((1.0 - momentum) * mean.float())
        self.var.mul_(momentum).add_((1.0 - momentum) * var.float())


class PointMLP(nn.Module):
    """Per-point shared MLP: Dense over the channel axis, BN, ReLU."""

    def __init__(self, in_features: int, features: int, bn: bool = True,
                 relu: bool = True, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Dense(in_features, features, dtype=dtype, device=device,
                           generator=generator)
        self.bn = BatchNorm(features, device=device) if bn else None
        self.relu = relu

    def forward(self, x: Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> Tensor:
        x = self.dense(x)
        if self.bn is not None:
            x = self.bn(x, train, bn_momentum)
        return F.relu(x) if self.relu else x


class FC(PointMLP):
    """Fully connected + optional BN + ReLU; the same block as PointMLP
    with BN off by default, per the reference's two constructors."""

    def __init__(self, in_features: int, features: int, bn: bool = False,
                 relu: bool = True, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, bn=bn, relu=relu,
                         dtype=dtype, device=device, generator=generator)
