"""Layer library: Dense, BatchNorm, PointMLP, FC and UpConv, train and
eval; and the rest of the reference's layer surface, which no shipped
model uses: N-D ``Conv``, ``max_pool``, ``avg_pool`` and ``Dropout``.

Counterpart of ``pointnet_autoencoder_tpu/nn/layers.py``. Parameter names
follow the reference's flax tree, so weights carry across by name:
``<layer>.dense.{weight,bias}`` (``<layer>.convt.{weight,bias}`` for
UpConv, ``<layer>.conv.{weight,bias}`` for Conv) and
``<layer>.bn.{gamma,beta}`` parameters, ``<layer>.bn.{mean,var}``
buffers. Dense weights are stored (out, in), transposed-conv weights
(cin, cout, kh, kw) and conv weights (cout, cin, *kernel), the PyTorch
habits; ``convert.py`` moves the reference's kernels into them.

Init follows the reference: Glorot-uniform kernels from an explicit
``torch.Generator``, zero biases, BN gamma 1, beta 0, mean 0, var 1,
eps 1e-3. ``torch.nn.BatchNorm1d`` is not used: it updates its running
variance with the unbiased variance and takes momentum as 1 - m.

``PointMLP``, ``FC``, ``UpConv`` and ``Conv`` train unless told not to
(``train=True`` by default), as the JAX package's layers do;
``BatchNorm`` takes ``train`` from its caller.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from pointnet_autoencoder_tpu_torch.ops import batch_norm
from pointnet_autoencoder_tpu_torch.parallel import tp

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
    then applied in the activation's dtype.

    ``relu`` applies the layer's ReLU after the normalization. In
    training the statistics, the moving update, the normalization and the
    ReLU are one op, ``ops/batch_norm.batch_norm_train``: on a card K7,
    which applies the affine in f32 and rounds once; on the CPU the
    arithmetic above, op by op.

    ``group`` (a ``parallel.mesh.DataGroup``, None by default) makes the
    training moments E[x] and E[x^2] the global batch's: one all-reduce
    averages them over the ranks' equal shards, so every rank normalizes
    with, and moves its moving statistics by, the same global statistics,
    and one more in the backward carries the gradient through them to
    every rank's rows (the JAX package's ``axis_name`` pmean)."""

    def __init__(self, features: int, epsilon: float = 1e-3,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.epsilon = epsilon
        self.group = None
        self.gamma = nn.Parameter(torch.ones(features, device=device))
        self.beta = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: Tensor, train: bool,
                momentum: Union[float, Tensor] = 0.9,
                relu: bool = False) -> Tensor:
        if train:
            return batch_norm.batch_norm_train(
                x, self.gamma, self.beta, self.mean, self.var, momentum,
                self.epsilon, relu=relu, group=self.group)
        y = self.normalize(x, self.mean.float(), self.var.float())
        return F.relu(y) if relu else y

    def fold(self, mean: Tensor, var: Tensor) -> Tuple[Tensor, Tensor]:
        """(inv, shift) in f32 of the f32 statistics (mean, var) and the
        affine: inv = rsqrt(var + eps) * gamma, shift = beta - mean * inv."""
        inv = torch.rsqrt(var + self.epsilon) * self.gamma.float()
        return inv, self.beta.float() - mean * inv

    def normalize(self, x: Tensor, mean: Tensor, var: Tensor) -> Tensor:
        """x normalized by the f32 statistics (mean, var) and the affine:
        folded in f32, applied in x's dtype."""
        inv, shift = self.fold(mean, var)
        return x * inv.to(x.dtype) + shift.to(x.dtype)

    @torch.no_grad()
    def update(self, mean: Tensor, var: Tensor,
               momentum: Union[float, Tensor]) -> None:
        """moving = m * moving + (1 - m) * batch, in place, with m and
        1 - m in f32 (the JAX package's f32 momentum): m is a 0-dim f32
        tensor on the statistics' device (the train step's, computed on
        the device from its step counter), or a float made into one."""
        m = (momentum.float() if torch.is_tensor(momentum) else
             torch.full((), momentum, dtype=torch.float32,
                        device=self.mean.device))
        self.mean.mul_(m).add_((1.0 - m) * mean.float())
        self.var.mul_(m).add_((1.0 - m) * var.float())


def _bn_relu(bn: Optional[BatchNorm], relu: bool, x: Tensor, train: bool,
             momentum: Union[float, Tensor]) -> Tensor:
    """A layer's BN (if any) and ReLU (if any) of its linear output: with
    BN, one call that applies the ReLU too."""
    if bn is not None:
        return bn(x, train, momentum, relu=relu)
    return F.relu(x) if relu else x


class PointMLP(nn.Module):
    """Per-point shared MLP: Dense over the channel axis, BN, ReLU.

    Under tensor parallelism (``set_tensor_parallel``, by
    ``parallel/tp.shard_model_``) the layer holds this rank's slices and
    runs its role over the model group: a column-parallel layer sums its
    input's gradient over the group, computes its output channels and, if
    it gathers, concatenates the ranks' channels; a row-parallel layer
    sums the ranks' partial products in f32 and adds its bias once. With
    no group it runs the one-device code."""

    def __init__(self, in_features: int, features: int, bn: bool = True,
                 relu: bool = True, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Dense(in_features, features, dtype=dtype, device=device,
                           generator=generator)
        self.bn = BatchNorm(features, device=device) if bn else None
        self.relu = relu
        self.tp_role: Optional[str] = None
        self.tp_group = None
        self.tp_gathers = False

    def set_tensor_parallel(self, role: str, group, gathers: bool) -> None:
        """Take the tensor-parallel ``role`` ("column" or "row") over the
        model ``group``; ``gathers``: a column-parallel layer's output is
        concatenated over the group."""
        if role not in ("column", "row"):
            raise ValueError(f"unknown tensor-parallel role {role!r}")
        self.tp_role, self.tp_group, self.tp_gathers = role, group, gathers

    def activate(self, x: Tensor, train: bool, bn_momentum: float) -> Tensor:
        """BN (if any) and ReLU (if any) of the dense output ``x``."""
        return _bn_relu(self.bn, self.relu, x, train, bn_momentum)

    def forward(self, x: Tensor, train: bool = True,
                bn_momentum: float = 0.9) -> Tensor:
        group = self.tp_group
        if group is None:
            return self.activate(self.dense(x), train, bn_momentum)
        if self.tp_role == "row":
            d = self.dense
            partial = F.linear(x.to(d.dtype), d.weight.to(d.dtype))
            y = (tp.reduce_from_model(partial, group)
                 + d.bias.float()).to(d.dtype)
            return self.activate(y, train, bn_momentum)
        y = self.activate(self.dense(tp.copy_to_model(x, group)), train,
                          bn_momentum)
        return tp.gather_from_model(y, group) if self.tp_gathers else y


class FC(PointMLP):
    """Fully connected + optional BN + ReLU; the same block as PointMLP
    with BN off by default, per the reference's two constructors."""

    def __init__(self, in_features: int, features: int, bn: bool = False,
                 relu: bool = True, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, bn=bn, relu=relu,
                         dtype=dtype, device=device, generator=generator)


class ConvTranspose(nn.Module):
    """2-D transposed convolution with VALID padding on a channels-last
    (B, H, W, C) tensor, computed in the module's compute dtype. The
    output is (B, (H-1)*sh + kh, (W-1)*sw + kw, features): every input
    pixel spreads its kernel over the output, as TF's conv2d_transpose and
    ``F.conv_transpose2d`` do."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.strides = tuple(strides)
        kh, kw = kernel_size
        self.weight = nn.Parameter(torch.empty(
            (in_features, features, kh, kw), dtype=torch.float32,
            device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))
        # Glorot over the flax kernel's (kh, kw, cin, cout) fans: receptive
        # field kh*kw, fan_in kh*kw*cin, fan_out kh*kw*cout.
        limit = (6.0 / (kh * kw * (in_features + features))) ** 0.5
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype),
                               self.bias.to(self.dtype), stride=self.strides)
        return y.permute(0, 2, 3, 1)


class UpConv(nn.Module):
    """Transposed 2-D conv (VALID), optional BN, optional ReLU, on
    channels-last tensors (the reference's tf_util.conv2d_transpose).

    The output size is (in-1)*s + k per spatial axis. The JAX package's
    flax layer gives in*s + max(k-s, 0); the two agree when k >= s, which
    every decoder stage satisfies and the constructor requires."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides, bn: bool = True, relu: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if any(k < s for k, s in zip(kernel_size, strides)):
            raise ValueError(f"UpConv needs kernel >= stride on each axis, "
                             f"got kernel {tuple(kernel_size)}, strides "
                             f"{tuple(strides)}")
        self.convt = ConvTranspose(in_features, features, kernel_size,
                                   strides, dtype=dtype, device=device,
                                   generator=generator)
        self.bn = BatchNorm(features, device=device) if bn else None
        self.relu = relu

    def forward(self, x: Tensor, train: bool = True,
                bn_momentum: float = 0.9) -> Tensor:
        return _bn_relu(self.bn, self.relu, self.convt(x), train, bn_momentum)


def _same_pads(sizes, window, strides) -> Tuple[Tuple[int, int], ...]:
    """flax's (and TF's) SAME padding per spatial axis: ceil(n / s)
    outputs, the total pad split with the odd element after."""
    pads = []
    for n, k, s in zip(sizes, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _padded(x: Tensor, window, strides, padding: str,
            value: float = 0.0) -> Tensor:
    """Channels-first ``x`` padded on its spatial axes by ``padding``
    ("SAME" or "VALID")."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    pads = _same_pads(x.shape[2:], window, strides)
    return F.pad(x, [p for pair in reversed(pads) for p in pair],
                 value=value)


class Convolution(nn.Module):
    """N-D convolution (rank ``len(kernel_size)``, 1 to 3) with flax's
    ``SAME`` or ``VALID`` padding on a channels-last (B, *spatial, C)
    tensor, computed in the module's compute dtype. ``padding="SAME"``
    with a stride pads as TF does, the odd pad after, which
    ``F.conv*d``'s own ``padding="same"`` (stride 1 only) cannot."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 padding: str = "SAME", dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        if not 1 <= len(self.kernel_size) <= 3:
            raise ValueError(f"Conv takes a 1-, 2- or 3-D kernel, got "
                             f"{self.kernel_size}")
        self.strides = (tuple(strides) if strides is not None
                        else (1,) * len(self.kernel_size))
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_features) + self.kernel_size, dtype=torch.float32,
            device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))
        # Glorot over the flax kernel's fans: receptive field prod(kernel),
        # the same fans as torch's (cout, cin, *kernel) layout gives.
        nn.init.xavier_uniform_(self.weight, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        conv = getattr(F, f"conv{len(self.kernel_size)}d")
        xc = _padded(x.to(self.dtype).movedim(-1, 1), self.kernel_size,
                     self.strides, self.padding)
        y = conv(xc, self.weight.to(self.dtype), self.bias.to(self.dtype),
                 stride=self.strides)
        return y.movedim(1, -1)


class Conv(nn.Module):
    """General N-D convolution + optional BN + ReLU on channels-last
    tensors (the reference's tf_util.conv1d / conv2d / conv3d): the
    layer-library surface beside the pointwise ``PointMLP`` that the
    models use."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 padding: str = "SAME", bn: bool = False, relu: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Convolution(in_features, features, kernel_size, strides,
                                padding, dtype=dtype, device=device,
                                generator=generator)
        self.bn = BatchNorm(features, device=device) if bn else None
        self.relu = relu

    def forward(self, x: Tensor, train: bool = True,
                bn_momentum: float = 0.9) -> Tensor:
        return _bn_relu(self.bn, self.relu, self.conv(x), train, bn_momentum)


def _pool(x: Tensor, kind: str, window: Sequence[int],
          strides: Optional[Sequence[int]], padding: str) -> Tensor:
    window = tuple(window)
    strides = tuple(strides or window)
    pad_value = float("-inf") if kind == "max" else 0.0
    xc = _padded(x.movedim(-1, 1), window, strides, padding, pad_value)
    pool = getattr(F, f"{kind}_pool{len(window)}d")
    return pool(xc, window, strides).movedim(1, -1)


def max_pool(x: Tensor, window: Sequence[int],
             strides: Optional[Sequence[int]] = None,
             padding: str = "VALID") -> Tensor:
    """N-D max pool over the spatial axes of a channels-last tensor
    (tf_util.max_pool2d / max_pool3d); strides default to the window;
    SAME pads with -inf. The models' symmetric pool over all points is a
    max over axis 1; this is the general form."""
    return _pool(x, "max", window, strides, padding)


def avg_pool(x: Tensor, window: Sequence[int],
             strides: Optional[Sequence[int]] = None,
             padding: str = "VALID") -> Tensor:
    """N-D average pool (tf_util.avg_pool2d / avg_pool3d); SAME pads with
    zeros that count in the window's mean, as flax's default."""
    return _pool(x, "avg", window, strides, padding)


class Dropout(nn.Module):
    """Dropout gated on the train flag (tf_util.dropout): in training
    each element is kept with probability ``keep_prob`` and scaled by
    1 / keep_prob, else zeroed; in eval the identity. The mask is drawn
    from ``generator`` (a ``torch.Generator`` on the input's device; the
    default generator when None), so its bits differ from JAX's by
    design."""

    def __init__(self, keep_prob: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= keep_prob <= 1.0:
            raise ValueError(f"keep_prob must be in [0, 1], got {keep_prob}")
        self.keep_prob = keep_prob
        self.generator = generator

    def forward(self, x: Tensor, train: bool = True) -> Tensor:
        if not train or self.keep_prob == 1.0:
            return x
        if self.keep_prob == 0.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < self.keep_prob
        return torch.where(keep, x / self.keep_prob, torch.zeros_like(x))
