"""Decoder families: fc, upconv, fc_upconv, hierarchy; and PCN's coarse
and folding decoders (``CoarseDecoder``, ``FoldingDecoder``).

Counterpart of ``pointnet_autoencoder_tpu/nn/decoders.py``, with the same
submodule names and output geometry. Each decoder takes the global feature
(the encoder's, or the neck's last output, ``in_features`` wide) and
returns (points (B, P, 3), extras). Its products stay ordinary
``F.linear`` and ``F.conv_transpose2d`` calls, as the reference leaves
them to XLA. The upconv families keep their maps channels-last,
(B, H, W, C), and flatten the final xyz map row-major over (H, W).

The FC layers' names carry their tensor-parallel roles
(``parallel/tp.py``): ``fc1`` and ``fc3`` column-parallel, ``fc2``
row-parallel. ``tp.shard_model_`` gives each its slices and the model
group (the layer runs the collectives, ``nn/layers.py``), and
``tp.parallelize_in_process_`` replaces them for serving; the forward
code here is the same either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from pointnet_autoencoder_tpu_torch.nn.layers import FC, UpConv

Tensor = torch.Tensor


class FCDecoder(nn.Module):
    """1024 -> 1024 -> num_point*3 (the reference's models/model.py:70-73)."""

    def __init__(self, num_point: int, in_features: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_point = num_point
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1 = FC(in_features, 1024, bn=True, **kw)
        self.fc2 = FC(1024, 1024, bn=True, **kw)
        self.fc3 = FC(1024, num_point * 3, relu=False, **kw)

    def forward(self, feat: Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> Tuple[Tensor, dict]:
        x = self.fc1(feat, train, bn_momentum)
        x = self.fc2(x, train, bn_momentum)
        x = self.fc3(x)  # no BN, no ReLU
        return x.reshape(feat.shape[0], self.num_point, 3), {}


def _upconv_stack(module: nn.Module, in_features: int, stages, kw) -> None:
    """``upconv1``..``upconvK`` (BN, ReLU) from (features, kernel, stride)
    stages, then the linear xyz head ``upconv{K+1}`` (3 features, 1x1)."""
    c = in_features
    for i, (f, k, s) in enumerate(stages):
        module.add_module(f"upconv{i + 1}", UpConv(c, f, k, s, **kw))
        c = f
    module.add_module(f"upconv{len(stages) + 1}", UpConv(
        c, 3, (1, 1), (1, 1), bn=False, relu=False, **kw))


def _run_upconvs(module: nn.Module, x: Tensor, count: int, train: bool,
                 bn_momentum: float) -> Tensor:
    for i in range(count):
        x = getattr(module, f"upconv{i + 1}")(x, train, bn_momentum)
    return x


class UpconvDecoder(nn.Module):
    """The 1024-d feature as a (1, 2, 512) map -> 4 transposed convs -> a
    32x64 xyz map = 2048 points (the reference's model_upconv.py:68-81).
    Requires num_point == 2048; ``in_features`` must be 1024."""

    STAGES = (
        (512, (2, 2), (2, 2)),
        (256, (3, 3), (1, 1)),
        (256, (4, 5), (2, 3)),
        (128, (5, 7), (3, 3)),
    )

    def __init__(self, num_point: int, in_features: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_point != 2048:
            raise ValueError("upconv decoder requires num_point == 2048")
        _upconv_stack(self, 512, self.STAGES,
                      dict(dtype=dtype, device=device, generator=generator))

    def forward(self, feat: Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> Tuple[Tensor, dict]:
        b = feat.shape[0]
        xyzmap = _run_upconvs(self, feat.reshape(b, 1, 2, 512),
                              len(self.STAGES) + 1, train, bn_momentum)
        return xyzmap.reshape(b, -1, 3), {"xyzmap": xyzmap}  # (B, 32, 64, 3)


class FCUpconvDecoder(nn.Module):
    """The union of a 1024-point FC branch and a 1024-point upconv branch
    from a 512-d embedding (the reference's model_fc_upconv.py:73-90),
    concatenated in that order. Requires num_point == 2048;
    ``in_features`` must be 512."""

    STAGES = (
        (512, (2, 2), (1, 1)),
        (256, (3, 3), (1, 1)),
        (256, (4, 4), (2, 2)),
        (128, (5, 5), (3, 3)),
    )

    def __init__(self, num_point: int, in_features: int = 512,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_point != 2048:
            raise ValueError("fc_upconv decoder requires num_point == 2048")
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1 = FC(in_features, 512, bn=True, **kw)
        self.fc2 = FC(512, 512, bn=True, **kw)
        self.fc3 = FC(512, 1024 * 3, relu=False, **kw)
        _upconv_stack(self, 512, self.STAGES, kw)

    def forward(self, feat: Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> Tuple[Tensor, dict]:
        b = feat.shape[0]
        x = self.fc1(feat, train, bn_momentum)
        x = self.fc2(x, train, bn_momentum)
        pc_fc = self.fc3(x).reshape(b, -1, 3)
        xyzmap = _run_upconvs(self, feat.reshape(b, 1, 1, 512),
                              len(self.STAGES) + 1, train, bn_momentum)
        pc_upconv = xyzmap.reshape(b, -1, 3)  # (B, 32, 32, 3) -> 1024 points
        return torch.cat([pc_fc, pc_upconv], dim=1), {"xyzmap": xyzmap}


class HierarchicalDecoder(nn.Module):
    """Two stages: 64 centers with a 256-d feature each, then num_point/64
    local offsets per center, moved to the center (the reference's
    model_hierachy.py:75-88). Requires num_point % 64 == 0."""

    def __init__(self, num_point: int, in_features: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_point % 64 != 0:
            raise ValueError(
                "hierarchical decoder requires num_point % 64 == 0")
        self.num_point = num_point
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1 = FC(in_features, 64 * 256, bn=True, **kw)
        self.fc1_xyz = FC(in_features, 64 * 3, relu=False, **kw)
        # The reference's conv1d layers are per-center Dense layers.
        self.fc_conv1 = FC(256, 256, bn=True, **kw)
        self.fc_conv3 = FC(256, num_point // 64 * 3, relu=False, **kw)

    def forward(self, feat: Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> Tuple[Tensor, dict]:
        b = feat.shape[0]
        pc1_feat = self.fc1(feat, train, bn_momentum).reshape(b, 64, 256)
        pc1_xyz = self.fc1_xyz(feat).reshape(b, 64, 3)
        pc2 = self.fc_conv1(pc1_feat, train, bn_momentum)
        pc2_xyz = self.fc_conv3(pc2).reshape(b, 64, -1, 3)
        pc2_xyz = pc2_xyz + pc1_xyz[:, :, None, :]  # local -> global
        return pc2_xyz.reshape(b, self.num_point, 3), {"pc1_xyz": pc1_xyz}


class CoarseDecoder(nn.Module):
    """PCN's coarse decoder (``models/pcn_emd.py`` ``create_decoder``, its
    ``mlp``): the code through 1024 -> 1024 (ReLU each) -> num_coarse * 3,
    linear, as (B, num_coarse, 3) points."""

    def __init__(self, num_coarse: int, in_features: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_coarse = num_coarse
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1 = FC(in_features, 1024, **kw)
        self.fc2 = FC(1024, 1024, **kw)
        self.fc3 = FC(1024, num_coarse * 3, relu=False, **kw)

    def forward(self, code: Tensor) -> Tensor:
        x = self.fc3(self.fc2(self.fc1(code)))
        return x.reshape(code.shape[0], self.num_coarse, 3)


def folding_grid(grid_size: int, grid_scale: float,
                 device: Optional[torch.device] = None) -> Tensor:
    """PCN's folding grid, (grid_size**2, 2) f32: TF's ``meshgrid`` of
    ``linspace(-scale, scale, grid_size)`` twice ("xy" indexing), stacked
    on the last axis and flattened, so row i * grid_size + j is
    (lin[j], lin[i])."""
    lin = torch.linspace(-grid_scale, grid_scale, grid_size,
                         dtype=torch.float32, device=device)
    y, x = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([x, y], dim=2).reshape(-1, 2)


class FoldingDecoder(nn.Module):
    """PCN's folding decoder (``models/pcn_emd.py`` ``create_decoder``,
    scope ``folding``): each coarse point gets a grid_size x grid_size
    patch of 2-D grid offsets; each of the num_coarse * grid_size**2 fine
    rows is [grid (2), its coarse point (3), the code (C)] and goes
    through 512 -> 512 (ReLU each) -> 3, linear, PCN's ``mlp_conv``; the
    coarse point is added back as the patch's centre. Fine row
    c * grid_size**2 + g belongs to coarse point c and grid row g, PCN's
    tiling order. The fine cloud is f32: the matmuls take the layer's
    compute type, and the centre is added in f32.

    The rows are padded with zero columns to a width that is a multiple
    of 8, and ``conv1``'s weight with zero columns to match: a bf16 GEMM over rows of 2 + 3 + 1024 = 1029 elements is
    unaligned, and the library falls back to its slowest kernels for it.
    A zero column adds an exact zero to every product."""

    def __init__(self, grid_size: int = 4, grid_scale: float = 0.05,
                 in_features: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid_size = grid_size
        self.width = 2 + 3 + in_features
        self.padded = -(-self.width // 8) * 8
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = FC(self.width, 512, **kw)
        self.conv2 = FC(512, 512, **kw)
        self.conv3 = FC(512, 3, relu=False, **kw)
        self.register_buffer("grid", folding_grid(grid_size, grid_scale,
                                                  device), persistent=False)

    def forward(self, code: Tensor, coarse: Tensor) -> Tensor:
        b, num_coarse, _ = coarse.shape
        g = self.grid.shape[0]
        dense = self.conv1.dense
        dtype = dense.dtype
        rows = (b, num_coarse, g)
        centre = coarse[:, :, None, :].expand(*rows, 3)
        feat = torch.cat([
            self.grid.to(dtype).expand(*rows, 2), centre.to(dtype),
            code.to(dtype)[:, None, None, :].expand(*rows, code.shape[1]),
            code.new_zeros((), dtype=dtype).expand(
                *rows, self.padded - self.width)], dim=3)
        weight = F.pad(dense.weight.to(dtype), (0, self.padded - self.width))
        x = F.relu(F.linear(feat, weight, dense.bias.to(dtype)))
        x = self.conv3(self.conv2(x))
        fine = x.float() + centre.float()
        return fine.reshape(b, num_coarse * g, 3)
