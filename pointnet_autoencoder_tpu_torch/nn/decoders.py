"""Decoder families. Ported so far: ``FCDecoder``.

Counterpart of ``pointnet_autoencoder_tpu/nn/decoders.py``. Each decoder
takes the encoder's global feature and returns (points (B, P, 3), extras).
Its products stay ordinary ``F.linear`` calls, as the reference leaves
them to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from pointnet_autoencoder_tpu_torch.nn.layers import FC

Tensor = torch.Tensor


class FCDecoder(nn.Module):
    """1024 -> 1024 -> num_point*3 (the reference's models/model.py:70-73)."""

    def __init__(self, num_point: int, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_point = num_point
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1 = FC(1024, 1024, bn=True, **kw)
        self.fc2 = FC(1024, 1024, bn=True, **kw)
        self.fc3 = FC(1024, num_point * 3, relu=False, **kw)

    def forward(self, feat: Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> Tuple[Tensor, dict]:
        x = self.fc1(feat, train, bn_momentum)
        x = self.fc2(x, train, bn_momentum)
        x = self.fc3(x)  # no BN, no ReLU
        return x.reshape(feat.shape[0], self.num_point, 3), {}
