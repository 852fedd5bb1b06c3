"""Point-cloud autoencoder assembly: encoder and decoder.

Counterpart of ``pointnet_autoencoder_tpu/models/autoencoder.py``, with
the same contract: ``forward(points) -> (pred, end_points)``, where
``end_points["embedding"]`` is the published latent. Ported so far: the
``fc`` decoder family with no neck (``--model model``); the FC necks of
the other families come with them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from pointnet_autoencoder_tpu_torch.nn.decoders import FCDecoder
from pointnet_autoencoder_tpu_torch.nn.encoder import PointNetEncoder
from pointnet_autoencoder_tpu_torch.ops.fused_encoder import FoldedChain

Tensor = torch.Tensor

# Decoder families by registry name; InferenceSession.decode runs one of
# them alone on the 'decoder' submodule.
DECODERS = {"fc": FCDecoder}


class PointAutoencoder(nn.Module):
    """Encoder + decoder; submodule names follow the reference's flax tree
    (``encoder``, ``decoder``)."""

    def __init__(self, num_point: int, decoder: str = "fc",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_point = num_point
        self.dtype = dtype
        self.encoder = PointNetEncoder(**kw)
        self.decoder = DECODERS[decoder](num_point, **kw)

    def forward(self, points: Tensor, train: bool = False,
                folded: Optional[FoldedChain] = None):
        """(B, N, 3) -> (pred (B, num_point, 3), {"embedding": (B, 1024)}).
        ``folded``: the encoder chain from ``encoder.fold()``, to skip
        folding per call."""
        feat = self.encoder(points, train, folded=folded)
        end_points = {"embedding": feat}
        pred, extras = self.decoder(feat, train)
        end_points.update(extras)
        return pred, end_points


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One ``--model`` config: its name and decoder family."""

    name: str
    decoder: str

    def make(self, num_point: int, dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None,
             generator: Optional[torch.Generator] = None) -> PointAutoencoder:
        return PointAutoencoder(num_point, decoder=self.decoder, dtype=dtype,
                                device=device, generator=generator)
