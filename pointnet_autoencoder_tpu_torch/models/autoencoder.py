"""Point-cloud autoencoder assembly: encoder, decoder and loss.

Counterpart of ``pointnet_autoencoder_tpu/models/autoencoder.py``, with
the same contract:

    forward(points, train, bn_momentum) -> (pred, end_points)
    loss_fn(pred, label, end_points) -> (loss, metrics)

where ``end_points["embedding"]`` is the published latent. Ported so far:
the ``fc`` decoder family with no neck and the Chamfer x100 loss
(``--model model``); the FC necks of the other families come with them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from pointnet_autoencoder_tpu_torch.nn.decoders import FCDecoder
from pointnet_autoencoder_tpu_torch.nn.encoder import PointNetEncoder
from pointnet_autoencoder_tpu_torch.ops.chamfer import chamfer_loss
from pointnet_autoencoder_tpu_torch.ops.fused_encoder import FoldedChain

Tensor = torch.Tensor
EndPoints = Dict[str, Tensor]

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
                bn_momentum: float = 0.9,
                folded: Optional[FoldedChain] = None):
        """(B, N, 3) -> (pred (B, num_point, 3), {"embedding": (B, 1024)}).

        train: batch statistics, and the BN moving statistics move with
        momentum ``bn_momentum``; else the moving statistics, unchanged.
        folded: the encoder chain from ``encoder.fold()``, to skip folding
        per eval call."""
        feat = self.encoder(points, train, bn_momentum, folded=folded)
        end_points = {"embedding": feat}
        pred, extras = self.decoder(feat, train, bn_momentum)
        end_points.update(extras)
        return pred, end_points


def chamfer_x100_loss(pred: Tensor, label: Tensor, end_points: EndPoints
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """loss = mean(d_fwd + d_bwd) * 100; metric 'pcloss' is the raw mean
    (the reference's models/model.py:77-83)."""
    pcloss = chamfer_loss(pred, label)
    return pcloss * 100.0, {"pcloss": pcloss}


LossFn = Callable[[Tensor, Tensor, EndPoints],
                  Tuple[Tensor, Dict[str, Tensor]]]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One ``--model`` config: its name, decoder family and loss."""

    name: str
    decoder: str
    loss_fn: LossFn

    def make(self, num_point: int, dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None,
             generator: Optional[torch.Generator] = None) -> PointAutoencoder:
        return PointAutoencoder(num_point, decoder=self.decoder, dtype=dtype,
                                device=device, generator=generator)
