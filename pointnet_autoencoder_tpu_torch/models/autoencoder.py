"""Point-cloud autoencoder assembly: encoder, neck, decoder and loss.

Counterpart of ``pointnet_autoencoder_tpu/models/autoencoder.py``, with
the same contract:

    forward(points, train, bn_momentum) -> (pred, end_points)
    loss_fn(pred, label, end_points) -> (loss, metrics)

where ``end_points["embedding"]`` is the published latent (the last neck
output, or the encoder's feature where there is no neck) and the decoder's
extras ride beside it (``xyzmap``, ``pc1_xyz``). Every ``--model`` of the
reference is here: the fc, upconv, fc_upconv and hierarchy decoder
families, with the Chamfer x100 loss (on the kernels, or dense for
``model_cpu``), the EMD loss or the hierarchy's two-level Chamfer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from pointnet_autoencoder_tpu_torch.nn.decoders import (
    FCDecoder,
    FCUpconvDecoder,
    HierarchicalDecoder,
    UpconvDecoder,
)
from pointnet_autoencoder_tpu_torch.nn.encoder import PointNetEncoder
from pointnet_autoencoder_tpu_torch.nn.layers import FC, BatchNorm
from pointnet_autoencoder_tpu_torch.ops.chamfer import (
    chamfer_loss,
    chamfer_loss_dense,
    nn_distance,
)
from pointnet_autoencoder_tpu_torch.ops.emd import emd_loss
from pointnet_autoencoder_tpu_torch.ops.fused_encoder import FoldedChain
from pointnet_autoencoder_tpu_torch.parallel import tp

Tensor = torch.Tensor
EndPoints = Dict[str, Tensor]

# Decoder families by registry name; InferenceSession.decode runs one of
# them alone on the 'decoder' submodule.
DECODERS = {
    "fc": FCDecoder,
    "upconv": UpconvDecoder,
    "fc_upconv": FCUpconvDecoder,
    "hierarchy": HierarchicalDecoder,
}


class PointAutoencoder(nn.Module):
    """Encoder + neck + decoder; submodule names follow the reference's
    flax tree (``encoder``, the neck's ``fc00``, ``fc01``, ... at the top
    level, ``decoder``). ``neck`` lists the widths of the FC+BN+ReLU
    layers between the encoder's 1024-d feature and the decoder."""

    def __init__(self, num_point: int, decoder: str = "fc",
                 neck: Tuple[int, ...] = (),
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_point = num_point
        self.dtype = dtype
        self.encoder = PointNetEncoder(**kw)
        width = 1024
        self.neck_names = []
        for i, f in enumerate(neck):
            self.neck_names.append(f"fc0{i}")
            self.add_module(self.neck_names[-1], FC(width, f, bn=True, **kw))
            width = f
        self.decoder = DECODERS[decoder](num_point, in_features=width, **kw)

    def set_data_group(self, group) -> None:
        """Give every BatchNorm (the encoder's fused head included) the
        data-parallel ``group`` (``parallel.mesh.DataGroup``, or None):
        training statistics then cover the global batch. The points are
        not split (``set_point_group`` is undone)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = group
        self.encoder.point_group = None

    def set_point_group(self, group, data_group=None,
                        stats_group=None) -> None:
        """Point parallelism: the ranks of ``group`` (a
        ``parallel.mesh.DataGroup``, or None) each feed their share of
        every shape's points. The encoder's BatchNorms (its fused head
        included) take ``stats_group`` (default ``group``), so their
        statistics cover every point, and the encoder combines its max
        over ``group``; the neck and the decoder see every point of their
        rows and take ``data_group``: None when every rank holds the whole
        batch, the data group under DP x SP, where the rows split over
        it and the statistics are taken over every rank."""
        self.set_data_group(data_group)
        for m in self.encoder.modules():
            if isinstance(m, BatchNorm):
                m.group = group if stats_group is None else stats_group
        self.encoder.point_group = group

    def set_model_group(self, group) -> None:
        """Tensor parallelism: split the decoder's FC layers over the
        model ``group`` (``parallel/tp.py``; a ``parallel.mesh.DataGroup``
        of m > 1 ranks). The model must hold the full weights."""
        tp.shard_model_(self, group)

    def encode(self, points: Tensor, train: bool = False,
               bn_momentum: float = 0.9,
               folded: Optional[FoldedChain] = None) -> Tensor:
        """The encoder and the neck: (B, N, 3) -> the embedding (B, D)."""
        feat = self.encoder(points, train, bn_momentum, folded=folded)
        for name in self.neck_names:
            feat = getattr(self, name)(feat, train, bn_momentum)
        return feat

    def forward(self, points: Tensor, train: bool = False,
                bn_momentum: float = 0.9,
                folded: Optional[FoldedChain] = None):
        """(B, N, 3) -> (pred (B, num_point, 3), end_points), end_points
        holding "embedding" (B, D) and the decoder's extras.

        train: batch statistics, and the BN moving statistics move with
        momentum ``bn_momentum``; else the moving statistics, unchanged.
        folded: the encoder chain from ``encoder.fold()``, to skip folding
        per eval call."""
        feat = self.encode(points, train, bn_momentum, folded=folded)
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


def emd_loss_fn(pred: Tensor, label: Tensor, end_points: EndPoints
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """loss = mean_b EMD(label -> pred), unscaled; Chamfer is still
    reported as the 'pcloss' metric (the reference's
    models/model_emd.py:79-89)."""
    pcloss = chamfer_loss(pred, label)
    return emd_loss(pred, label), {"pcloss": pcloss}


def chamfer_x100_dense_loss(pred: Tensor, label: Tensor,
                            end_points: EndPoints
                            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """``chamfer_x100_loss`` on the dense Chamfer, on every device (the
    reference's models/model_cpu.py: the same loss without the custom
    op)."""
    pcloss = chamfer_loss_dense(pred, label)
    return pcloss * 100.0, {"pcloss": pcloss}


def hierarchy_loss_fn(pred: Tensor, label: Tensor, end_points: EndPoints
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """loss = (chamfer(pred) + 0.1 * chamfer(centers)) * 100 (the
    reference's models/model_hierachy.py:91-104). The center term sums the
    two directional means, over the 64 centers and over the label's
    points. Under data parallelism each rank takes these means over its
    equal shard, so the mean over ranks is still the global batch's."""
    pcloss = chamfer_loss(pred, label)
    d1, _, d2, _ = nn_distance(end_points["pc1_xyz"], label)
    pc1_loss = d1.mean() + d2.mean()
    loss = (pcloss + 0.1 * pc1_loss) * 100.0
    return loss, {"pcloss": pcloss, "pc1loss": pc1_loss}


LossFn = Callable[[Tensor, Tensor, EndPoints],
                  Tuple[Tensor, Dict[str, Tensor]]]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One ``--model`` config: its name, decoder family, neck widths, loss
    and the point counts it can emit."""

    name: str
    decoder: str
    loss_fn: LossFn
    neck: Tuple[int, ...] = ()
    point_constraint: Optional[Callable[[int], bool]] = None
    constraint_msg: str = ""

    def check_num_point(self, num_point: int) -> None:
        """Raise ValueError if the decoder cannot emit ``num_point``."""
        if self.point_constraint and not self.point_constraint(num_point):
            raise ValueError(
                f"model {self.name!r}: num_point={num_point} invalid "
                f"({self.constraint_msg})")

    def make(self, num_point: int, dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None,
             generator: Optional[torch.Generator] = None) -> PointAutoencoder:
        self.check_num_point(num_point)
        return PointAutoencoder(num_point, decoder=self.decoder,
                                neck=self.neck, dtype=dtype, device=device,
                                generator=generator)
