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

``PCNAutoencoder`` is PCN (Yuan et al., 3DV 2018), the first family whose
input and target differ: it reads a partial cloud and predicts a coarse
and a fine cloud of the target's size, and its loss (``PCNLoss``) takes
the step counter for its weight schedule.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from pointnet_autoencoder_tpu_torch.nn.decoders import (
    CoarseDecoder,
    FCDecoder,
    FCUpconvDecoder,
    FoldingDecoder,
    HierarchicalDecoder,
    UpconvDecoder,
)
from pointnet_autoencoder_tpu_torch.nn.encoder import (PCNEncoder,
                                                      PointNetEncoder)
from pointnet_autoencoder_tpu_torch.nn.layers import FC, BatchNorm
from pointnet_autoencoder_tpu_torch.ops.chamfer import (
    chamfer_loss,
    chamfer_loss_dense,
    chamfer_sqrt,
    nn_distance,
)
from pointnet_autoencoder_tpu_torch.ops.emd import earth_mover, emd_loss
from pointnet_autoencoder_tpu_torch.ops.fused_encoder import FoldedChain
from pointnet_autoencoder_tpu_torch.parallel import tp
from pointnet_autoencoder_tpu_torch.train.schedules import PiecewiseConstant
from pointnet_autoencoder_tpu_torch.utils import profiling, roofline

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


# PCN's published sizes (models/pcn_emd.py): 1024 coarse points, a 4 x 4
# folding grid of half-width 0.05, so 16,384 fine points.
PCN_NUM_COARSE = 1024
PCN_GRID_SIZE = 4
PCN_GRID_SCALE = 0.05


@contextlib.contextmanager
def _stage(span: str, part: str):
    """One stage of PCN's step: the host span ``span`` while a profiler
    runs, and the ``utils/roofline.StepCost`` part ``part`` (its forward
    ops) while one counts."""
    with profiling.span(span), roofline.region(part):
        yield


class PCNAutoencoder(nn.Module):
    """PCN with its EMD loss (``models/pcn_emd.py``): ``encoder``
    (``PCNEncoder``) reads the (B, N, 3) input to a 1024-wide code,
    ``coarse`` (``CoarseDecoder``) decodes num_coarse points, and
    ``folding`` (``FoldingDecoder``) folds a grid_size x grid_size patch
    around each, num_coarse * grid_size**2 fine points in all (``num_fine``).
    No BatchNorm: ``train`` and ``bn_momentum`` are taken and unused.

    forward(points, train, bn_momentum) -> (fine (B, num_fine, 3) f32,
    {"embedding": the code, "coarse": (B, num_coarse, 3)}). The encoder,
    the coarse decoder and the folding are the host spans
    ``pcn.encoder``, ``pcn.coarse`` and ``pcn.folding`` and the StepCost
    parts ``encoder``, ``coarse`` and ``folding``."""

    def __init__(self, num_point: int, num_coarse: int = PCN_NUM_COARSE,
                 grid_size: int = PCN_GRID_SIZE,
                 grid_scale: float = PCN_GRID_SCALE,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_point = num_point
        self.num_coarse = num_coarse
        self.num_fine = num_coarse * grid_size * grid_size
        self.dtype = dtype
        self.encoder = PCNEncoder(**kw)
        self.coarse = CoarseDecoder(self.num_coarse, **kw)
        self.folding = FoldingDecoder(grid_size, grid_scale, **kw)

    def set_data_group(self, group) -> None:
        """Nothing to share over a data group: the network has no
        BatchNorm statistics."""

    def set_point_group(self, group, data_group=None,
                        stats_group=None) -> None:
        raise ValueError("model 'pcn_emd' does not run under point "
                         "parallelism in this port")

    def forward(self, points: Tensor, train: bool = False,
                bn_momentum: Union[float, Tensor] = 0.9):
        with _stage("pcn.encoder", "encoder"):
            code = self.encoder(points)
        with _stage("pcn.coarse", "coarse"):
            coarse = self.coarse(code)
        with _stage("pcn.folding", "folding"):
            fine = self.folding(code, coarse)
        return fine, {"embedding": code, "coarse": coarse}


class PCNLoss:
    """PCN's loss (``models/pcn_emd.py`` ``create_loss``):
    ``earth_mover(coarse, target[:, :num_coarse])``, the EMD over the
    points averaged over the batch, plus alpha times
    ``chamfer_sqrt(fine, target)``; alpha from ``alpha`` (a
    ``PiecewiseConstant``) at the step counter ``step`` (a 0-dim integer
    tensor), read on its device. Metrics: ``emd_coarse``, ``cd_fine`` and
    the ``alpha`` applied. The two terms are the host spans ``loss.emd``
    and ``loss.chamfer`` and the StepCost parts ``emd`` and ``chamfer``.
    ``reads_step``: the train and eval steps pass ``step``."""

    reads_step = True

    def __init__(self, alpha: PiecewiseConstant):
        self.alpha = alpha

    def __call__(self, pred: Tensor, label: Tensor, end_points: EndPoints,
                 step: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
        coarse = end_points["coarse"]
        with _stage("loss.emd", "emd"):
            emd_coarse = earth_mover(coarse, label[:, :coarse.shape[1]])
        with _stage("loss.chamfer", "chamfer"):
            cd_fine = chamfer_sqrt(pred, label)
        alpha = self.alpha.tensor(step)
        return emd_coarse + alpha * cd_fine, {
            "emd_coarse": emd_coarse, "cd_fine": cd_fine, "alpha": alpha}


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
    and the point counts it can emit.

    ``fold``: for a family that trains on (input, target) pairs (PCN), its
    fixed (num_coarse, grid_size), else None: the batch is its own label.
    The target's points (``gt_points``) are the data's size alone, the
    fine cloud's by default. ``decay_per_step``: the learning rate's
    staircase counts steps, not shapes (PCN's ``lr_decay_steps``).
    ``unsupported``: the paths that refuse the family (``require``).
    ``log_keys``: metrics the Trainer logs beside the loss."""

    name: str
    decoder: str
    loss_fn: LossFn
    neck: Tuple[int, ...] = ()
    point_constraint: Optional[Callable[[int], bool]] = None
    constraint_msg: str = ""
    fold: Optional[Tuple[int, int]] = None
    decay_per_step: bool = False
    unsupported: Tuple[str, ...] = ()
    log_keys: Tuple[str, ...] = ()

    def require(self, path: str) -> None:
        """Raise ValueError if the family does not run on ``path``."""
        if path in self.unsupported:
            raise ValueError(f"model {self.name!r} does not run under "
                             f"{path} in this port")

    def gt_points(self, num_gt_point: Optional[int]) -> Optional[int]:
        """The target's points of a pair family (``num_gt_point``, or the
        fine cloud's size); ValueError for a single-cloud family given one,
        or for a target smaller than the coarse cloud its EMD reads."""
        if self.fold is None:
            if num_gt_point is not None:
                raise ValueError(f"model {self.name!r} trains on its own "
                                 f"input; --num_gt_point applies to "
                                 f"pcn_emd only")
            return None
        num_coarse, grid_size = self.fold
        if num_gt_point is None:
            return num_coarse * grid_size ** 2
        if num_gt_point < num_coarse:
            raise ValueError(f"model {self.name!r}: num_gt_point="
                             f"{num_gt_point} is below its {num_coarse} "
                             f"coarse points")
        return num_gt_point

    def check_num_point(self, num_point: int) -> None:
        """Raise ValueError if the decoder cannot emit ``num_point``."""
        if self.point_constraint and not self.point_constraint(num_point):
            raise ValueError(
                f"model {self.name!r}: num_point={num_point} invalid "
                f"({self.constraint_msg})")

    def make(self, num_point: int, dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None,
             generator: Optional[torch.Generator] = None) -> nn.Module:
        """The network at ``num_point`` input points."""
        self.check_num_point(num_point)
        if self.fold is not None:
            return PCNAutoencoder(num_point, *self.fold, dtype=dtype,
                                  device=device, generator=generator)
        return PointAutoencoder(num_point, decoder=self.decoder,
                                neck=self.neck, dtype=dtype, device=device,
                                generator=generator)
