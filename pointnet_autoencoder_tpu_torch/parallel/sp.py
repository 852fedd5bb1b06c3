"""Point parallelism over ``torch.distributed``: a train step over clouds
whose points are split among the ranks.

Counterpart of ``pointnet_autoencoder_tpu/parallel/sp.py``. k ranks of a
``parallel.mesh.DataGroup`` each hold the whole batch with the points
[r*N/k, (r+1)*N/k) of every shape (N must divide by k); the decoder runs
replicated on every rank, so the prediction (B, M, 3) is the same
everywhere. The JAX package runs one program over a mesh and leaves the
encoder's collectives to GSPMD; here each rank is a process and the
combines are written out:

- The Chamfer distance (``nn_distance_point_sharded``): each rank runs
  ``ops/chamfer.nn_distance`` (K1 on the card, K2 in backward) on its
  points against the whole prediction. Direction 1 (each local point's
  nearest predicted point) stays local. Direction 2 (each predicted
  point's nearest input point) takes the minimum over the ranks, and the
  lowest global index among the ranks that attain it: the unsharded
  kernel's first-min rule, because the shards are contiguous and each
  rank's own argmin is its lowest. Its gradient goes to the winning rank.
- The EMD (``emd_cost_point_sharded``): the dense annealed matching of
  ``ops/emd.emd_forward_plain`` on each rank's rows, with one all-reduce
  of the (B, M) column sums per level (10 in all), in plain PyTorch, as
  the JAX package's is by design: no single kernel spans a collective in
  every level, so K6 is not on this path. The capacities come from the
  global N.
- The encoder (``PointAutoencoder.set_point_group``): BatchNorm of
  conv1-4 and the conv5 head's statistics average their moments over the
  ranks (equal shards: the global statistics); K3 runs on the local
  points and ``max_point_sharded`` takes each channel's global max, the
  lowest rank attaining it winning (the unsharded first argmax), so K4
  runs with the cotangent kept only for the channels this rank wins. In
  eval K5 runs on the local points and ``encoder_eval_point_sharded``
  combines its extrema as max and min over the ranks before the last
  affine: the embedding is the unsharded one bit for bit.

The gradient convention: each rank's loss is its share of the global
loss (the shares sum to it; the Chamfer and EMD functions here return
this rank's share), every combine's backward sums the ranks' cotangents
of its replicated output before keeping the winners', and the Trainer
sums the gradients over the ranks (``DataGroup.sum_gradients``) and the
logged metrics. So the JAX package's trailing psums of the EMD cost and
of its prediction-side gradient are not needed: they ride the metric and
gradient all-reduces.

The combines gather the ranks' candidates with one sum all-reduce: each
rank writes its own into its slot of a buffer of -0.0 (x + -0.0 is x for
every x, -0.0 included), which gloo runs on CUDA tensors; every rank then
picks the same winner locally. ``model_cpu`` keeps its meaning, the
dense Chamfer without a kernel, on every shard (the JAX package's SP loss
sends it through the point-sharded Chamfer of ``model``; the values are
the same).

DP x SP (``make_sp_step_fns(..., batch_axis=...)``, the JAX package's
``batch_axis``; a library API, as there, with no CLI flag): on a (data,
model) grid of ranks (``parallel.mesh.ProcessMesh``) the batch splits over
one axis and the points over the other. The point combines stay within
the point group, the encoder's BN and head moments are taken over every
rank (equal shards of rows and points), the neck's and decoder's over the
batch group, and the gradients and metrics are summed over every rank and
divided by the batch axis's size: summed over the point shares, averaged
over the rows. On a card the step functions are captured programs, as
the Trainer's are (``compiled``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from pointnet_autoencoder_tpu_torch.ops import chamfer
from pointnet_autoencoder_tpu_torch.ops import emd as emdlib
from pointnet_autoencoder_tpu_torch.ops import fused_encoder, fused_head
from pointnet_autoencoder_tpu_torch.parallel.mesh import DATA_AXIS
from pointnet_autoencoder_tpu_torch.train.schedules import Staircase
from pointnet_autoencoder_tpu_torch.train.state import (
    captured_step_fns,
    combined_metrics,
)

Tensor = torch.Tensor
LossFn = Callable[[Tensor, Tensor, Dict[str, Tensor]],
                  Tuple[Tensor, Dict[str, Tensor]]]


def check_points_divisible(num_point: int, world_size: int) -> None:
    if num_point % world_size != 0:
        raise ValueError(
            f"point axis N={num_point} must divide by the point-parallel "
            f"degree {world_size}")


def _check_batch_axis(batch: int, size: int, axis: str) -> None:
    if batch % size != 0:
        raise ValueError(
            f"batch axis B={batch} must divide by mesh axis {axis!r} size "
            f"{size}")


def point_slice(num_point: int, rank: int, world_size: int) -> slice:
    """Rank ``rank``'s points of an N-point cloud."""
    check_points_divisible(num_point, world_size)
    per = num_point // world_size
    return slice(rank * per, (rank + 1) * per)


def gather(x: Tensor, group) -> Tensor:
    """(k, *x.shape): every rank's ``x`` in rank order, by one sum
    all-reduce of a buffer of -0.0 into which each rank writes its own
    slot (exact: x + -0.0 == x bit for bit). No gradient."""
    buf = torch.full((group.world_size,) + tuple(x.shape), -0.0,
                     dtype=x.dtype, device=x.device)
    buf[group.rank] = x.detach()
    return group.sum_(buf)


def _first(hit: Tensor) -> Tensor:
    """The lowest index along dim 0 where ``hit`` (k, ...) is true."""
    k = hit.shape[0]
    ranks = torch.arange(k, device=hit.device).view(
        (k,) + (1,) * (hit.dim() - 1))
    return torch.where(hit, ranks, k).amin(dim=0)


class _FromWinner(torch.autograd.Function):
    """``value``, the combine's result (the same on every rank), as a
    function of this rank's ``local`` candidate: the sum over ranks of
    where(mask_r, local_r, 0). Backward: the ranks' cotangents summed (each
    rank's loss is its share), kept where this rank won."""

    @staticmethod
    def forward(ctx, local, value, mask, group):
        ctx.save_for_backward(mask)
        ctx.group = group
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        mask, = ctx.saved_tensors
        g = ctx.group.sum_(g.contiguous().clone())
        return torch.where(mask, g, 0.0), None, None, None


# -- Chamfer ------------------------------------------------------------------


def nn_distance_point_sharded(xyz1_local: Tensor, xyz2: Tensor, group,
                              dense: bool = False):
    """``ops.chamfer.nn_distance`` with xyz1's point axis split over the
    ranks of ``group``.

    xyz1_local: (B, N/k, 3), this rank's contiguous points of xyz1.
    xyz2: (B, M, 3), the same on every rank.
    dense: per shard the dense Chamfer (``nn_distance_dense``, no kernel).

    Returns (dist1, idx1, dist2, idx2): dist1/idx1 (B, N/k) for the local
    points; dist2/idx2 (B, M), the same on every rank, idx2 the lowest
    global index attaining each minimum. Differentiable in both clouds:
    dist2's gradient goes to the winning rank's points."""
    fn = chamfer.nn_distance_dense if dense else chamfer.nn_distance
    d1, i1, d2_loc, i2_loc = fn(xyz1_local, xyz2)
    with torch.no_grad():
        i2_glob = i2_loc + group.rank * xyz1_local.shape[1]
        every = gather(torch.stack([d2_loc.double(), i2_glob.double()]),
                       group)
        d2_all, i2_all = every[:, 0], every[:, 1]
        d2_min = d2_all.amin(dim=0)
        i2 = torch.where(d2_all == d2_min, i2_all, float("inf")).amin(
            dim=0).int()
        mask = i2_glob == i2
    d2 = _FromWinner.apply(d2_loc, d2_min.float(), mask, group)
    return d1, i1, d2, i2


def chamfer_loss_point_sharded(xyz1_local: Tensor, xyz2: Tensor, group,
                               dense: bool = False) -> Tensor:
    """This rank's share of mean(dist1) + mean(dist2) (the reference's
    ``pcloss``, models/model.py:77-83); the shares sum to the loss."""
    d1, _, d2, _ = nn_distance_point_sharded(xyz1_local, xyz2, group,
                                             dense=dense)
    return (d1.mean() + d2.mean()) / group.world_size


# -- EMD ----------------------------------------------------------------------


class _EmdCostShare(torch.autograd.Function):
    """This rank's rows' share of the EMD cost, with the plan-constant
    gradients of that share saved and scaled by the cotangent."""

    @staticmethod
    def forward(ctx, xyz1_local, xyz2, group):
        n_total = xyz1_local.shape[1] * group.world_size
        cost, grad1, grad2 = emdlib.emd_forward_plain(
            xyz1_local, xyz2, reduce_columns=group.sum_, n_total=n_total)
        ctx.save_for_backward(grad1, grad2)
        return cost

    @staticmethod
    def backward(ctx, g):
        grad1, grad2 = ctx.saved_tensors
        return g[:, None, None] * grad1, g[:, None, None] * grad2, None


def emd_cost_point_sharded(xyz1_local: Tensor, xyz2: Tensor,
                           group) -> Tensor:
    """This rank's share (B,) of the approximate EMD cost of xyz1 against
    xyz2, xyz1's points split over the ranks of ``group`` (N/k of them
    here, xyz2 the same on every rank). The shares sum to
    ``ops.emd.emd_cost`` up to f32 summation order; the gradient of a
    share is that rank's rows' plan-constant gradient. Keeps about six
    (B, N/k, M) f32 buffers live."""
    return _EmdCostShare.apply(*chamfer._prepare(xyz1_local, xyz2), group)


def emd_loss_point_sharded(pred: Tensor, label_local: Tensor,
                           group) -> Tensor:
    """This rank's share of mean over the batch of EMD(label -> pred), the
    reference's EMD training loss (models/model_emd.py:86-88)."""
    return emd_cost_point_sharded(label_local, pred, group).mean()


# -- the encoder --------------------------------------------------------------


def max_point_sharded(local_max: Tensor, group) -> Tensor:
    """The conv5 head's max over every rank's points from each rank's max
    over its own (B, F): the same on every rank. The gradient goes, summed
    over the ranks, to the lowest rank attaining each maximum, the one
    whose points hold the unsharded first argmax."""
    with torch.no_grad():
        every = gather(local_max, group)
        top = every.amax(dim=0)
        mask = _first(every == top) == group.rank
    return _FromWinner.apply(local_max, top, mask, group)


def encoder_eval_point_sharded(points_local: Tensor,
                               chain: fused_encoder.FoldedChain,
                               group) -> Tensor:
    """The eval encoder (K5 on CUDA tensors, its plain version on the CPU)
    on this rank's points, its raw conv5 extrema combined as max and min
    over the ranks, then the last affine and ReLU: (B, F) f32, the
    unsharded ``fused_encoder_eval`` bit for bit."""
    extrema = (fused_encoder.encoder_extrema_cuda if points_local.is_cuda
               else fused_encoder.encoder_extrema_plain)
    every = gather(torch.stack(extrema(points_local, chain)), group)
    return fused_encoder._finish(chain, every[:, 0].amax(dim=0),
                                 every[:, 1].amin(dim=0))


# -- losses -------------------------------------------------------------------


def sp_loss_fn(name: str, group) -> LossFn:
    """The point-sharded twin of the registry's loss of ``--model name``
    (``models/autoencoder.py``): ``loss_fn(pred, label_local,
    end_points)`` returns this rank's shares of the loss and of its
    metrics. The label is the sharded cloud, the prediction the
    replicated one; mean(d_fwd) + mean(d_bwd) is symmetric in the
    argument order, so the values are the unsharded contracts' up to f32
    summation order."""
    dense = name == "model_cpu"

    def pc(label_local, cloud):
        return chamfer_loss_point_sharded(label_local, cloud, group,
                                          dense=dense)

    if name in ("model", "model_cpu", "model_upconv", "model_fc_upconv"):

        def chamfer100(pred, label_local, end_points):
            pcloss = pc(label_local, pred)
            return pcloss * 100.0, {"pcloss": pcloss}

        return chamfer100
    if name == "model_emd":

        def emd_fn(pred, label_local, end_points):
            pcloss = pc(label_local, pred)
            return (emd_loss_point_sharded(pred, label_local, group),
                    {"pcloss": pcloss})

        return emd_fn
    if name == "model_hierachy":

        def hierarchy_fn(pred, label_local, end_points):
            pcloss = pc(label_local, pred)
            pc1 = pc(label_local, end_points["pc1_xyz"])
            loss = (pcloss + 0.1 * pc1) * 100.0
            return loss, {"pcloss": pcloss, "pc1loss": pc1}

        return hierarchy_fn
    raise ValueError(f"no point-sharded loss for config {name!r}")


# -- the train step, and DP x SP ----------------------------------------------


@contextlib.contextmanager
def cudnn_deterministic() -> Iterator[None]:
    """cuDNN's deterministic algorithms within the block; the previous
    setting is restored after it. The decoder runs on every rank of a
    point group and must give each the same prediction: cuDNN's
    transposed convolutions (the upconv decoders) otherwise may pick
    algorithms that add in arrival order."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def point_batch_shard(batch: Tensor, mesh, axis: str = DATA_AXIS,
                      batch_axis: Optional[str] = None) -> Tensor:
    """This rank's part of a global (B, N, 3) batch on ``mesh`` (a
    ``parallel.mesh.ProcessMesh``): its contiguous points along ``axis``
    and, with ``batch_axis``, its contiguous rows along that axis (the JAX
    package's ``point_batch_sharding``). Raises ValueError if the axis
    sizes do not divide B and N."""
    k = mesh.shape[axis]
    out = batch[:, point_slice(batch.shape[1], mesh.index(axis), k)]
    if batch_axis is not None:
        d = mesh.shape[batch_axis]
        _check_batch_axis(batch.shape[0], d, batch_axis)
        per = batch.shape[0] // d
        i = mesh.index(batch_axis)
        out = out[i * per:(i + 1) * per]
    return out.contiguous()


def make_sp_step_fns(state, name: str, bn_schedule: Staircase, mesh,
                     axis: str = DATA_AXIS,
                     batch_axis: Optional[str] = None,
                     compiled: bool = True):
    """(train_step, eval_step) of the point-sharded step of ``--model
    name`` on ``mesh`` (a ``parallel.mesh.ProcessMesh``), the JAX
    package's ``make_sp_step_fns``: each takes this rank's part of a
    global batch (``point_batch_shard(batch, mesh, axis, batch_axis)``),
    its own label, and returns the global batch's loss and metrics on
    every rank. ``state`` is the ``train.state.TrainState`` the train step
    advances; its model is given the groups here.

    axis: the mesh axis whose ranks split the points.
    batch_axis: a second mesh axis whose ranks split the batch (DP x SP);
      None: every rank of ``axis`` holds the whole batch.
    compiled: on a card, each step a captured program per batch shape,
      the JAX package's jitted steps (a tape over gloo, one graph over
      NCCL; the first call of each shape eager, as the warm-up); False,
      or the CPU: the eager step, the reference.
    """
    if batch_axis == axis:
        raise ValueError(f"axis and batch_axis are both {axis!r}")
    point = mesh.group(axis)
    rows = None if batch_axis is None else mesh.group(batch_axis)
    everyone = point if rows is None else mesh.world
    divisor = 1 if rows is None else rows.world_size
    state.model.set_point_group(point, data_group=rows,
                                stats_group=everyone)
    loss_fn = sp_loss_fn(name, point)
    on_card = next(state.model.parameters()).is_cuda
    context = cudnn_deterministic if on_card else contextlib.nullcontext

    def train_step(batch_local: Tensor):
        return combined_metrics(state.train_step(
            batch_local, loss_fn, bn_schedule,
            lambda params: everyone.reduce_gradients(params, divisor),
            context), everyone, divisor)

    def eval_step(batch_local: Tensor):
        return combined_metrics(state.eval_step(batch_local, loss_fn,
                                                context), everyone, divisor)

    if not (compiled and on_card):
        return train_step, eval_step
    return captured_step_fns(state, train_step, eval_step,
                             taped=dist.get_backend() != "nccl")
