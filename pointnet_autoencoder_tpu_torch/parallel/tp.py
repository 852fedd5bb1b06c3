"""Tensor parallelism over the decoder's FC layers.

Counterpart of ``pointnet_autoencoder_tpu/parallel/tp.py``, with its
rules. The decoder's FC stack holds most of the parameters (fc3 alone is
1024 x num_point*3, 24 MB in f32 at N=2048), and its layers split over the
m ranks of a model group (``parallel.mesh.ProcessMesh``) in the
column/row (Megatron) pattern:

    fc1: column-parallel  weight rows (out) split, with its bias and the
                          following BN's gamma, beta and statistics
    fc2: row-parallel     weight columns (in) split; the bias is added
                          once, after the partial products are summed
    fc3: column-parallel  as fc1; its output gathered at the loss

A column-parallel layer that no row-parallel layer follows gathers its
output: fc3, and ``model_hierachy``'s fc1 (its only sharded layer), whose
output is gathered before the reshape into 64 centers. ``model_upconv``
has no FC stack and replicates; ``model_fc_upconv`` shards its FC branch.
The encoder and the neck stay replicated: their fused-head kernels run on
the rank's rows with whole weights.

The JAX package places the leaves and lets GSPMD insert the collectives;
here each rank is a process, and the collectives are explicit autograd
functions over the model group:

- before a column-parallel layer, ``copy_to_model``: identity forward, and
  backward the sum over the group of the ranks' partial input gradients;
- after a row-parallel layer's partial product, ``reduce_from_model``: the
  sum forward (in f32), identity backward;
- after a gathering layer, ``gather_from_model``: the slices in rank order
  forward, this rank's slice of the cotangent backward.

Every rank of a model group then computes the same loss on the same
gathered prediction, so no cotangent is summed over the model group: the
gradients of the sharded leaves are this rank's slices of the full
gradient, those of the replicated leaves (encoder, neck, fc2's bias and
BN) are the full gradient on every rank, and the Trainer averages both
over the data group only. With no model group every layer runs exactly
its one-device code.

Checkpoints hold the full tensors (``gather_state``), in the one-device
format; ``shard_state`` cuts a full state for a rank.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pointnet_autoencoder_tpu_torch.parallel.sp import gather

Tensor = torch.Tensor

# Decoder FC layers by parallel role. Column-parallel layers split their
# output channels (weight dim 0, bias, and any following BN); row-parallel
# layers split their input channels (weight dim 1) and keep full outputs.
COLUMN_LAYERS = ("fc1", "fc3")
ROW_LAYERS = ("fc2",)
# The row-parallel layer that takes a column-parallel layer's split
# output; without it the column layer gathers.
_ROW_AFTER = {"fc1": "fc2"}
_CHANNEL_LEAVES = ("bias", "gamma", "beta", "mean", "var")


def spec_for_name(name: str) -> Optional[int]:
    """The dimension along which the state-dict entry (or parameter, or
    optimizer slot) ``name`` is split over the model group, or None if it
    is replicated."""
    parts = name.split(".")
    if len(parts) < 3 or parts[0] != "decoder":
        return None
    layer, leaf = parts[1], parts[-1]
    if layer in COLUMN_LAYERS and (leaf == "weight"
                                   or leaf in _CHANNEL_LEAVES):
        return 0
    if layer in ROW_LAYERS and leaf == "weight":
        return 1
    return None


def _check_divisible(name: str, shape, dim: int, model_size: int) -> None:
    if len(shape) <= dim or shape[dim] % model_size != 0:
        raise ValueError(
            f"model_parallel={model_size} does not divide dim {dim} of "
            f"{name} (shape {tuple(shape)}); pick a model-parallel degree "
            f"that divides the decoder widths (powers of 2 up to 64 always "
            f"work for the shipped configs)")


def shard_dims(model: nn.Module, model_size: int,
               prefix: str = "") -> Dict[str, int]:
    """Each split state-dict entry of ``model`` (its names after
    ``prefix``: "decoder." for a decoder alone) with its dimension; raises
    ValueError, naming the entry, if ``model_size`` does not divide it."""
    dims = {}
    for name, t in model.state_dict().items():
        dim = spec_for_name(prefix + name)
        if dim is not None:
            _check_divisible(prefix + name, t.shape, dim, model_size)
            dims[prefix + name] = dim
    return dims


def shard_tensor(t: Tensor, dim: int, rank: int, parts: int) -> Tensor:
    """Rank ``rank``'s contiguous slice of ``t`` along ``dim``."""
    size = t.shape[dim] // parts
    return t.narrow(dim, rank * size, size).contiguous()


def gather_tensor(t: Tensor, dim: int, group) -> Tensor:
    """Every rank's slice of a tensor split along ``dim``, in rank order:
    the full tensor, on every rank (no gradient)."""
    return torch.cat(list(gather(t, group).unbind(0)), dim=dim)


# -- the collectives -------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum_(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.sum_(x.float().contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.size = group.rank, x.shape[-1]
        return gather_tensor(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.size, ctx.size).contiguous(), None


def copy_to_model(x: Tensor, group) -> Tensor:
    """``x`` (replicated over the model group); its gradient is summed over
    the group."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: Tensor, group) -> Tensor:
    """The f32 sum over the model group of the ranks' partial ``x``."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: Tensor, group) -> Tensor:
    """The ranks' last-axis slices, concatenated in rank order."""
    return _GatherFromModel.apply(x, group)


# -- placing a model -------------------------------------------------------


def _fc_roles(decoder: nn.Module):
    """(name, FC layer, role, gathers) of each FC layer of ``decoder``
    with a tensor-parallel role."""
    out = []
    for name in COLUMN_LAYERS + ROW_LAYERS:
        fc = getattr(decoder, name, None)
        if fc is None:
            continue
        role = "column" if name in COLUMN_LAYERS else "row"
        after = _ROW_AFTER.get(name)
        gathers = role == "column" and (after is None
                                        or not hasattr(decoder, after))
        out.append((name, fc, role, gathers))
    return out


def _shard_fc_(fc: nn.Module, name: str, rank: int, parts: int) -> None:
    """Keep rank ``rank``'s slices of the split leaves of the decoder's FC
    layer ``name``, in place."""
    for leaf, t in list(fc.named_parameters()) + list(fc.named_buffers()):
        dim = spec_for_name(f"decoder.{name}.{leaf}")
        if dim is not None:
            t.data = shard_tensor(t.data, dim, rank, parts)


def shard_model_(model: nn.Module, group) -> nn.Module:
    """Split ``model``'s decoder FC layers over the model ``group`` (a
    ``parallel.mesh.DataGroup`` of m ranks) in place: each layer keeps
    this rank's slices of its split leaves and takes its role. The model
    must hold the full tensors (seeded init, or a full checkpoint) and be
    on this rank's device. Raises ValueError, before changing anything,
    if m does not divide a split dimension. Returns the model."""
    shard_dims(model, group.world_size)
    for name, fc, role, gathers in _fc_roles(model.decoder):
        _shard_fc_(fc, name, group.rank, group.world_size)
        fc.set_tensor_parallel(role, group, gathers)
    return model


def _map_state(tree: Dict[str, Any], param_names: Sequence[str],
               fn: Callable[[str, Tensor], Tensor]) -> Dict[str, Any]:
    """A copy of a train state tree ({"model", "optimizer", "step", ...})
    with ``fn(name, tensor)`` applied to every split tensor: the model's
    entries, and the optimizer's slots of split parameters (by name in a
    ``MasterOptimizer`` state, by index into ``param_names``, the model's
    parameter order, in a ``torch.optim`` one)."""
    def one(name, t):
        return fn(name, t) if (torch.is_tensor(t) and t.dim() > 0 and
                               spec_for_name(name) is not None) else t

    out = dict(tree)
    out["model"] = {k: one(k, v) for k, v in tree["model"].items()}
    opt = tree.get("optimizer")
    if opt is not None:
        opt = dict(opt)
        if opt.get("kind") == "master":
            opt["slots"] = {n: {s: one(n, v) for s, v in slots.items()}
                            for n, slots in opt["slots"].items()}
        else:
            opt["state"] = {i: {s: one(param_names[i], v)
                                for s, v in st.items()}
                            for i, st in opt["state"].items()}
        out["optimizer"] = opt
    return out


def gather_state(tree: Dict[str, Any], param_names: Sequence[str],
                 group) -> Dict[str, Any]:
    """The full train state from this rank's (collective over the model
    ``group``: every rank of it calls this)."""
    return _map_state(tree, param_names, lambda n, t: gather_tensor(
        t, spec_for_name(n), group))


def shard_state(tree: Dict[str, Any], param_names: Sequence[str],
                rank: int, parts: int) -> Dict[str, Any]:
    """Rank ``rank``'s slices of a full train state."""
    return _map_state(tree, param_names, lambda n, t: shard_tensor(
        t, spec_for_name(n), rank, parts))


# -- serving in one process ------------------------------------------------


class InProcessFC(nn.Module):
    """A decoder FC layer split over the devices of one serving replica,
    in one process (``inference.py``): shard t holds the slices of model
    index t on ``devices[t]``. A column-parallel layer takes a tensor and
    returns the list of its shards' outputs, or, if it gathers, their
    concatenation on ``devices[0]``; a row-parallel layer takes that list,
    sums its shards' partial products on ``devices[0]`` in rank order (in
    f32), adds the bias once and applies BN and ReLU there."""

    def __init__(self, fc: nn.Module, name: str, role: str, gathers: bool,
                 devices: Sequence[torch.device]):
        super().__init__()
        self.role, self.gathers = role, gathers
        self.devices = list(devices)
        m = len(self.devices)
        shards = []
        for t, dev in enumerate(self.devices):
            shard = copy.deepcopy(fc)
            _shard_fc_(shard, name, t, m)
            shards.append(shard.to(dev))
        self.shards = nn.ModuleList(shards)

    def forward(self, x, train: bool = False, bn_momentum: float = 0.9):
        if train:
            raise ValueError("InProcessFC serves eval forwards only")
        first = self.shards[0]
        if self.role == "row":
            total = None
            for shard, part in zip(self.shards, x):
                dense = shard.dense
                p = F.linear(part.to(dense.dtype), dense.weight.to(
                    dense.dtype)).float().to(self.devices[0])
                total = p if total is None else total + p
            y = (total + first.dense.bias.float()).to(first.dense.dtype)
            return first.activate(y, False, bn_momentum)
        outs = [shard(x.to(dev), False, bn_momentum)
                for shard, dev in zip(self.shards, self.devices)]
        if self.gathers:
            return torch.cat([o.to(self.devices[0]) for o in outs], dim=-1)
        return outs


def parallelize_in_process_(decoder: nn.Module,
                            devices: Sequence[torch.device]) -> nn.Module:
    """Replace ``decoder``'s FC layers that have a tensor-parallel role by
    ``InProcessFC`` layers over ``devices`` (the m devices of one serving
    replica, model index order; one device may repeat); the rest of the
    decoder stays on ``devices[0]``. Raises ValueError if m does not
    divide a split dimension. Returns the decoder."""
    shard_dims(decoder, len(devices), prefix="decoder.")
    for name, fc, role, gathers in _fc_roles(decoder):
        setattr(decoder, name, InProcessFC(fc, name, role, gathers, devices))
    return decoder


def replicated_names(model: nn.Module) -> List[str]:
    """The state-dict entries of ``model`` that every rank of a model group
    holds whole."""
    return [n for n in model.state_dict() if spec_for_name(n) is None]
