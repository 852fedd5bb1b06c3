"""Rank bodies of the port's data-, point- and tensor-parallel tests
(tests/test_torch_dp_*.py, tests/test_torch_parallel.py,
tests/test_torch_sp*.py, tests/test_torch_tp.py,
tests/test_torch_launch.py).

Each function runs in a process that ``parallel.mesh.launch`` spawned, as
``fn(device, *args)`` inside a gloo group, so this module imports neither
JAX nor the JAX package. A rank writes what the test holds to
``<out_dir>/rank<r>.pt``; the test reads the files once every rank has
ended. ``scheduled_rank`` is a process that a test starts as a scheduler
would (``python tests/torch_dp_workers.py scheduled_rank <out_dir>``,
the scheduler's variables in its environment); it joins its group
itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import signal
import sys
import types

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.nn import layers
from pointnet_autoencoder_tpu_torch.nn.layers import BatchNorm
from pointnet_autoencoder_tpu_torch.ops import batch_norm as bn_op
from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
from pointnet_autoencoder_tpu_torch.ops import emd as em
from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
from pointnet_autoencoder_tpu_torch.parallel.mesh import DataGroup
from pointnet_autoencoder_tpu_torch.train.loop import EpochMetrics, Trainer
from pointnet_autoencoder_tpu_torch.train.state import StepPrograms


def _setup(device):
    torch.set_num_threads(2)
    group = DataGroup.current(device)
    return group, group.rank, group.world_size


def _rows(rank: int, world: int, batch: int) -> slice:
    per = batch // world
    return slice(rank * per, (rank + 1) * per)


def _save(out_dir: str, rank: int, obj) -> None:
    torch.save(obj, os.path.join(out_dir, f"rank{rank}.pt"))


def load_ranks(out_dir: str, world: int) -> list:
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- BatchNorm and head_stats under a group ----------------------------------


def stats_rank(device, out_dir, bn_x, bn_w, head_x, head_w, head_b,
               head_gm, head_gv):
    """This rank's rows of ``bn_x`` through a training BatchNorm with the
    group (loss sum(y * bn_w) over its rows) and of ``head_x`` through
    ``head_stats`` with the group (loss sum(mean * head_gm + var *
    head_gv) / k: the statistics are global, so each rank takes a 1/k
    share); saves the outputs, the gradients and the moving statistics.
    Either way the ranks' losses sum to the full batch's."""
    group, rank, world = _setup(device)
    rows = _rows(rank, world, bn_x.shape[0])
    x = torch.from_numpy(bn_x[rows]).requires_grad_(True)
    bn = BatchNorm(bn_x.shape[-1])
    bn.group = group
    y = bn(x, True, 0.5)
    (y * torch.from_numpy(bn_w[rows])).sum().backward()
    hrows = _rows(rank, world, head_x.shape[0])
    hx = torch.from_numpy(head_x[hrows]).requires_grad_(True)
    mean, var = fh.head_stats(hx, torch.from_numpy(head_w),
                              torch.from_numpy(head_b), group=group)
    (((mean * torch.from_numpy(head_gm)).sum()
      + (var * torch.from_numpy(head_gv)).sum()) / world).backward()
    _save(out_dir, rank, {
        "y": y.detach(), "gx": x.grad, "moving": (bn.mean, bn.var),
        "ggamma": bn.gamma.grad, "gbeta": bn.beta.grad,
        "head": (mean.detach(), var.detach()), "head_gx": hx.grad})


# -- one train step, choices shared -------------------------------------------


@contextlib.contextmanager
def relu_through(relu):
    """Within the block, every ReLU of the layers is ``relu``: the one a
    training BatchNorm fuses (``ops/batch_norm.batch_norm_train`` runs
    without it, then ``relu`` takes its output) and ``layers.F.relu``
    (a layer without BN, and eval)."""
    functional, real = layers.F, bn_op.batch_norm_train

    def bn(x, *args, relu_on=False, **kw):
        y = real(x, *args, relu=False, **kw)
        return relu(y) if relu_on else y

    stand_in = types.SimpleNamespace(**vars(functional))
    stand_in.relu = relu
    layers.F = stand_in
    bn_op.batch_norm_train = (
        lambda x, *args, relu=False, **kw: bn(x, *args, relu_on=relu, **kw))
    try:
        yield
    finally:
        layers.F = functional
        bn_op.batch_norm_train = real


@contextlib.contextmanager
def shared_choices(store: dict, replay: bool, rows=slice(None), cols=None):
    """Within the block, a train step's discrete choices (the Chamfer
    argmins, the head's argmax, every ReLU mask) and the EMD's outputs are
    recorded into ``store`` (``replay`` False, the one-device step on the
    global batch) or replayed from it (``replay`` True, a rank's step on
    ``rows`` of that batch), counting in ``store["differed"]`` and
    ``store["made"]`` where the replaying run's own choices differed (a
    kind of choice absent from ``store`` stays the run's own). A
    near-tie falls either way under another summation order of the
    statistics, and one changed choice moves a whole row of a gradient.
    ``cols`` (index, parts): a tensor-parallel rank, whose masks of a
    split layer are its index's slice of the last axis."""
    nn_fn, head_fn, emd_fn = (ch.nn_distance_plain, fh.head_max_plain,
                              em.emd_forward_plain)
    store.setdefault("differed", 0)
    store.setdefault("made", 0)
    seen = {}

    def take(key, own):
        calls = seen.setdefault(key, 0)
        seen[key] = calls + 1
        if not replay:
            store.setdefault(key, []).append(own.detach().clone())
            return own
        if key not in store:  # a kind of choice not recorded: its own
            return own
        want = store[key][calls][rows]
        if cols is not None and want.shape[-1] != own.shape[-1]:
            width = own.shape[-1]
            want = want[..., cols[0] * width:(cols[0] + 1) * width]
        store["differed"] += int((own != want).sum())
        store["made"] += own.numel()
        return want.to(own.dtype)

    def nn(a, b):
        d1, i1, d2, i2 = nn_fn(a, b)
        return d1, take("idx1", i1), d2, take("idx2", i2)

    def head(x, w, scale, shift):
        maxout, argmax = head_fn(x, w, scale, shift)
        return maxout, take("argmax", argmax)

    def emd(x1, x2):
        own = emd_fn(x1, x2)
        if not replay:
            store["emd"] = [t.clone() for t in own]
            return own
        return tuple(t[rows] for t in store["emd"])

    def relu(x):
        mask = take("relu", x > 0)
        return x * mask.to(x.dtype)

    patched = ((ch, "nn_distance_plain", nn_fn, nn),
               (fh, "head_max_plain", head_fn, head),
               (em, "emd_forward_plain", emd_fn, emd))
    for mod, name, _, fn in patched:
        setattr(mod, name, fn)
    try:
        with relu_through(relu):
            yield
    finally:
        for mod, name, fn, _ in patched:
            setattr(mod, name, fn)


def step(model_name: str, num_point: int, state_dict, batch, momentum,
         choices: dict, group=None, rows=slice(None), replay=None):
    """One train step's forward, loss and backward (and, with a group, the
    gradient all-reduce) of ``model_name`` from ``state_dict`` on ``rows``
    (a slice or an index array) of ``batch``, the choices recorded into
    ``choices`` or, under a group or with ``replay``, replayed from it.
    Returns the loss, the metrics, every gradient and the new BN
    statistics; under a group the loss and metrics are the ranks'
    mean."""
    spec = get_model_spec(model_name)
    model = spec.make(num_point)
    model.load_state_dict(state_dict)
    model.set_data_group(group)
    x = torch.from_numpy(np.ascontiguousarray(batch[rows]))
    if replay is None:
        replay = group is not None
    with shared_choices(choices, replay=replay, rows=rows):
        pred, end_points = model(x, train=True, bn_momentum=momentum)
        loss, metrics = spec.loss_fn(pred, x, end_points)
        loss.backward()
    if group is not None:
        group.average_gradients(model.parameters())
    scalars = {"loss": loss.detach(), **{k: v.detach()
                                          for k, v in metrics.items()}}
    names = sorted(scalars)
    values = torch.stack([scalars[k].float() for k in names])
    if group is not None:
        values = group.sum_(values) / group.world_size
    return {"scalars": dict(zip(names, values.tolist())),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "flips": (choices.get("differed", 0), choices.get("made", 0))}


def step_rank(device, cases_path, out_dir):
    """``step`` of every case in ``cases_path`` on this rank's rows."""
    group, rank, world = _setup(device)
    cases = torch.load(cases_path, weights_only=False)
    out = {}
    for name, case in cases.items():
        choices = dict(case["choices"], differed=0, made=0)
        out[name] = step(case["model"], case["num_point"], case["state"],
                         case["batch"], case["momentum"], choices, group,
                         _rows(rank, world, case["batch"].shape[0]))
    _save(out_dir, rank, out)


# -- the Trainer --------------------------------------------------------------


def _rank_state(trainer) -> dict:
    return {"step": trainer.state.step,
            "state": {k: v.clone() for k, v in
                      trainer.model.state_dict().items()},
            "start_epoch": trainer.start_epoch}


def trainer_rank(device, config_json, out_dir, snapshot_dir,
                 resume_epochs):
    """A Trainer of ``config_json`` on this rank: train; rank 0 copies the
    run's log directory to ``snapshot_dir``; then a second Trainer resumes
    (``resume=True``) and trains to ``resume_epochs``. Saves each one's
    step, weights and start epoch."""
    group, rank, _ = _setup(device)
    cfg = TrainConfig.from_json(config_json)
    first = Trainer(cfg, device=device)
    first.train()
    first.close()
    if rank == 0:
        shutil.copytree(cfg.log_dir, snapshot_dir)
    group.barrier()
    again = Trainer(dataclasses.replace(cfg, resume=True,
                                        max_epoch=resume_epochs),
                    device=device)
    resumed_at = _rank_state(again)
    again.train()
    again.close()
    _save(out_dir, rank, {"first": _rank_state(first),
                          "resumed_at": resumed_at,
                          "resumed": _rank_state(again)})


def preempt_rank(device, config_jsons, out_dir, signal_step):
    """For each config of ``config_jsons``, a Trainer on this rank where
    rank 1 alone sends itself SIGTERM after its step ``signal_step``;
    then a resume at the same degree trains to ``max_epoch``. Saves, per
    config, where each stopped and where the resume started."""
    _, rank, _ = _setup(device)
    _save(out_dir, rank, [_preempted_run(device, rank, json_text,
                                         signal_step)
                          for json_text in config_jsons])


def _preempted_run(device, rank, config_json, signal_step):
    cfg = TrainConfig.from_json(config_json)
    trainer = Trainer(cfg, device=device)
    step_fn = trainer.train_step

    def train_step(batch):
        out = step_fn(batch)
        if rank == 1 and trainer.state.step == signal_step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = train_step
    trainer.train()
    stopped = _rank_state(trainer)
    trainer.close()
    again = Trainer(dataclasses.replace(cfg, resume=True), device=device)
    resumed_at = _rank_state(again)
    again.train()
    again.close()
    return {"stopped": stopped, "resumed_at": resumed_at,
            "resumed": _rank_state(again)}


# -- point parallelism --------------------------------------------------------


def sp_ops_rank(device, out_dir, cases):
    """The point-sharded ops of ``parallel/sp.py`` on this rank's points of
    each case (numpy arrays): the Chamfer forward and its loss's
    gradients, the tie case, the EMD cost and its loss's gradients, the
    conv5 head's combined max with the gradients of sum(feat * g) / k, and the eval encoder's combined embedding. Saves
    each rank's outputs and its gradient shares."""
    from pointnet_autoencoder_tpu_torch.parallel import sp

    group, rank, world = _setup(device)
    out = {}

    def local(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[:, sp.point_slice(a.shape[1], rank, world)]))

    for name in ("chamfer", "tie"):
        x, y = cases[name]
        out[name] = [t.clone() for t in sp.nn_distance_point_sharded(
            local(x), torch.from_numpy(y), group)]
    x, y = cases["chamfer"]
    xl = local(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    share = sp.chamfer_loss_point_sharded(xl, yt, group)
    share.backward()
    out["chamfer_loss"] = (share.detach(), xl.grad, yt.grad)
    x, y = cases["emd"]
    xl = local(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    cost = sp.emd_cost_point_sharded(xl, yt, group)
    loss = sp.emd_loss_point_sharded(yt, xl, group)
    loss.backward()
    out["emd"] = (cost.detach(), loss.detach(), xl.grad, yt.grad)
    hx, hw, hb, gamma, beta, mean, var, g = (
        torch.from_numpy(a) for a in cases["head"])
    xl = local(hx.numpy()).requires_grad_(True)
    params = [t.clone().requires_grad_(True) for t in (hw, hb, gamma, beta)]
    feat = sp.max_point_sharded(fh.fused_dense_bn_relu_max(
        xl, *params, mean, var), group)
    ((feat * g).sum() / world).backward()
    out["head_grad"] = (feat.detach(), xl.grad, [p.grad for p in params])
    state, points = cases["eval"]
    model = get_model_spec("model").make(points.shape[1])
    model.load_state_dict(state)
    with torch.no_grad():
        out["eval"] = sp.encoder_eval_point_sharded(
            local(points), model.encoder.fold(), group)
    _save(out_dir, rank, out)


def sp_step(model_name: str, num_point: int, state_dict, batch, momentum,
            group=None, choices=None, points=slice(None)):
    """One point-sharded train step's forward, loss, backward and gradient
    sum of ``model_name`` from ``state_dict`` on this rank's points of
    ``batch``, as the Trainer runs it; without a group the plain step on
    ``batch[:, points]`` (a slice or an index tensor). With ``choices``
    the one-device step's (``step``) are replayed (``replayed_choices``).
    Returns the loss and metrics (summed over the
    ranks), every gradient and the new BN statistics."""
    from pointnet_autoencoder_tpu_torch.parallel import sp

    spec = get_model_spec(model_name)
    model = spec.make(num_point)
    model.load_state_dict(state_dict)
    loss_fn = spec.loss_fn
    if group is not None:
        points = sp.point_slice(batch.shape[1], group.rank, group.world_size)
        model.set_point_group(group)
        loss_fn = sp.sp_loss_fn(model_name, group)
    x = torch.from_numpy(np.ascontiguousarray(batch[:, points]))
    replay = contextlib.nullcontext() if choices is None else \
        replayed_choices(choices, batch.shape[1], points,
                         label_first=group is not None)
    with replay:
        pred, end_points = model(x, train=True, bn_momentum=momentum)
        loss, metrics = loss_fn(pred, x, end_points)
        loss.backward()
    scalars = {"loss": loss.detach(), **{k: v.detach()
                                          for k, v in metrics.items()}}
    names = sorted(scalars)
    values = torch.stack([scalars[k].float() for k in names])
    if group is not None:
        group.sum_gradients(model.parameters())
        values = group.sum_(values)
    return {"scalars": dict(zip(names, values.tolist())),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


@contextlib.contextmanager
def replayed_choices(store: dict, num_points: int, points,
                     label_first: bool):
    """Within the block a step takes the one-device step's discrete
    choices that ``shared_choices`` recorded into ``store``, at the points
    ``points`` (a slice or an index tensor) of the input clouds: every
    ReLU mask, (B, num_points, C) masks taken at ``points``, and the
    Chamfer argmins. A call ``nn_distance_plain(label, cloud)`` on those
    points of the label (a point-parallel rank's shard, or the whole
    label reordered) takes the recorded nearest point of ``cloud`` for
    each of its label points, and for each point of ``cloud`` the
    recorded nearest label point if it is among them; elsewhere that
    distance is +inf, so that the ranks' combine picks the recorded
    shard. A near-tie falls either way under another summation order,
    and with the decoders' near-duplicate points at init (the upconv
    families) many do."""
    nn_fn = ch.nn_distance_plain
    calls = {"relu": 0, "nn": 0}
    order = torch.arange(num_points)[points]
    position = torch.full((num_points,), -1, dtype=torch.long)
    position[order] = torch.arange(len(order))

    def relu(x):
        want = store["relu"][calls["relu"]]
        calls["relu"] += 1
        if want.dim() == 3 and want.shape[1] == num_points:
            want = want[:, points]
        return x * want.to(x.dtype)

    def nn(a, b):
        # A point-parallel rank calls (label shard, cloud); the plain
        # step (cloud, label).
        label, cloud = (a, b) if label_first else (b, a)
        own = nn_fn(a, b)
        c = calls["nn"]
        calls["nn"] += 1
        to_cloud = store["idx2"][c][:, points].to(torch.int32)
        local = position[store["idx1"][c].long()]
        won = local >= 0
        to_label = torch.where(won, local, 0)
        near = torch.gather(label, 1, to_label[..., None].expand(-1, -1, 3))
        sq = (cloud - near) ** 2
        dist = torch.where(won, (sq[..., 0] + sq[..., 1]) + sq[..., 2],
                           float("inf"))
        to_label = to_label.to(torch.int32)
        if label_first:
            return own[0], to_cloud, dist, to_label
        return dist, to_label, own[2], to_cloud

    ch.nn_distance_plain = nn
    try:
        with relu_through(relu):
            yield
    finally:
        ch.nn_distance_plain = nn_fn


def sp_step_rank(device, cases_path, out_dir):
    """``sp_step`` of every case in ``cases_path`` on this rank's points."""
    group, rank, _ = _setup(device)
    cases = torch.load(cases_path, weights_only=False)
    out = {name: sp_step(case["model"], case["num_point"], case["state"],
                         case["batch"], case["momentum"], group,
                         case.get("choices"))
           for name, case in cases.items()}
    _save(out_dir, rank, out)


def bf16_ranks_rank(device, config_jsons, out_dir, steps):
    """For each config, a Trainer on this rank takes ``steps`` steps on
    its share of the pipeline's batches; saves the weights and slots."""
    _, rank, _ = _setup(device)
    out = []
    for text in config_jsons:
        tr = Trainer(TrainConfig.from_json(text), device=device)
        batches = (tr._assemble(tr.train_pipe, tr.train_device, idxs,
                                rotate=True)
                   for idxs in tr.train_pipe.epoch())
        for _ in range(steps):
            tr.train_step(next(batches))
        out.append({"sp": tr.sp_active, "state": tr.state.state_dict(),
                    "batch_shape": tuple(next(batches).shape)})
        tr.close()
    _save(out_dir, rank, out)


def save_state(out_dir, trainer):
    """``after`` of a ``cli.train`` run: this rank's step, weights and
    whether the point-parallel step ran."""
    _save(out_dir, trainer.rank, {
        "step": trainer.state.step, "sp": trainer.sp_active,
        "state": {k: v.clone() for k, v in
                  trainer.model.state_dict().items()}})


# -- tensor parallelism and DP x SP -------------------------------------------


def _gathered(t, name, group):
    from pointnet_autoencoder_tpu_torch.parallel import tp

    dim = tp.spec_for_name(name)
    return t.clone() if dim is None or group is None else \
        tp.gather_tensor(t, dim, group)


def tp_step_rank(device, cases_path, out_dir, model_parallel):
    """One f32 train step's forward, loss, backward and gradient average of
    every case in ``cases_path`` on a (k/m, m) grid: this rank's rows (its
    data index's) with the decoder's FC layers split over its model group,
    the one-device step's choices replayed. Saves the loss and metrics
    (the data group's mean), the gradients and BN statistics gathered
    over the model group, the shapes of this rank's leaves, and its
    replicated leaves' gradients."""
    from pointnet_autoencoder_tpu_torch.parallel import tp
    from pointnet_autoencoder_tpu_torch.parallel.mesh import ProcessMesh

    torch.set_num_threads(2)
    grid = ProcessMesh(device, model_parallel)
    data = grid.data if grid.data.world_size > 1 else None
    d = grid.shape["data"]
    cases = torch.load(cases_path, weights_only=False)
    out = {}
    for name, case in cases.items():
        spec = get_model_spec(case["model"])
        model = spec.make(case["num_point"])
        model.load_state_dict(case["state"])
        model.set_data_group(data)
        model.set_model_group(grid.model)
        rows = _rows(grid.data_index, d, case["batch"].shape[0])
        x = torch.from_numpy(np.ascontiguousarray(case["batch"][rows]))
        choices = dict(case["choices"], differed=0, made=0)
        with shared_choices(choices, replay=True, rows=rows,
                            cols=(grid.model_index, model_parallel)):
            pred, end_points = model(x, train=True,
                                     bn_momentum=case["momentum"])
            loss, metrics = spec.loss_fn(pred, x, end_points)
            loss.backward()
        if data is not None:
            data.average_gradients(model.parameters())
        scalars = {"loss": loss.detach(), **{k: v.detach()
                                              for k, v in metrics.items()}}
        names = sorted(scalars)
        values = torch.stack([scalars[k].float() for k in names])
        if data is not None:
            values = data.sum_(values) / d
        params = dict(model.named_parameters())
        out[name] = {
            "scalars": dict(zip(names, values.tolist())),
            "grads": {n: _gathered(p.grad, n, grid.model)
                      for n, p in params.items()},
            "buffers": {n: _gathered(b, n, grid.model)
                        for n, b in model.named_buffers()},
            "shapes": {n: tuple(p.shape) for n, p in params.items()},
            "replicated": {n: params[n].grad.clone()
                           for n in tp.replicated_names(model)
                           if n in params},
            "flips": (choices["differed"], choices["made"])}
    _save(out_dir, grid.world.rank, out)


def tp_trainer_rank(device, config_json, out_dir):
    """A Trainer of ``config_json`` (model parallel) on this rank: the
    dtype and shape of its fc1 weight and its optimizer slot, one
    ``train()``, then its model state and best eval loss."""
    torch.set_num_threads(2)
    tr = Trainer(TrainConfig.from_json(config_json), device=device)
    w = tr.model.decoder.fc1.dense.weight
    opt = tr.state.optimizer.state_dict()
    slot = (opt["slots"]["decoder.fc1.dense.weight"]["exp_avg"]
            if opt.get("kind") == "master" else None)
    before = {"fc1": (w.dtype, tuple(w.shape)),
              "slot": None if slot is None else (slot.dtype,
                                                 tuple(slot.shape))}
    best = tr.train()
    out = {"before": before, "best": best, "rank": tr.rank,
           "model_index": tr.mesh.model_index,
           "state": {k: v.clone() for k, v in
                     tr.model.state_dict().items()}}
    tr.close()
    _save(out_dir, tr.rank, out)


def dp_sp_rank(device, cases_path, out_dir):
    """DP x SP on a (2 data, k/2 model) grid: the batch split over the
    data axis and the points over the model axis. The point-sharded
    Chamfer and EMD of ``case["losses"]`` (this rank's shares and their
    gradients), then one f32 step of each model case through
    ``sp.make_sp_step_fns(..., axis=MODEL_AXIS, batch_axis=DATA_AXIS)``:
    its metrics, gradients and BN statistics, the one-device step's ReLU
    masks and Chamfer argmins replayed at this rank's rows and points."""
    from pointnet_autoencoder_tpu_torch.parallel import mesh as meshlib
    from pointnet_autoencoder_tpu_torch.parallel import sp
    from pointnet_autoencoder_tpu_torch.train import schedules
    from pointnet_autoencoder_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )

    torch.set_num_threads(2)
    grid = meshlib.ProcessMesh(device, 2)
    axes = (meshlib.MODEL_AXIS, meshlib.DATA_AXIS)
    point = grid.model
    cases = torch.load(cases_path, weights_only=False)
    out = {}
    x, y = (torch.from_numpy(a) for a in cases["losses"])
    xl = sp.point_batch_shard(x, grid, *axes).requires_grad_(True)
    per = y.shape[0] // grid.shape["data"]
    yl = y[grid.data_index * per:(grid.data_index + 1) * per].clone()
    yl.requires_grad_(True)
    share = sp.chamfer_loss_point_sharded(xl, yl, point)
    (share / grid.shape["data"]).backward()
    cost = sp.emd_cost_point_sharded(xl.detach(), yl.detach(), point)
    try:
        sp.point_batch_shard(x[:3], grid, *axes)
        refused = None
    except ValueError as e:
        refused = str(e)
    out["losses"] = dict(share=share.detach(), gx=xl.grad, gy=yl.grad,
                         cost=cost, refused=refused)
    for name, case in cases["steps"].items():
        model = get_model_spec(case["model"]).make(case["num_point"])
        model.load_state_dict(case["state"])
        batch = case["batch"].shape[0]
        state = TrainState(model, make_optimizer("adam", model.parameters()),
                           schedules.learning_rate_schedule(
                               0.001, 0.7, batch, 200000))
        # The BN momentum, constant: a staircase of rate 1.
        step, _ = sp.make_sp_step_fns(
            state, case["model"],
            schedules.Staircase(case["momentum"], 1.0, 1, 1), grid, *axes)
        xb = sp.point_batch_shard(torch.from_numpy(case["batch"]), grid,
                                  *axes)
        per = batch // grid.shape["data"]
        rows = slice(grid.data_index * per, (grid.data_index + 1) * per)
        # The one-device step's choices at this rank's rows.
        store = {k: [t[rows] for t in v] for k, v in case["choices"].items()
                 if isinstance(v, list)}
        points = sp.point_slice(case["batch"].shape[1], grid.model_index,
                                grid.shape["model"])
        with replayed_choices(store, case["batch"].shape[1], points,
                              label_first=True):
            metrics = step(xb)
        out[name] = {
            "scalars": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in
                      model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "shape": tuple(xb.shape)}
    _save(out_dir, grid.world.rank, out)


def tp_trainer_step_rank(device, config_json, batch, out_dir):
    """A model-parallel Trainer of ``config_json`` on this rank takes one
    step on its rows of ``batch``; saves the metrics as the Trainer logs
    them (the data group's mean) and its full state (gathered over the
    model group)."""
    torch.set_num_threads(2)
    tr = Trainer(TrainConfig.from_json(config_json), device=device)
    metrics = EpochMetrics(1, tr.device)
    metrics.put(tr.train_step(torch.from_numpy(batch[tr._rows])))
    means, = tr._fetch_windows(metrics, [(0, 1)])
    full = tr._full_state()
    tr.close()
    _save(out_dir, tr.rank, {"means": means, "model": full["model"]})


# -- the tape of a gloo rank's step, on the CPU -------------------------------


# In-place ops that change a tensor's geometry and not its data.
METADATA_OPS = {"squeeze_", "unsqueeze_", "t_", "transpose_", "swapdims_",
                "swapaxes_", "as_strided_", "detach_"}


class OpRecorder(TorchDispatchMode):
    """What a CUDA graph does, for stand-in graphs on the CPU: while a
    graph of this recorder is open (``current``), every aten op that runs
    is recorded with its arguments and outputs, and storages that existed
    before the program and that an op writes are saved, to be restored
    when the graph ends (a capture leaves the state as it found it). An
    op that gives the host a value (a sync) fails the recording: replays
    could not read it. Active while the program's function runs (the
    backward's nodes see the mode the backward was called under)."""

    def __init__(self):
        super().__init__()
        self.current = None
        self.made = set()
        self.saved = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        graph = self.current
        if graph is None or func.namespace == "profiler":
            # Nothing open, or a host-side annotation.
            return func(*args, **kwargs)
        inputs = {t.untyped_storage().data_ptr()
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in (value if isinstance(value, (list, tuple))
                      else [value]):
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    ptr = st.data_ptr()
                    if ptr not in self.made and ptr not in self.saved:
                        self.saved[ptr] = (st, st.clone())
        out = func(*args, **kwargs)
        if func.overloadpacket.__name__ in METADATA_OPS:
            # Already applied to the recorded tensors: a replay keeps it.
            return out
        geometries = []
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                ptr = t.untyped_storage().data_ptr()
                if ptr not in inputs:
                    self.made.add(ptr)
                geometries.append((t.shape, t.stride(),
                                   t.storage_offset()))
            elif isinstance(t, (bool, int, float, complex)):
                raise RuntimeError(f"{func} gives the host a value inside a "
                                   f"captured stretch")
            else:
                geometries.append(None)
        # The output's geometry as the op made it (a later in-place view
        # op, such as matmul's squeeze_, may change the tensor's).
        graph.ops.append((func, args, kwargs, out, geometries))
        return out


class OpGraph:
    """A stand-in graph of ``recorder``: ``begin``/``end`` (and
    ``capture``) record the ops between them; ``replay`` runs them again
    on the same tensors, each output copied into the recorded one, and
    notes its index in ``log``."""

    def __init__(self, recorder: OpRecorder, log: list, index: int):
        self.recorder, self.log, self.index = recorder, log, index
        self.ops = []

    def begin(self):
        self.log.append(("begin", self.index))
        self.recorder.current = self

    def end(self):
        rec = self.recorder
        rec.current = None
        with torch.no_grad():
            for st, copy in rec.saved.values():
                st.copy_(copy)
        rec.saved.clear()

    @contextlib.contextmanager
    def capture(self):
        self.begin()
        try:
            yield
        finally:
            self.end()

    def replay(self):
        self.log.append(("graph", self.index))
        with torch.no_grad():
            for func, args, kwargs, out, geometries in self.ops:
                new = func(*args, **kwargs)
                for old, fresh, geometry in zip(tree_flatten(out)[0],
                                                tree_flatten(new)[0],
                                                geometries):
                    if (isinstance(old, torch.Tensor)
                            and old.untyped_storage().data_ptr()
                            != fresh.untyped_storage().data_ptr()):
                        torch.as_strided(old, *geometry).copy_(fresh)

    def reset(self):
        self.ops = []


class TapeCache:
    """``ProgramCache``'s calls with ``OpGraph``s: the warm-up runs the
    function, and each program is a tape (``taped``) whose function runs
    under a fresh ``OpRecorder``. ``log`` notes each graph's capture and
    replay, and each collective (``counting_collectives``)."""

    taped = True

    def __init__(self, log: list):
        self.log = log
        self.programs = {}

    def warm_up(self, fn):
        return fn()

    def program(self, key, fn, inputs=(), generators=()):
        from pointnet_autoencoder_tpu_torch.utils import graphs

        if key not in self.programs:
            recorder = OpRecorder()
            made = []

            def graph():
                made.append(OpGraph(recorder, self.log, len(made)))
                return made[-1]

            def recorded(*static):
                with recorder:
                    return fn(*static)

            self.programs[key] = graphs.CapturedProgram(
                recorded, graph(), tuple(t.clone() for t in inputs), graph)
        return self.programs[key]

    def clear(self):
        self.programs.clear()

    close = clear


@contextlib.contextmanager
def counting_collectives(log: list):
    """Within the block, every ``torch.distributed.all_reduce`` notes
    ``("collective",)`` in ``log``."""
    import torch.distributed as dist

    real = dist.all_reduce

    def all_reduce(*args, **kwargs):
        log.append(("collective",))
        return real(*args, **kwargs)

    dist.all_reduce = all_reduce
    try:
        yield
    finally:
        dist.all_reduce = real


@contextlib.contextmanager
def simulated_launches():
    """Within the block, each kernel's plain version (the CPU's route)
    adds one to its CUDA wrapper's launch counter, as a launch on a card
    would."""
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe

    pairs = ((ch, "nn_distance_plain", ch.nn_distance_cuda),
             (ch, "nn_distance_grad_plain", ch.nn_distance_grad_cuda),
             (fh, "head_max_plain", fh.head_max_cuda),
             (fh, "head_bwd_plain", fh.head_bwd_cuda),
             (fe, "encoder_extrema_plain", fe.encoder_extrema_cuda))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]

    def counting(fn, counter):
        def call(*args, **kwargs):
            counter.launches += 1
            return fn(*args, **kwargs)
        return call

    for (mod, name, counter), (_, _, fn) in zip(pairs, saved):
        setattr(mod, name, counting(fn, counter))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def tape_rank(device, config_jsons, batch, out_dir, steps):
    """For each config of ``config_jsons`` (by tag), ``steps`` train steps
    of a Trainer on this rank's part of ``batch`` (its rows, or its points
    under point parallelism), eager and then through a tape
    (``TapeCache``: the first step is the eager warm-up, the second
    captures, every step after it replays), each with the kernels'
    launches simulated: each step's metrics, the collectives each eager
    step issued, the tape's graphs and collectives, the log of its
    capture and replays, the launches, and the final parameters and BN
    statistics."""
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.utils import graphs

    torch.set_num_threads(2)
    counters = (ch.nn_distance_cuda, ch.nn_distance_grad_cuda,
                fh.head_max_cuda, fh.head_bwd_cuda, fe.encoder_extrema_cuda)
    out = {}
    for tag, config_json in config_jsons.items():
        res = {}
        for taped in (False, True):
            tr = Trainer(TrainConfig.from_json(config_json), device=device)
            x = torch.from_numpy(batch)[tr._rows][:, tr._points].contiguous()
            log = []
            if taped:
                tr._steps = StepPrograms(tr.state, TapeCache(log))
            for fn in counters:
                fn.launches = 0
            losses, per_step = [], []
            with simulated_launches(), counting_collectives(log):
                for _ in range(steps):
                    mark = len(log)
                    losses.append(tr.train_step(x)["loss"].clone())
                    per_step.append(log[mark:])
            run = dict(
                losses=losses, log=per_step,
                launches=[fn.launches for fn in counters],
                params={n: p.detach().clone()
                        for n, p in tr.model.named_parameters()},
                buffers={n: b.clone() for n, b in tr.model.named_buffers()},
                step=tr.state.step, recording=graphs._recording)
            if taped:
                prog, = tr._steps.programs.programs.values()
                run.update(graphs=prog.graphs, collectives=prog.collectives)
            res["tape" if taped else "eager"] = run
            tr.close()
        out[tag] = res
    _save(out_dir, torch.distributed.get_rank(), out)


# -- a rank that a scheduler started -----------------------------------------


def scheduled_rank(out_dir):
    """Join the group that the scheduler's variables describe
    (``initialize_distributed_if_requested``), take one step of
    ``make_step_fns(..., group)`` on this rank's rows of a seeded batch
    and the same step of the whole batch with no group, then run the
    benchmark (its lines on this process's stdout)."""
    from pointnet_autoencoder_tpu_torch import bench
    from pointnet_autoencoder_tpu_torch.parallel import mesh
    from pointnet_autoencoder_tpu_torch.train import schedules
    from pointnet_autoencoder_tpu_torch.train.loop import make_step_fns
    from pointnet_autoencoder_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )

    torch.set_num_threads(1)
    joined = mesh.initialize_distributed_if_requested("cpu")
    group, rank, world = _setup(torch.device("cpu"))
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 64, 3).astype(
        np.float32))
    lr = schedules.learning_rate_schedule(0.001, 0.7, 8, 200000)
    bn = schedules.bn_momentum_schedule(8, 200000)
    out = dict(joined=joined, rank=rank, world=world,
               backend=torch.distributed.get_backend())
    for tag, g, rows in (("group", group, _rows(rank, world, 8)),
                         ("alone", None, slice(None))):
        model = get_model_spec("model").make(
            64, generator=torch.Generator().manual_seed(0))
        state = TrainState(model, make_optimizer("adam", model.parameters()),
                           lr)
        train_step, _ = make_step_fns(state, "model", bn, g)
        metrics = train_step(x[rows])
        out[tag] = dict(metrics={k: float(v) for k, v in metrics.items()},
                        state={k: v.clone() for k, v in
                               model.state_dict().items()})
    _save(out_dir, rank, out)
    bench.main(["--device", "cpu"])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    globals()[sys.argv[1]](*sys.argv[2:])
