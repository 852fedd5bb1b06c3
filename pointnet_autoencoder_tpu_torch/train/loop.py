"""Training runtime: the step, the epoch loops, checkpoints, logging and
the preemption handler.

The port's counterpart of ``pointnet_autoencoder_tpu/train/loop.py``, on
one device or as one rank of a data-parallel group:

- A train step is forward, loss, backward, optimizer step and the BN
  moving-statistics update (in place, during the forward), with
  bn_momentum = bn_decay(step) and the learning rate lr(step) read at the
  step before it advances. The label is the input batch; for
  ``pcn_emd`` the batch holds ``num_gt_point`` points a shape, the label,
  and the input is its first ``num_point`` (a ``PairedBatch``).
- Input (``input_mode``): ``"device"`` (the default) keeps the dataset
  on the device and builds each batch there (``data/device_pipeline.py``);
  ``"host"`` assembles batches on a host thread (``data/pipeline.py``).
- Compiled steps: on a card the
  steps are captured programs (``utils/graphs.py``, CUDA graphs), the
  JAX package's jitted, donated steps: with device input one program of
  ``log_every`` steps (batch assembly included) per replay and one of
  the whole eval epoch, with host input one step per replay fed by a
  copy into its static input. The first call of each kind runs eagerly
  as the warm-up (it creates the optimizer's slots); a
  ``TrainState.load_state_dict`` releases the programs. ``compiled=False``
  runs the eager step, the reference. A train program registers the
  generators it draws from: the device pipeline's, and
  ``MasterOptimizer``'s noise generator, whose offset is set to the first
  step's draw before each replay. A rank of an NCCL group captures its
  collectives inside the program; a rank of a gloo group, whose
  collectives go through the host, records each program as a tape: a
  graph for each stretch between two collectives, the collectives run
  eagerly between the replays (``utils/graphs.py``), logged with their
  counts at the first capture.
- Metrics per step: ``loss``, ``pcloss`` (and ``pc1loss`` for
  ``model_hierachy``), ``learning_rate``, ``bn_decay`` (the values the
  step applied, computed on the device), each step's in its row of an
  epoch buffer on the device (``EpochMetrics``). Running means of every
  ``log_every`` batches are logged, then the epoch's throughput. With
  host input each log line fetches its window in one copy; with device
  input every fetch waits for the epoch's end (one copy), so no step
  waits for the device.
- The eval epoch runs the model with ``train=False``: the fused encoder
  kernel and the Chamfer forward kernel on the card.
- Checkpoints as the reference: the best eval loss and every 10 epochs;
  ``resume`` restarts from the latest at its stored epoch and step. With
  ``async_checkpoints`` (the default) a save clones the state on the
  device and a background thread copies and writes it
  (``checkpoint.AsyncSaver``); a best and a periodic save of one step
  share the clone.
- Preemption: SIGTERM or SIGINT during ``train()`` stops at the next step
  boundary (with device input on a card, the next dispatch boundary:
  ``log_every`` steps) and writes a resumable checkpoint before
  ``train()`` returns.
- Profiling (``profile_dir``): the first epoch that ``train()`` trains,
  its eval included, runs inside a ``torch.profiler`` trace
  (``utils/profiling.trace``), one file per rank, closed on every exit
  from the epoch, a preemption included. It holds the program's spans
  (``utils/profiling.span``: an eager step's ``step.forward``,
  ``step.loss``, ``step.backward``, ``step.update``; a replay's
  ``step.inputs`` and ``step.launch``), and the log gives the medians of
  the phase clocks of the train programs captured in the epoch (the
  device's wall time of each phase), which a replayed graph does not
  show in the trace. Those programs are released after it, so that the
  next epochs capture them without the clocks.
- Data parallelism: when this process is in a ``torch.distributed``
  process group of k ranks (``parallel.mesh.launch``, ``cli/train.py
  --data_parallel k`` or ``torchrun``), each rank runs one Trainer on its
  B/k rows of every global batch, drawn as one device draws them. BN and
  the fused head's statistics cover the global batch, one flat all-reduce
  averages the gradients before the optimizer, and the logged metrics are
  the ranks' mean. Seeded init gives every rank the same weights, checked
  by one broadcast; every rank resumes from the same file. Only rank 0
  logs and writes checkpoints. A signal may reach one rank only, so the
  ranks agree to stop through the all-reduce that carries the metrics,
  where the host waits anyway: at the end of the epoch with device input,
  at the next log line (every ``log_every`` steps) with host input, and
  at the end of eval. No step waits for it.
- Point parallelism (``point_parallel`` in a group of k > 1 ranks): every
  rank draws the whole global batch and keeps its N/k points of every
  shape; the encoder combines over the ranks, the decoder runs on every
  rank (cuDNN deterministic within each step, so that every rank's
  prediction is the same bits; the setting outside the step is left as
  it was), and the point-sharded losses of ``parallel/sp.py`` give
  each rank its share of the loss. The gradients and the logged metrics
  are then summed over the ranks instead of averaged. At k = 1 (or
  without a group) the plain step runs.
- Tensor parallelism (``model_parallel`` m > 1): the k ranks form a
  (k/m, m) grid (``parallel.mesh.ProcessMesh``); the m ranks of a model
  group take the same rows and split the decoder's FC layers
  (``parallel/tp.py``), each holding its slices and their optimizer
  slots. BN and the gradient average run over the data group (the ranks
  of one model index), the metrics are the data group's mean, and the
  stop flag rides an all-reduce over every rank. Checkpoints hold the
  gathered full tensors in the one-device format, so a TP checkpoint
  serves on one card and resumes at any degree that divides its widths.
- bf16 master weights and moments (``bf16_params``, ``bf16_moments``):
  the matmul parameters, or their optimizer moments, are stored in
  bfloat16 and the optimizer is ``train/master.MasterOptimizer`` (f32
  arithmetic, stochastic rounding into the bf16 leaves), captured on one
  card as the default optimizer is.
- The library surface (``make_step_fns``, ``fetch_metric_means``): the
  train and eval step of a ``TrainState`` for a caller that drives its
  own loop, captured on a card as the Trainer's steps are (one program
  per batch shape; the Trainer keeps its own chunked programs), and one
  copy to the host for a list of their metrics.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data.device_pipeline import (
    DeviceBatchIterator,
    DeviceDataset,
    assemble_batch,
)
from pointnet_autoencoder_tpu_torch.data.pipeline import BatchPipeline
from pointnet_autoencoder_tpu_torch.data.shapenet_part import PartDataset
from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.parallel import sp, tp
from pointnet_autoencoder_tpu_torch.parallel.sp import cudnn_deterministic
from pointnet_autoencoder_tpu_torch.parallel.mesh import (
    DataGroup,
    ProcessMesh,
    check_batch_divisible,
)
from pointnet_autoencoder_tpu_torch.train import (
    checkpoint,
    master,
    schedules,
)
from pointnet_autoencoder_tpu_torch.train.logging import (
    Logger,
    NullLogger,
    snapshot_config,
)
from pointnet_autoencoder_tpu_torch.train.schedules import Staircase
from pointnet_autoencoder_tpu_torch.train.state import (
    SCHEDULE_KEYS,
    PairedBatch,
    StepPrograms,
    TrainState,
    captured_step_fns,
    combined_metrics,
    make_optimizer,
)
from pointnet_autoencoder_tpu_torch.utils import profiling
from pointnet_autoencoder_tpu_torch.utils.graphs import ProgramCache

Metrics = Dict[str, torch.Tensor]  # 0-dim tensors on the device


class EpochMetrics:
    """An epoch's per-step metrics on the device: one row per step of a
    (steps, keys) f32 buffer, the keys sorted, written as the steps are
    taken. A captured chunk's rows arrive in one copy from its program's
    outputs, which the next replay overwrites, so no step's metrics stay
    an alias of a program's output. ``count`` rows are written."""

    def __init__(self, steps: int, device: torch.device | str):
        self.steps = steps
        self.device = torch.device(device)
        self.keys: Optional[List[str]] = None
        self.rows: Optional[torch.Tensor] = None
        self.count = 0

    @staticmethod
    def row(metrics: Metrics) -> Tuple[List[str], torch.Tensor]:
        """(sorted keys, the f32 values in that order) of one step."""
        keys = sorted(metrics)
        return keys, torch.stack([metrics[k].float() for k in keys])

    def put(self, metrics: Metrics) -> None:
        """The next step's metrics."""
        keys, row = self.row(metrics)
        self.put_rows(keys, row[None])

    def put_rows(self, keys: List[str], rows: torch.Tensor) -> None:
        """The next ``len(rows)`` steps' metrics, (k, len(keys)) f32."""
        if self.rows is None:
            self.keys = list(keys)
            self.rows = torch.empty((self.steps, len(keys)),
                                    dtype=torch.float32, device=self.device)
        self.rows[self.count:self.count + rows.shape[0]].copy_(rows)
        self.count += rows.shape[0]


def window_means(rows: np.ndarray, keys: List[str],
                 windows: List[Tuple[int, int]]) -> List[Dict[str, float]]:
    """The f32 mean of each column of ``rows`` (steps, keys) over each
    ``(start, stop)`` window, by key."""
    return [dict(zip(keys, map(float, rows[a:b].mean(axis=0))))
            for a, b in windows]


def fetch_metric_means(pending: Sequence[Metrics]) -> Dict[str, float]:
    """The mean of each metric over a list of metric dicts (0-dim tensors
    on one device), in one stacked copy to the host: the JAX package's
    ``fetch_metric_means``."""
    keys = sorted(pending[0])
    rows = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m in pending]).cpu().numpy()
    return {k: float(v) for k, v in zip(keys, rows.mean(axis=0))}


def make_step_fns(state: TrainState, name: str, bn_schedule: Staircase,
                  group: Optional[DataGroup] = None, compiled: bool = True):
    """(train_step, eval_step) of ``--model name`` on ``state``, the JAX
    package's ``make_step_fns`` for a caller that drives its own loop
    without the Trainer. Each takes a batch (B, N, 3), its own label, or
    for a family whose input and target differ (``pcn_emd``) a
    ``train.state.PairedBatch`` (input, target), and
    returns 0-dim tensors on the device: the loss's metrics and ``loss``,
    and from the train step also the ``learning_rate`` and ``bn_decay``
    it applied (read at the step before it advances ``state``).

    group: a ``parallel.mesh.DataGroup`` whose ranks each hold their rows
      of a global batch. The model's BatchNorm and head statistics then
      cover the global batch, one flat all-reduce averages the gradients
      before the optimizer steps (the Trainer's step), and every metric
      but the schedules' is the ranks' mean, the global batch's value.
    compiled: on a card, each step a captured program per batch shape
      (``train.state.captured_step_fns``: a tape on a rank of a gloo
      group, one graph over NCCL), the first call eager as its warm-up,
      the JAX package's jitted step; False, or the CPU: the eager step,
      the reference.
    """
    loss_fn = get_model_spec(name).loss_fn
    reduce = None
    if group is not None:
        state.model.set_data_group(group)
        reduce = group.average_gradients

    def mean(metrics: Metrics) -> Metrics:
        return (metrics if group is None else
                combined_metrics(metrics, group, group.world_size))

    def train_step(batch: torch.Tensor) -> Metrics:
        return mean(state.train_step(batch, loss_fn, bn_schedule, reduce))

    def eval_step(batch: torch.Tensor) -> Metrics:
        return mean(state.eval_step(batch, loss_fn))

    if not (compiled and next(state.model.parameters()).is_cuda):
        return train_step, eval_step
    return captured_step_fns(
        state, train_step, eval_step,
        taped=group is not None and dist.get_backend() != "nccl")


class Trainer:
    """End-to-end training on one device, or as this process's rank of a
    data-parallel group (the default process group, when one is
    initialized), of a point-parallel one (``config.point_parallel``), or
    of a (data, model) grid (``config.model_parallel`` > 1). Datasets may
    be injected (tests, custom data); otherwise they are built from
    config.data_path.

    device: ``"cuda"`` (default; raises without a card) or ``"cpu"``,
    which runs the kernels' plain PyTorch versions. ``config.data_parallel``
    k and ``config.model_parallel`` m need a process group of k*m ranks;
    ``data_parallel`` None takes the group this process is in, if any.

    compiled: on a card, run the steps as captured programs
    (``utils/graphs.py``; a tape on a rank of a gloo group), the default;
    False runs the eager step, the reference they are held to. The CPU
    runs eager whatever it says (the first log line says which path
    runs, and why)."""

    def __init__(self, config: TrainConfig,
                 train_dataset: Optional[PartDataset] = None,
                 test_dataset: Optional[PartDataset] = None,
                 logger: Optional[Logger] = None,
                 device: str = "cuda", compiled: bool = True):
        self.config = config.validate()
        self.spec = get_model_spec(config.model)
        # A decoder that cannot emit num_point fails before any data loads.
        self.spec.check_num_point(config.num_point)
        if config.model_parallel > 1:
            self.spec.require("tensor parallelism")
        if config.point_parallel:
            self.spec.require("point parallelism")
        # The points of every loaded shape: the target's of a pair family,
        # whose input is the first num_point of them.
        self._gt_point = self.spec.gt_points(config.num_gt_point)
        self._cloud_point = self._gt_point or config.num_point
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Full f32 products, as the reference's HIGHEST precision: TF32
            # off for matmuls and for cuDNN's convolutions (on by default).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        m = config.model_parallel
        data = (config.data_parallel if config.data_parallel is not None
                else max(world // m, 1))
        if data * m != world:
            grid = "" if m == 1 else f" x model_parallel={m}"
            raise ValueError(
                f"data_parallel={data}{grid} needs a process group of "
                f"{data * m} ranks with one Trainer in each (cli.train "
                f"--data_parallel, parallel.mesh.launch or torchrun); this "
                f"process is in {f'one of {world}' if grouped else 'none'}")
        # The (data, model) grid: every rank, the data group (the ranks of
        # this model index: BN and the gradient average; the whole world
        # at m = 1, None when it is this rank alone under m > 1) and the
        # model group (the ranks that split the decoder; None at m = 1).
        self.mesh = ProcessMesh(self.device, m) if grouped else None
        self.world = None if self.mesh is None else self.mesh.world
        self.group = (None if self.mesh is None or (
            m > 1 and data == 1) else self.mesh.data)
        self.model_group = None if self.mesh is None else self.mesh.model
        self.rank = 0 if self.mesh is None else self.world.rank
        # This rank's place on the data axis: its rows of every batch.
        data_rank = 0 if self.mesh is None else self.mesh.data_index
        self._data_size = data
        # Whether the ranks split the points (the batch otherwise).
        self.sp_active = config.point_parallel and world > 1
        if self.sp_active:
            # This rank's points of every shape, of every row.
            self._rows = slice(None)
            self._points = sp.point_slice(config.num_point, self.rank, world)
            self.loss_fn = sp.sp_loss_fn(config.model, self.group)
        else:
            check_batch_divisible(config.batch_size, data)
            rows = config.batch_size // data
            # This rank's rows of every global batch.
            self._rows = slice(data_rank * rows, (data_rank + 1) * rows)
            self._points = slice(None)
            self.loss_fn = self.spec.loss_fn
        # The decoder runs on every point-parallel rank and must give each
        # the same prediction: cuDNN's transposed convolutions (the upconv
        # decoders) otherwise may pick algorithms that add in arrival
        # order. Only the steps take the setting.
        self._replicated = (cudnn_deterministic if self.sp_active
                            and self.device.type == "cuda"
                            else contextlib.nullcontext)
        self._owns_logger = logger is None
        if logger is None:
            logger = Logger(config.log_dir) if self.rank == 0 else NullLogger()
        self.logger = logger
        if self.rank == 0:
            snapshot_config(config.log_dir, config)

        class_choice = [config.category] if config.category else None
        self.train_dataset = train_dataset or PartDataset(
            config.data_path, npoints=self._cloud_point,
            class_choice=class_choice, split="trainval", seed=config.seed,
            cache_dir=config.cache_dir)
        self.test_dataset = test_dataset or PartDataset(
            config.data_path, npoints=self._cloud_point,
            class_choice=class_choice, split="test", seed=config.seed + 1,
            cache_dir=config.cache_dir)
        self.input_mode = config.input_mode
        if self.input_mode == "device":
            # The datasets live on the device; per step the host sends
            # nothing (data/device_pipeline.py).
            self.train_device = DeviceDataset(self.train_dataset,
                                              device=self.device)
            self.eval_device = DeviceDataset(self.test_dataset,
                                             device=self.device)
            self.train_pipe = DeviceBatchIterator(
                self.train_device.num_shapes, config.batch_size,
                shuffle=True, seed=config.seed, device=self.device)
            self.eval_pipe = DeviceBatchIterator(
                self.eval_device.num_shapes, config.batch_size,
                shuffle=False, seed=config.seed + 1, device=self.device)
        elif self.input_mode == "host":
            shard = dict(point_shard=(self.rank, world)) if self.sp_active \
                else dict(shard=(data_rank, data))
            self.train_pipe = BatchPipeline(
                self.train_dataset, config.batch_size,
                rotate=not config.no_rotation, shuffle=True,
                device=self.device, seed=config.seed, **shard)
            self.eval_pipe = BatchPipeline(
                self.test_dataset, config.batch_size, rotate=False,
                shuffle=False, device=self.device, seed=config.seed,
                **shard)
        else:
            raise ValueError(f"input_mode must be 'device' or 'host', got "
                             f"{self.input_mode!r}")

        dtype = torch.bfloat16 if config.bf16 else torch.float32
        # Built on the CPU from a seeded generator, then moved: the same
        # seed gives the same weights on every device.
        model = self.spec.make(
            config.num_point, dtype=dtype,
            generator=torch.Generator().manual_seed(config.seed))
        model.to(self.device)
        if self.sp_active:
            model.set_point_group(self.group)
        else:
            model.set_data_group(self.group)
        if self.model_group is not None:
            model.set_model_group(self.model_group)
        self._param_names = [n for n, _ in model.named_parameters()]
        if config.bf16_params:
            master.cast_master_bf16(model)
        if config.bf16_params or config.bf16_moments:
            # Under TP each split leaf draws its slice of the full leaf's
            # noise: every rank of a model group rounds its replicated
            # leaves with the same noise, and the ranks together round as
            # one device does.
            shards = {} if self.model_group is None else {
                n: (tp.spec_for_name(n), self.model_group.rank, m)
                for n in self._param_names
                if tp.spec_for_name(n) is not None}
            optimizer = master.MasterOptimizer(
                model.named_parameters(), config.optimizer, config.momentum,
                bf16_moments=config.bf16_moments, shards=shards)
            # Its noise generator: registered with every train program, set
            # to the first step's draw before each replay.
            self._master: Optional[master.MasterOptimizer] = optimizer
        else:
            self._master = None
            optimizer = make_optimizer(config.optimizer, model.parameters(),
                                       config.momentum)
        self.bn_schedule = schedules.bn_momentum_schedule(
            config.batch_size, config.decay_step)
        self.state = TrainState(
            model, optimizer,
            schedules.learning_rate_schedule(
                config.learning_rate, config.decay_rate,
                1 if self.spec.decay_per_step else config.batch_size,
                config.decay_step, floor=config.lr_floor))
        # Captured programs on a card; the reason, where the steps run
        # eager. A gloo rank's collectives cannot be captured: its
        # programs are tapes.
        eager = ("the CPU runs eager" if self.device.type != "cuda" else
                 "compiled=False: the eager reference" if not compiled else
                 None)
        taped = self.world is not None and dist.get_backend() != "nccl"
        self._steps = (StepPrograms(
            self.state, ProgramCache(self.device, taped=taped),
            self._master, self.logger.log) if eager is None else None)
        # Each step's metric names.
        self._keys: Dict[str, List[str]] = {}
        where = str(self.device) + ("" if self.world is None else
                                    f" of a {dist.get_backend()} group of "
                                    f"{world} ranks")
        how = ("each stretch between two collectives one CUDA graph, the "
               "collectives run eagerly between the replays, at most one "
               "graph more than collectives a replay; " if taped else
               "the collectives inside each graph; "
               if self.world is not None else "")
        master_note = ("; MasterOptimizer's update inside each train "
                       "program, its noise generator registered with it"
                       if self._master is not None else "")
        self.logger.log(
            "step path: eager (" + eager + ")" if eager else
            f"step path: captured {'tape' if taped else 'CUDA graphs'} on "
            f"{where} ({how}a program of log_every={config.log_every} train "
            f"steps per replay with device input, the eval epoch in one; one "
            f"step per replay with host input{master_note})")

        self.ckpt = checkpoint.CheckpointManager(config.log_dir)
        self._saver = (checkpoint.AsyncSaver(self.ckpt, log=self.logger.log)
                       if config.async_checkpoints and self.rank == 0
                       else None)
        # (step, snapshot): a best and a periodic save of one step share
        # one clone of the state.
        self._snap_cache: Optional[Tuple[int, Any]] = None
        self._closed = False
        self.start_epoch = 0
        self.best_loss = float("inf")
        # Set by the SIGTERM/SIGINT handler while train() runs; the epoch
        # loops stop at the next step boundary and train() saves.
        self._preempted = False
        self._preempt_signum: Optional[int] = None
        # Under data parallelism: whether the ranks agreed to stop (any
        # rank's flag, folded into the metrics' all-reduce).
        self._stop_agreed = False
        if config.resume:
            if self.world is not None:
                self.world.barrier()
            self._try_resume()
        if self.world is not None:
            self._check_replicas_agree()

    @property
    def model(self):
        return self.state.model

    # -- steps --------------------------------------------------------------

    def _paired(self, batch: torch.Tensor):
        """The step's batch: the loaded one, its own label, or for a pair
        family (input, target), the input its first num_point points."""
        if self._gt_point is None:
            return batch
        return PairedBatch(batch[:, :self.config.num_point], batch)

    def _eager_train_step(self, batch: torch.Tensor) -> Metrics:
        if self.sp_active:
            reduce = self.group.sum_gradients
        elif self.group is not None:
            reduce = self.group.average_gradients
        else:
            reduce = None
        metrics = self.state.train_step(self._paired(batch), self.loss_fn,
                                        self.bn_schedule, reduce,
                                        self._replicated)
        self._keys["train"] = sorted(metrics)
        return metrics

    def _eager_eval_step(self, batch: torch.Tensor) -> Metrics:
        metrics = self.state.eval_step(self._paired(batch), self.loss_fn,
                                       self._replicated)
        self._keys["eval"] = sorted(metrics)
        return metrics

    def train_step(self, batch: torch.Tensor) -> Metrics:
        """One optimizer step on ``batch`` (B, N, 3), its own label; on a
        card (``compiled``) the replay of a captured step, the first one
        after a warm-up eager. Returns the step's metrics, 0-dim tensors
        of the caller's own."""
        if self._steps is None:
            return self._eager_train_step(batch)
        if not self._steps.warm("train"):
            return self._steps.warm_up(
                "train", lambda: self._eager_train_step(batch))

        rows = self._steps.run(
            ("step", tuple(batch.shape), batch.dtype),
            lambda x: EpochMetrics.row(self._eager_train_step(x))[1][None],
            (batch,), steps=1)
        return dict(zip(self._keys["train"], rows[0].clone().unbind()))

    def eval_step(self, batch: torch.Tensor) -> Metrics:
        """The eval loss and metrics on ``batch``; captured as
        ``train_step``."""
        if self._steps is None:
            return self._eager_eval_step(batch)
        if not self._steps.warm("eval"):
            return self._steps.warm_up(
                "eval", lambda: self._eager_eval_step(batch))

        rows = self._steps.run(
            ("eval_step", tuple(batch.shape), batch.dtype),
            lambda x: EpochMetrics.row(self._eager_eval_step(x))[1][None],
            (batch,))
        return dict(zip(self._keys["eval"], rows[0].clone().unbind()))

    def _chunk(self, kind: str, idxs: torch.Tensor,
               metrics: EpochMetrics) -> None:
        """The ``kind`` ("train" or "eval") steps of the (K, B) shape
        indices ``idxs``, each batch built on the device, their metrics
        into ``metrics``: on a card (``compiled``) one replay of the
        program of K steps (the first chunk of a kind eager, as its
        warm-up), else K eager steps, stopping at a step boundary on a
        signal."""
        train = kind == "train"
        pipe, data = ((self.train_pipe, self.train_device) if train
                      else (self.eval_pipe, self.eval_device))
        rotate = train and not self.config.no_rotation
        step = self.train_step if train else self.eval_step
        eager_step = self._eager_train_step if train else \
            self._eager_eval_step

        def rows(ix, one_step):
            out = [EpochMetrics.row(one_step(self._assemble(
                pipe, data, ix[j], rotate)))[1] for j in range(len(ix))]
            return torch.stack(out)

        k = idxs.shape[0]
        if self._steps is None:
            # Eager, a stop at the next step boundary.
            for j in range(k):
                if train and self._should_stop():
                    return
                metrics.put(step(self._assemble(pipe, data, idxs[j],
                                                rotate)))
            return
        if not self._steps.warm(kind):
            out = self._steps.warm_up(kind, lambda: rows(idxs, eager_step))
        else:
            out = self._steps.run((kind, k), lambda ix: rows(ix, eager_step),
                                  (idxs,), steps=k if train else 0,
                                  generators=(pipe.generator,))
        metrics.put_rows(self._keys[kind], out)

    def _assemble(self, pipe: DeviceBatchIterator, data: DeviceDataset,
                  idxs: torch.Tensor, rotate: bool) -> torch.Tensor:
        """This rank's part of the batch of shapes ``idxs``, built on the
        device from ``pipe``'s generator."""
        return assemble_batch(data.data, data.lengths, idxs, pipe.generator,
                              self._cloud_point, rotate, rows=self._rows,
                              points=self._points)

    # -- data and model parallelism -----------------------------------------

    def _check_replicas_agree(self) -> None:
        """Raise on every rank unless all hold the same parameters and BN
        statistics bit for bit (seeded init, or one checkpoint): the ranks
        of each data group the same slices, those of each model group the
        same replicated entries; one broadcast each at start-up."""
        sd = self.model.state_dict()

        def flat(names):
            return torch.cat([sd[n].detach().float().reshape(-1)
                              for n in names])

        mine = flat(list(sd))
        differs = (self.group is not None and not torch.equal(
            mine, self.group.broadcast_(mine.clone())))
        if self.model_group is not None:
            rep = flat(tp.replicated_names(self.model))
            differs |= not torch.equal(
                rep, self.model_group.broadcast_(rep.clone()))
        if self.world.any(differs):
            raise RuntimeError("the ranks' weights differ at start-up; every "
                               "rank must build the model from one seed or "
                               "resume from one checkpoint")

    def _should_stop(self) -> bool:
        """The step loops' test for a stop: this process's signal flag on
        one device; on ranks what the ranks last agreed, so that all stop
        at one step."""
        return self._preempted if self.world is None else self._stop_agreed

    def _fetch_windows(self, metrics: EpochMetrics,
                       windows: List[Tuple[int, int]], start: int = 0
                       ) -> List[Dict[str, float]]:
        """``window_means`` of this rank's metrics rows from ``start`` on,
        in one copy to the host (windows counted from ``start``). On
        ranks each step's metrics are first averaged over the data axis
        (equal shards: the global batch's means) in one all-reduce over
        every rank, which also carries this rank's stop flag: if any rank
        was signalled, all agree to stop. Under tensor parallelism every
        rank of a model group holds the same metrics, and model index 0's
        count. Under point parallelism they are summed (each rank's are
        its shares). The learning rate and BN momentum are every rank's
        own and are not reduced."""
        rows = metrics.rows[start:metrics.count]
        if self.world is not None:
            own = [i for i, k in enumerate(metrics.keys)
                   if k in SCHEDULE_KEYS]
            shared = rows[:, own].clone()
            if self.model_group is not None and self.model_group.rank:
                rows = torch.zeros_like(rows)
            buf = torch.cat([rows.reshape(-1), torch.tensor(
                [float(self._preempted)], device=rows.device)])
            self.world.sum_(buf)
            if buf[-1].item() > 0:
                self._stop_agreed = True
            rows = buf[:-1].view(rows.shape)
            if not self.sp_active:
                rows = rows / self._data_size
            rows[:, own] = shared
        return window_means(rows.cpu().numpy(), metrics.keys, windows)

    # -- checkpoints --------------------------------------------------------

    def _try_resume(self) -> None:
        path = self.ckpt.latest()
        if path is None:
            self.logger.log("resume requested but no checkpoint found; "
                            "starting fresh")
            return
        tree = checkpoint.load(path, map_location=self.device)
        if self.model_group is not None:
            tree = tp.shard_state(tree, self._param_names,
                                  self.model_group.rank,
                                  self.model_group.world_size)
        self.state.load_state_dict(tree)
        self.start_epoch = int(tree["epoch"])
        self.best_loss = float(tree["best_loss"])
        self.logger.log(
            f"resumed from {path} at epoch {self.start_epoch} "
            f"(best eval loss {self.best_loss:.6f})")

    def _full_state(self) -> Dict[str, Any]:
        """The train state with full tensors: under tensor parallelism
        gathered over the model group (every rank of it must call this),
        else this rank's own."""
        tree = self.state.state_dict()
        if self.model_group is not None:
            tree = tp.gather_state(tree, self._param_names,
                                   self.model_group)
        return tree

    def _save(self, kind: str, epoch: int) -> None:
        full = self._full_state() if self.model_group is not None else None
        if self.rank != 0:
            return
        if full is None:
            full = self.state.state_dict()
        if self._saver is not None:
            step = self.state.step
            if self._snap_cache is None or self._snap_cache[0] != step:
                self._snap_cache = (step, checkpoint.snapshot(full))
            tree = dict(self._snap_cache[1], epoch=epoch + 1,
                        best_loss=self.best_loss)
            # The worker logs "Model saved in file:" once the file is
            # written.
            self._saver.submit(kind, epoch, tree, device=self.device)
            return
        tree = dict(checkpoint.to_host(full), epoch=epoch + 1,
                    best_loss=self.best_loss)
        if kind == "best":
            path = self.ckpt.save_best(epoch, tree)
        else:
            path = self.ckpt.save_periodic(tree)
        self.logger.log(f"Model saved in file: {path}")

    def _save_preempt(self, epoch: int) -> None:
        """A resumable checkpoint whose stored epoch is ``epoch``: the
        interrupted epoch, which ``--resume`` then runs from its start
        (the updates of its finished steps stay in the weights). Under
        data parallelism rank 0 writes it."""
        signal_name = (f"signal {self._preempt_signum}" if self._preempted
                       else "a signal on another rank")
        self.logger.log(f"received {signal_name}: stopping at a step "
                        f"boundary")
        full = self._full_state() if self.model_group is not None else None
        if self.rank != 0:
            return
        if self._saver is not None:
            # Earlier saves land before this one moves LATEST; this one is
            # synchronous, durable before train() returns.
            self._saver.flush()
        tree = dict(checkpoint.to_host(
            self.state.state_dict() if full is None else full),
            epoch=epoch, best_loss=self.best_loss)
        path = self.ckpt.save_periodic(tree)
        self.logger.log(f"preemption checkpoint saved: {path} (--resume "
                        f"restarts epoch {epoch})")

    def _install_signal_handlers(self) -> Callable[[], None]:
        """SIGTERM and SIGINT ask for a checkpoint and a return at the next
        step boundary; a second signal restores the previous handlers and
        raises KeyboardInterrupt. Returns the function that restores the
        previous handlers; a no-op outside the main thread, where no
        handler can be installed."""
        previous = {}

        def restore():
            for sig, handler in previous.items():
                try:
                    signal.signal(sig, handler)
                except ValueError:
                    pass

        def request_stop(signum, frame):
            if self._preempted:
                restore()
                raise KeyboardInterrupt
            self._preempted = True
            self._preempt_signum = signum
            # The main thread may be inside the logger's buffered write,
            # which is not reentrant; os.write is safe in a handler, and
            # the loop logs once it sees the flag.
            os.write(2, (f"\nreceived signal {signum}: checkpointing at the "
                         f"next step boundary, then returning (signal again "
                         f"to interrupt)\n").encode())

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, request_stop)
        except ValueError:  # not the main thread
            return lambda: None
        return restore

    # -- epoch loops --------------------------------------------------------

    def train_one_epoch(self, epoch: int) -> int:
        """One training epoch; returns the steps it took."""
        cfg = self.config
        log = self.logger
        num_batches = len(self.train_pipe)
        if num_batches == 0:
            log.log(f"WARNING: 0 train batches (dataset has "
                    f"{len(self.train_dataset)} shapes < batch_size "
                    f"{cfg.batch_size}); epoch is a no-op")
        start_step = self.state.step
        t0 = time.time()
        if self.input_mode == "device":
            steps_done = self._train_epoch_device(start_step, num_batches)
        else:
            steps_done = self._train_epoch_host(start_step, num_batches)
        dt = time.time() - t0
        if dt > 0:
            log.log(f"epoch throughput: "
                    f"{steps_done * cfg.batch_size / dt:.1f} shapes/sec")
        return steps_done

    def _log_window(self, step: int, batches: int, num_batches: int,
                    means: Dict[str, float]) -> None:
        log = self.logger
        log.log(f" -- {batches:03d} / {num_batches:03d} --")
        log.log(f"mean loss: {means['loss']:.6f}")
        self._log_losses("mean", means)
        log.scalars("train", step, means)

    def _log_losses(self, prefix: str, means: Dict[str, float]) -> None:
        """The loss's parts: the Chamfer ``pcloss`` where the family
        reports it, and its ``log_keys``."""
        if "pcloss" in means:
            self.logger.log(f"{prefix} pc loss: {means['pcloss']:.6f}")
        for k in self.spec.log_keys:
            self.logger.log(f"{prefix} {k}: {means[k]:.6f}")

    def _train_epoch_device(self, start_step: int, num_batches: int) -> int:
        """Device-input epoch: ``log_every`` steps per dispatch (a replayed
        program on a card, which stops at a dispatch boundary), and the
        metrics of the whole epoch to the host in one copy at its end
        (which also waits for the device), so the log lines print then,
        with the host path's content."""
        cfg = self.config
        metrics = EpochMetrics(num_batches, self.device)
        for idxs in self.train_pipe.epoch_chunks(cfg.log_every):
            if self._should_stop():
                break
            self._chunk("train", idxs, metrics)
        # The reference logs at full log_every marks only.
        full = metrics.count // cfg.log_every * cfg.log_every
        windows = [(a, a + cfg.log_every)
                   for a in range(0, full, cfg.log_every)]
        if metrics.count:
            means = self._fetch_windows(metrics, windows)
            for (_, stop), m in zip(windows, means):
                self._log_window(start_step + stop, stop, num_batches, m)
        return metrics.count

    def _train_epoch_host(self, start_step: int, num_batches: int) -> int:
        """Host-input epoch: a metric fetch at every log mark, one copy
        each."""
        cfg = self.config
        metrics = EpochMetrics(num_batches, self.device)
        logged = 0
        for batch_idx, batch in enumerate(self.train_pipe.epoch()):
            if self._should_stop():
                break
            metrics.put(self.train_step(batch))
            if (batch_idx + 1) % cfg.log_every == 0:
                means, = self._fetch_windows(
                    metrics, [(0, metrics.count - logged)], start=logged)
                logged = metrics.count
                self._log_window(start_step + batch_idx + 1, batch_idx + 1,
                                 num_batches, means)
        if metrics.count:
            # The epoch time includes the device's work.
            metrics.rows[metrics.count - 1, 0].item()
        return metrics.count

    def eval_one_epoch(self, epoch: int) -> float:
        """The eval epoch: with device input one dispatch (a replayed
        program of every batch on a card), with host input one step per
        batch; the means in one copy."""
        log = self.logger
        log.log(f"---- EPOCH {epoch:03d} EVALUATION ----")
        n = len(self.eval_pipe)
        metrics = EpochMetrics(n, self.device)
        if n and self.input_mode == "device":
            for idxs in self.eval_pipe.epoch_chunks(n):
                self._chunk("eval", idxs, metrics)
        else:
            for batch in self.eval_pipe.epoch():
                metrics.put(self.eval_step(batch))
        if not metrics.count:
            log.log("eval skipped: test split smaller than one batch")
            return float("inf")
        means, = self._fetch_windows(metrics, [(0, metrics.count)])
        log.log(f"eval mean loss: {means['loss']:.6f}")
        self._log_losses("eval mean", means)
        log.scalars("test", self.state.step, means)
        return means["loss"]

    def train(self) -> float:
        cfg = self.config
        # The flag belongs to one train() call: a preempted Trainer trains
        # again in the same process.
        self._preempted = self._stop_agreed = False
        restore_signals = self._install_signal_handlers()
        try:
            if cfg.eval_only:
                loss = self.eval_one_epoch(self.start_epoch)
                self.logger.log(f"eval-only mode; eval loss {loss:.6f}")
                return loss
            for epoch in range(self.start_epoch, cfg.max_epoch):
                self.logger.log(f"**** EPOCH {epoch:03d} ****")
                traced = bool(cfg.profile_dir) and epoch == self.start_epoch
                taken = 0 if self._steps is None else len(self._steps.phases)
                with profiling.trace(cfg.profile_dir if traced else None,
                                     self.device):
                    steps = self.train_one_epoch(epoch)
                    stopped = self._should_stop()
                    if not stopped:
                        epoch_loss = self.eval_one_epoch(epoch)
                if traced:
                    self.logger.log(
                        f"profiler trace written to {cfg.profile_dir}")
                    self.logger.log(self._phases_line(taken))
                    if self._steps is not None:
                        # The next epochs replay programs without clocks.
                        self._steps.release_clocked()
                if stopped:
                    # One device stops mid-epoch and restarts it on resume.
                    # Ranks stop where they agreed: an epoch that ran to
                    # its end (device input agrees there) is done.
                    done = (self.world is not None
                            and steps == len(self.train_pipe))
                    self._save_preempt(epoch + 1 if done else epoch)
                    return self.best_loss
                if epoch_loss < self.best_loss:
                    self.best_loss = epoch_loss
                    self._save("best", epoch)
                if epoch % 10 == 0:
                    self._save("periodic", epoch)
                if self._should_stop():
                    # The signal came during eval or the saves: this epoch
                    # is complete, so the resume pointer moves past it.
                    self._save_preempt(epoch + 1)
                    return self.best_loss
            return self.best_loss
        finally:
            restore_signals()
            self.flush()

    def _phases_line(self, taken: int) -> str:
        """The medians of the phase clocks' samples that this Trainer took
        after it had taken ``taken`` (the traced epoch's), the last
        step's taken now that the trace has synchronized the card: what
        the trace cannot show of a replayed graph. Each phase is the
        device's wall time between its boundaries, gaps included."""
        if self._steps is None:
            why = ("the CPU has no phase clocks" if self.device.type != "cuda"
                   else "eager steps are not sampled")
            return f"step phases on the device: none sampled ({why})"
        self._steps.sample_phases()
        samples = list(self._steps.phases)[taken:]
        medians = profiling.phase_medians(samples)
        if not medians:
            return ("step phases on the device: none sampled (no train "
                    "program captured in the epoch was replayed: the first "
                    "call of each kind runs eager, as its warm-up)")
        return (f"step phases on the device, median ms of {len(samples)} "
                f"sampled steps: " + ", ".join(
                    f"{p} {ms:.4f}" for p, ms in medians.items()))

    def flush(self) -> None:
        """Wait until every checkpoint submitted so far is on disk and
        flush the logger's buffered TensorBoard writers; the Trainer stays
        usable."""
        if self._saver is not None:
            self._saver.flush()
        self.logger.flush()

    def close(self) -> None:
        """Finish the background saves, stop the saver and close the logger
        if this Trainer created it. Idempotent; a closed Trainer does not
        save again."""
        if self._closed:
            return
        self._closed = True
        if self._steps is not None:
            self._steps.programs.close()
        if self._saver is not None:
            self._saver.close()
            self._saver = None
        if self._owns_logger:
            self.logger.close()

