"""Training runtime: the step, the epoch loops, checkpoints and logging.

The port's counterpart of ``pointnet_autoencoder_tpu/train/loop.py`` in
its host-input mode, on one device:

- A train step is forward, loss, backward, optimizer step and the BN
  moving-statistics update (in place, during the forward), with
  bn_momentum = bn_decay(step) and the learning rate lr(step) read at the
  step before it advances. The label is the input batch.
- Metrics per step: ``loss``, ``pcloss``, ``learning_rate``,
  ``bn_decay``. Running means are logged every ``log_every`` batches with
  one device-to-host copy each time, then the epoch's throughput.
- The eval epoch runs the model with ``train=False``: the fused encoder
  kernel and the Chamfer forward kernel on the card.
- Checkpoints as the reference: the best eval loss and every 10 epochs;
  ``resume`` restarts from the latest at its stored epoch and step.

Not ported yet (ROADMAP slice 5): device input mode, data/model/point
parallelism, bf16 master weights and moments, the preemption handler and
the background saver.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data.pipeline import BatchPipeline
from pointnet_autoencoder_tpu_torch.data.shapenet_part import PartDataset
from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.train import checkpoint, schedules
from pointnet_autoencoder_tpu_torch.train.logging import Logger, snapshot_config
from pointnet_autoencoder_tpu_torch.train.state import TrainState, make_optimizer

Metrics = Dict[str, object]  # scalar tensors on the device, or floats


def fetch_metric_means(pending: List[Metrics]) -> Dict[str, float]:
    """Mean of each metric over a list of per-step metric dicts; the
    tensor-valued ones come to the host in one stacked copy."""
    keys = sorted(pending[0])
    tensor_keys = [k for k in keys if torch.is_tensor(pending[0][k])]
    means = {k: sum(float(m[k]) for m in pending) / len(pending)
             for k in keys if k not in tensor_keys}
    if tensor_keys:
        stacked = torch.stack([torch.stack([m[k].float() for k in tensor_keys])
                               for m in pending]).mean(dim=0).cpu()
        means.update(zip(tensor_keys, stacked.tolist()))
    return means


class Trainer:
    """End-to-end training on one device. Datasets may be injected
    (tests, custom data); otherwise they are built from config.data_path.

    device: ``"cuda"`` (default; raises without a card) or ``"cpu"``,
    which runs the kernels' plain PyTorch versions."""

    def __init__(self, config: TrainConfig,
                 train_dataset: Optional[PartDataset] = None,
                 test_dataset: Optional[PartDataset] = None,
                 logger: Optional[Logger] = None,
                 device: str = "cuda"):
        self.config = config.validate()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Full f32 matmuls, as the reference's HIGHEST precision.
            torch.backends.cuda.matmul.allow_tf32 = False
        self._owns_logger = logger is None
        self.logger = logger or Logger(config.log_dir)
        snapshot_config(config.log_dir, config)

        class_choice = [config.category] if config.category else None
        self.train_dataset = train_dataset or PartDataset(
            config.data_path, npoints=config.num_point,
            class_choice=class_choice, split="trainval", seed=config.seed,
            cache_dir=config.cache_dir)
        self.test_dataset = test_dataset or PartDataset(
            config.data_path, npoints=config.num_point,
            class_choice=class_choice, split="test", seed=config.seed + 1,
            cache_dir=config.cache_dir)
        self.train_pipe = BatchPipeline(
            self.train_dataset, config.batch_size,
            rotate=not config.no_rotation, shuffle=True, device=self.device,
            seed=config.seed)
        self.eval_pipe = BatchPipeline(
            self.test_dataset, config.batch_size, rotate=False,
            shuffle=False, device=self.device, seed=config.seed)

        self.spec = get_model_spec(config.model)
        dtype = torch.bfloat16 if config.bf16 else torch.float32
        # Built on the CPU from a seeded generator, then moved: the same
        # seed gives the same weights on every device.
        model = self.spec.make(
            config.num_point, dtype=dtype,
            generator=torch.Generator().manual_seed(config.seed))
        model.to(self.device)
        self.bn_schedule = schedules.bn_momentum_schedule(
            config.batch_size, config.decay_step)
        self.state = TrainState(
            model, make_optimizer(config.optimizer, model.parameters(),
                                  config.momentum),
            schedules.learning_rate_schedule(
                config.learning_rate, config.decay_rate, config.batch_size,
                config.decay_step, floor=config.lr_floor))

        self.ckpt = checkpoint.CheckpointManager(config.log_dir)
        self.start_epoch = 0
        self.best_loss = float("inf")
        if config.resume:
            self._try_resume()

    @property
    def model(self):
        return self.state.model

    # -- steps --------------------------------------------------------------

    def train_step(self, batch: torch.Tensor) -> Metrics:
        """One optimizer step on ``batch`` (B, N, 3), its own label."""
        st = self.state
        bn_momentum = self.bn_schedule(st.step)
        lr = st.set_lr()
        pred, end_points = st.model(batch, train=True,
                                    bn_momentum=bn_momentum)
        loss, metrics = self.spec.loss_fn(pred, batch, end_points)
        st.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        st.optimizer.step()
        st.step += 1
        out: Metrics = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        out["learning_rate"] = lr
        out["bn_decay"] = bn_momentum
        return out

    @torch.no_grad()
    def eval_step(self, batch: torch.Tensor) -> Metrics:
        pred, end_points = self.state.model(batch, train=False)
        loss, metrics = self.spec.loss_fn(pred, batch, end_points)
        out: Metrics = dict(metrics)
        out["loss"] = loss
        return out

    # -- checkpoints --------------------------------------------------------

    def _try_resume(self) -> None:
        path = self.ckpt.latest()
        if path is None:
            self.logger.log("resume requested but no checkpoint found; "
                            "starting fresh")
            return
        tree = checkpoint.load(path, map_location=self.device)
        self.state.load_state_dict(tree)
        self.start_epoch = int(tree["epoch"])
        self.best_loss = float(tree["best_loss"])
        self.logger.log(
            f"resumed from {path} at epoch {self.start_epoch} "
            f"(best eval loss {self.best_loss:.6f})")

    def _save(self, kind: str, epoch: int) -> None:
        tree = dict(self.state.state_dict(), epoch=epoch + 1,
                    best_loss=self.best_loss)
        if kind == "best":
            path = self.ckpt.save_best(epoch, tree)
        else:
            path = self.ckpt.save_periodic(tree)
        self.logger.log(f"Model saved in file: {path}")

    # -- epoch loops --------------------------------------------------------

    def train_one_epoch(self, epoch: int) -> None:
        cfg = self.config
        log = self.logger
        num_batches = len(self.train_pipe)
        if num_batches == 0:
            log.log(f"WARNING: 0 train batches (dataset has "
                    f"{len(self.train_dataset)} shapes < batch_size "
                    f"{cfg.batch_size}); epoch is a no-op")
        start_step = self.state.step
        t0 = time.time()
        steps_done, pending, last = 0, [], None
        for batch_idx, batch in enumerate(self.train_pipe.epoch()):
            last = self.train_step(batch)
            steps_done += 1
            pending.append(last)
            if (batch_idx + 1) % cfg.log_every == 0:
                means = fetch_metric_means(pending)
                pending = []
                log.log(f" -- {batch_idx + 1:03d} / {num_batches:03d} --")
                log.log(f"mean loss: {means['loss']:.6f}")
                log.log(f"mean pc loss: {means['pcloss']:.6f}")
                log.scalars("train", start_step + batch_idx + 1, means)
        if last is not None:
            last["loss"].item()  # the epoch time includes the device's work
        dt = time.time() - t0
        if dt > 0:
            log.log(f"epoch throughput: "
                    f"{steps_done * cfg.batch_size / dt:.1f} shapes/sec")

    def eval_one_epoch(self, epoch: int) -> float:
        log = self.logger
        log.log(f"---- EPOCH {epoch:03d} EVALUATION ----")
        pending = [self.eval_step(batch) for batch in self.eval_pipe.epoch()]
        if not pending:
            log.log("eval skipped: test split smaller than one batch")
            return float("inf")
        means = fetch_metric_means(pending)
        log.log(f"eval mean loss: {means['loss']:.6f}")
        log.log(f"eval mean pc loss: {means['pcloss']:.6f}")
        log.scalars("test", self.state.step, means)
        return means["loss"]

    def train(self) -> float:
        cfg = self.config
        if cfg.eval_only:
            loss = self.eval_one_epoch(self.start_epoch)
            self.logger.log(f"eval-only mode; eval loss {loss:.6f}")
            return loss
        for epoch in range(self.start_epoch, cfg.max_epoch):
            self.logger.log(f"**** EPOCH {epoch:03d} ****")
            self.train_one_epoch(epoch)
            epoch_loss = self.eval_one_epoch(epoch)
            if epoch_loss < self.best_loss:
                self.best_loss = epoch_loss
                self._save("best", epoch)
            if epoch % 10 == 0:
                self._save("periodic", epoch)
        return self.best_loss

    def close(self) -> None:
        """Close the logger if this Trainer created it. Idempotent."""
        if self._owns_logger:
            self.logger.close()

