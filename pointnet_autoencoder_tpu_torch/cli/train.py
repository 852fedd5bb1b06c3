"""Training CLI: the flag surface of the reference's train.py, on the card.

    python -m pointnet_autoencoder_tpu_torch.cli.train \\
        --model model --category Chair --num_point 2048 --no_rotation \\
        [--device cuda]

Every flag of ``pointnet_autoencoder_tpu/cli/train.py`` is accepted, plus
``--device`` (``cuda`` by default, which fails without a card; ``cpu``
runs the kernels' plain PyTorch versions) and ``--num_gt_point``.
``--model pcn_emd`` (PCN) trains on (input, target) pairs: each shape is
loaded with ``--num_gt_point`` points (16,384 by default, at least its
1024 coarse points), the target, and its first ``--num_point`` are the
input; the network keeps PCN's widths whatever the two sizes; its ``--decay_step`` counts
steps, so PCN's recipe is ``--learning_rate 1e-4 --decay_rate 0.7
--decay_step 50000 --lr_floor 1e-6``. ``--gpu`` is accepted for
reference compatibility and ignored: ``--device cuda:N`` picks a card.
``--input_mode`` is ``device`` (the dataset on the card, batches built
there) or ``host`` (host assembly, pinned copies); checkpoints are
written on a background thread unless ``--sync_checkpoints``.

``--data_parallel k`` trains on k ranks, one process each, over
``torch.distributed`` (``parallel/mesh.py``): under a launcher
(``torchrun``, SLURM's ``srun`` or Open MPI's ``mpirun``) this process
joins its group as one rank; otherwise it spawns
k local ranks on cards 0..k-1 (NCCL), or k CPU ranks with ``--device cpu``
(gloo). Unset, it means every visible card, as in the JAX package. Asking
for more cards than exist raises; nothing falls back to fewer cards or to
the CPU. With ``--point_parallel`` the k ranks split every shape's points
instead of the batch (``parallel/sp.py``; num_point must divide by k).
``--model_parallel m`` splits the decoder's FC layers over m ranks of each
data shard (``parallel/tp.py``): ``--data_parallel k --model_parallel m``
runs k*m ranks (``--model_parallel 2`` alone, 2). ``--bf16_params`` and
``--bf16_moments`` store the matmul parameters and their optimizer moments
in bfloat16 (``train/master.py``). ``--profile_dir`` writes a
``torch.profiler`` trace of the first epoch trained there, one file per
rank (``utils/profiling.py``). ``--compilation_cache_dir`` (an XLA cache
in the JAX package) has no counterpart and raises NotImplementedError. A
``--num_point`` that
the model's decoder cannot emit fails with ValueError before any data
loads. SIGTERM or SIGINT saves a resumable checkpoint at the next step
boundary and ends the run (under data parallelism where the ranks agree:
``train/loop.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, List, Optional, Sequence

import torch

from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.models.registry import available_models
from pointnet_autoencoder_tpu_torch.parallel import mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    d = TrainConfig()
    p.add_argument("--gpu", type=int, default=0,
                   help="Accepted for reference compatibility; ignored "
                        "(use --device cuda:N)")
    p.add_argument("--model", default=d.model,
                   help=f"Model name, one of {', '.join(available_models())} "
                        f"[default: model]")
    p.add_argument("--category", default=None,
                   help="Which single class to train on [default: None]")
    p.add_argument("--log_dir", default=d.log_dir,
                   help="Log dir [default: log]")
    p.add_argument("--num_point", type=int, default=d.num_point,
                   help="Point Number [default: 2048]")
    p.add_argument("--num_gt_point", type=int, default=None,
                   help="Target points of --model pcn_emd, whose input is "
                        "the first --num_point of them; the data's size "
                        "alone, at least 1024 [default: 16384]")
    p.add_argument("--max_epoch", type=int, default=d.max_epoch,
                   help="Epoch to run [default: 201]")
    p.add_argument("--batch_size", type=int, default=d.batch_size,
                   help="Batch Size during training [default: 32]")
    p.add_argument("--learning_rate", type=float, default=d.learning_rate,
                   help="Initial learning rate [default: 0.001]")
    p.add_argument("--momentum", type=float, default=d.momentum,
                   help="Momentum for the momentum optimizer [default: 0.9]")
    p.add_argument("--optimizer", default=d.optimizer,
                   help="adam or momentum [default: adam]")
    p.add_argument("--decay_step", type=int, default=d.decay_step,
                   help="Decay step for lr decay [default: 200000]")
    p.add_argument("--decay_rate", type=float, default=d.decay_rate,
                   help="Decay rate for lr decay [default: 0.7]")
    p.add_argument("--no_rotation", action="store_true",
                   help="Disable random rotation during training.")
    p.add_argument("--data_path", default=d.data_path,
                   help="ShapeNetPart root directory")
    p.add_argument("--input_mode", default=d.input_mode,
                   choices=["device", "host"],
                   help="'device': the dataset on the card, resampled and "
                        "rotated there; 'host': host batch assembly with "
                        "pinned copies [default: device]")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in log_dir")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--data_parallel", type=int, default=None,
                   help="Ranks on the data axis, one process and one card "
                        "each (with --device cpu: CPU ranks over gloo) "
                        "[default: every visible card]")
    p.add_argument("--model_parallel", type=int, default=d.model_parallel,
                   help="Tensor-parallel degree over the decoder FC "
                        "stacks (parallel/tp.py): ranks per data shard, "
                        "one process each; 1 = off [default: 1]")
    p.add_argument("--point_parallel", action="store_true",
                   default=d.point_parallel,
                   help="Shard the batch's POINT axis over the data axis "
                        "(parallel/sp.py): the long-N training mode -- "
                        "each rank runs the encoder and the losses on its "
                        "points and combines them over the ranks. "
                        "num_point must divide by the axis size; exclusive "
                        "with --model_parallel")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=d.bf16,
                   help="bfloat16 matmuls in the network (default on; "
                        "--no-bf16 runs f32 everywhere; losses and BN "
                        "statistics always f32, master weights f32 "
                        "unless --bf16_params)")
    p.add_argument("--bf16_params", action="store_true",
                   default=d.bf16_params,
                   help="Store matmul MASTER weights in bf16; f32 Adam "
                        "updates applied with stochastic rounding "
                        "(train/master.py; BN parameters and optimizer "
                        "state stay f32)")
    p.add_argument("--bf16_moments", action="store_true",
                   default=d.bf16_moments,
                   help="Store Adam moment slots for matmul params in "
                        "bf16 (stochastically rounded f32 updates); "
                        "halves the optimizer state of that class")
    p.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler trace of the first epoch "
                        "here")
    p.add_argument("--lr_floor", type=float, default=None,
                   help="Optional LR clamp (the reference intended 1e-5 but "
                        "the clip is dead code; default: no floor)")
    p.add_argument("--cache_dir", default=None,
                   help="On-disk cache of decoded shapes (.npz)")
    p.add_argument("--compilation_cache_dir", default=None,
                   help="Not ported (no XLA programs to cache)")
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--eval_only", action="store_true",
                   help="Run a single evaluation pass (use with --resume)")
    p.add_argument("--sync_checkpoints", action="store_true",
                   help="Block training while each checkpoint saves "
                        "(default: saves run on a background thread from "
                        "a snapshot of the state on the device)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        model=args.model, category=args.category, log_dir=args.log_dir,
        num_point=args.num_point, num_gt_point=args.num_gt_point,
        max_epoch=args.max_epoch,
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        momentum=args.momentum, optimizer=args.optimizer,
        decay_step=args.decay_step, decay_rate=args.decay_rate,
        no_rotation=args.no_rotation, data_path=args.data_path,
        input_mode=args.input_mode, resume=args.resume, seed=args.seed,
        data_parallel=args.data_parallel,
        model_parallel=args.model_parallel,
        point_parallel=args.point_parallel, bf16=args.bf16,
        bf16_params=args.bf16_params, bf16_moments=args.bf16_moments,
        profile_dir=args.profile_dir, lr_floor=args.lr_floor,
        log_every=args.log_every, eval_only=args.eval_only,
        cache_dir=args.cache_dir,
        compilation_cache_dir=args.compilation_cache_dir,
        async_checkpoints=not args.sync_checkpoints,
    ).validate()


def build_trainer(args: argparse.Namespace):
    """The logger and Trainer the flags describe (nothing trained yet), in
    this process: alone, or as its rank of the process group it is in
    (only rank 0's logger writes)."""
    from pointnet_autoencoder_tpu_torch.train.logging import Logger, NullLogger
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    config = config_from_args(args)
    logger = Logger(config.log_dir) if mesh.process_rank() == 0 \
        else NullLogger()
    logger.log(f"pid: {os.getpid()}")
    logger.log(config.to_json())
    try:
        return Trainer(config, logger=logger, device=args.device), logger
    except BaseException:
        logger.close()
        raise


def run(args: argparse.Namespace,
        after: Optional[Callable] = None) -> float:
    """Build the Trainer the flags describe and train; ``after(trainer)``
    runs once training has ended, before the Trainer closes. Returns the
    best eval loss."""
    trainer, logger = build_trainer(args)
    try:
        best = trainer.train()
        if after is not None:
            after(trainer)
    finally:
        trainer.close()
    logger.log(f"done; best eval loss {best:.6f}")
    logger.close()
    return best


def _run_rank(device: torch.device, args: argparse.Namespace,
              after: Optional[Callable]) -> None:
    """One spawned rank (``mesh.launch``): the flags' run on ``device``."""
    args = argparse.Namespace(**vars(args))
    args.device = str(device)
    run(args, after)


def rank_devices(args: argparse.Namespace,
                 devices: Optional[Sequence] = None
                 ) -> Optional[List[torch.device]]:
    """The devices to spawn one rank on each, or None to train in this
    process: ``devices`` if given, else ``--data_parallel`` x
    ``--model_parallel`` CPU ranks with ``--device cpu``, else as many
    cards (``--data_parallel`` unset: every visible card). One device, or
    a CUDA device named by index, trains in this process."""
    m = args.model_parallel
    if devices is not None:
        return mesh.make_mesh(devices, args.data_parallel, m)
    dev = torch.device(args.device)
    k = args.data_parallel
    if m == 1 and (k == 1 or (k is None and (
            dev.type == "cpu" or dev.index is not None
            or torch.cuda.device_count() < 2))):
        return None
    if dev.type == "cpu":
        return [dev] * ((k or 1) * m)
    return mesh.make_mesh(None, k, m)


def main(argv=None, devices: Optional[Sequence] = None,
         backend: Optional[str] = None,
         after: Optional[Callable] = None) -> int:
    """Train as the flags say. Under a launcher (torchrun, SLURM's srun
    or Open MPI's mpirun: ``parallel.mesh.find_rendezvous``) this process
    is one rank; else with more than one rank device
    (``rank_devices``; ``devices`` names them explicitly, one device may
    repeat) the ranks are spawned here over ``backend`` (NCCL on cards,
    gloo on the CPU or where two ranks share a card); else this process
    trains alone. ``after(trainer)`` runs in every rank once training
    ends (a module-level function, to reach spawned ranks)."""
    args = build_parser().parse_args(argv)
    config_from_args(args)  # bad flags fail before any rank starts
    if mesh.initialize_distributed_if_requested(args.device):
        run(args, after)
        return 0
    ranks = rank_devices(args, devices)
    if ranks is None:
        run(args, after)
    else:
        mesh.launch(_run_rank, devices=ranks, backend=backend,
                    args=(args, after))
    return 0


if __name__ == "__main__":
    sys.exit(main())
