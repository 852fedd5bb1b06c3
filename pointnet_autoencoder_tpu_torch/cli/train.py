"""Training CLI: the flag surface of the reference's train.py, on the card.

    python -m pointnet_autoencoder_tpu_torch.cli.train \\
        --model model --category Chair --num_point 2048 --no_rotation \\
        [--device cuda]

Every flag of ``pointnet_autoencoder_tpu/cli/train.py`` is accepted, plus
``--device`` (``cuda`` by default, which fails without a card; ``cpu``
runs the kernels' plain PyTorch versions). ``--gpu`` is accepted for
reference compatibility and ignored: ``--device cuda:N`` picks a card.
Flags whose feature the port does not run yet (``--input_mode device``,
``--data_parallel``/``--model_parallel`` above 1, ``--point_parallel``,
``--bf16_params``, ``--bf16_moments``, ``--profile_dir``,
``--compilation_cache_dir``) raise NotImplementedError naming their
ROADMAP item. Checkpoints are synchronous here, so ``--sync_checkpoints``
is the port's only mode and the flag changes nothing.
"""

from __future__ import annotations

import argparse
import os
import sys

from pointnet_autoencoder_tpu_torch.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    d = TrainConfig()
    p.add_argument("--gpu", type=int, default=0,
                   help="Accepted for reference compatibility; ignored "
                        "(use --device cuda:N)")
    p.add_argument("--model", default=d.model,
                   help="Model name [default: model]")
    p.add_argument("--category", default=None,
                   help="Which single class to train on [default: None]")
    p.add_argument("--log_dir", default=d.log_dir,
                   help="Log dir [default: log]")
    p.add_argument("--num_point", type=int, default=d.num_point,
                   help="Point Number [default: 2048]")
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
                   help="'host': host batch assembly with pinned copies "
                        "[default: host; 'device' is not ported yet]")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in log_dir")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--data_parallel", type=int, default=None,
                   help="Not ported yet above 1")
    p.add_argument("--model_parallel", type=int, default=d.model_parallel,
                   help="Not ported yet above 1")
    p.add_argument("--point_parallel", action="store_true",
                   default=d.point_parallel, help="Not ported yet")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=d.bf16,
                   help="bfloat16 matmuls in the network (default on; "
                        "--no-bf16 runs f32 everywhere; losses, BN "
                        "statistics and master weights always f32)")
    p.add_argument("--bf16_params", action="store_true",
                   default=d.bf16_params, help="Not ported yet")
    p.add_argument("--bf16_moments", action="store_true",
                   default=d.bf16_moments, help="Not ported yet")
    p.add_argument("--profile_dir", default=None, help="Not ported yet")
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
                   help="Accepted for compatibility: saves are always "
                        "synchronous in the port")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        model=args.model, category=args.category, log_dir=args.log_dir,
        num_point=args.num_point, max_epoch=args.max_epoch,
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
    ).validate()


def build_trainer(args: argparse.Namespace):
    """The logger and Trainer the flags describe (nothing trained yet)."""
    from pointnet_autoencoder_tpu_torch.train.logging import Logger
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    config = config_from_args(args)
    logger = Logger(config.log_dir)
    logger.log(f"pid: {os.getpid()}")
    logger.log(config.to_json())
    try:
        return Trainer(config, logger=logger, device=args.device), logger
    except BaseException:
        logger.close()
        raise


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trainer, logger = build_trainer(args)
    best = trainer.train()
    trainer.close()
    logger.log(f"done; best eval loss {best:.6f}")
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
