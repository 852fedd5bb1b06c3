"""Training and test configuration: the port's copies of the reference's
``TrainConfig`` and ``TestConfig`` (``pointnet_autoencoder_tpu/config.py``),
with the same field names and defaults.

``TrainConfig.validate`` refuses every field this port does not run (the
XLA compilation cache, which has no counterpart), naming the ROADMAP
item, instead of ignoring it. ``profile_dir`` writes a ``torch.profiler``
trace of the first epoch trained (``utils/profiling.py``).
``data_parallel`` k runs k ranks (``parallel/mesh.py``; the Trainer checks
that it is in a group of k); with ``point_parallel`` the k ranks split
every shape's points instead of the batch (``parallel/sp.py``);
``model_parallel`` m splits the decoder's FC layers over m ranks of each
data shard (``parallel/tp.py``; k*m ranks in all). ``bf16_params`` and
``bf16_moments`` store the matmul parameters and their optimizer moments
in bfloat16 (``train/master.py``). ``num_gt_point`` is the target's
points of a family whose input and target differ (``pcn_emd``), whose
input is the first ``num_point`` of them; it sets the data's size, not
the network's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

# Fields the port refuses away from their default: (field, test for
# "set", the ROADMAP item that ports it).
_NOT_PORTED = (
    ("compilation_cache_dir", lambda v: v is not None,
     "compilation_cache_dir (no counterpart: the port compiles no XLA "
     "programs; ROADMAP 'Out of scope')"),
)


def refuse_unported(name: str, value) -> None:
    """Raise NotImplementedError if ``name`` is a field the port does not
    run yet and ``value`` sets it."""
    for field, is_set, item in _NOT_PORTED:
        if field == name and is_set(value):
            raise NotImplementedError(
                f"{item} is not ported to pointnet_autoencoder_tpu_torch "
                f"yet (got {name}={value!r})")


@dataclasses.dataclass
class TrainConfig:
    model: str = "model"
    category: Optional[str] = None
    log_dir: str = "log"
    num_point: int = 2048
    num_gt_point: Optional[int] = None  # a pair family's target points
                                        # (pcn_emd: 16384 when unset)
    max_epoch: int = 201
    batch_size: int = 32
    learning_rate: float = 0.001
    momentum: float = 0.9
    optimizer: str = "adam"
    decay_step: int = 200000
    decay_rate: float = 0.7
    no_rotation: bool = False
    data_path: str = "data/shapenetcore_partanno_segmentation_benchmark_v0"

    input_mode: str = "device"    # "device": dataset resident on the card,
                                  # resampled and rotated there
                                  # (data/device_pipeline.py); "host": host
                                  # batch assembly, pinned copies
    resume: bool = False          # continue from the latest checkpoint
    seed: int = 0                 # data and init seed
    data_parallel: Optional[int] = None
    model_parallel: int = 1
    point_parallel: bool = False
    bf16: bool = True             # bfloat16 matmuls, f32 master weights,
                                  # BN statistics and losses in f32
    bf16_params: bool = False
    bf16_moments: bool = False
    profile_dir: Optional[str] = None
    lr_floor: Optional[float] = None  # the reference's dead 1e-5 clamp
    eval_only: bool = False
    log_every: int = 10           # batches between running-mean log lines
    cache_dir: Optional[str] = None  # on-disk decoded-shape cache (npz)
    compilation_cache_dir: Optional[str] = None
    async_checkpoints: bool = True  # saves from a device snapshot on a
                                    # background thread
                                    # (train/checkpoint.py:AsyncSaver)

    def validate(self) -> "TrainConfig":
        """Raise ValueError for point parallelism with model parallelism
        (they do not compose, as in the JAX package: the TP decoder's
        point-sharded output meets the SP losses' replicated prediction),
        NotImplementedError for a field the port does not run yet; return
        self."""
        if self.point_parallel and self.model_parallel > 1:
            raise ValueError(
                "--point_parallel does not compose with --model_parallel "
                "(the TP decoder's point-sharded output conflicts with the "
                "SP losses' replicated pred seam)")
        for name, _, _ in _NOT_PORTED:
            refuse_unported(name, getattr(self, name))
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        return cls(**json.loads(text))


@dataclasses.dataclass
class TestConfig:
    model: str = "model"
    model_path: str = "log/model.ckpt"
    category: Optional[str] = None
    num_point: int = 2048
    num_group: int = 1
    data_path: str = "data/shapenetcore_partanno_segmentation_benchmark_v0"
    out_dir: Optional[str] = None   # write rendered PNGs here (headless)
    interactive: bool = False       # opencv viewer when a display exists
    num_shapes: Optional[int] = None
    seed: int = 0
