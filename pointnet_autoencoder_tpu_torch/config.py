"""Training configuration: the port's copy of the reference's
``TrainConfig`` (``pointnet_autoencoder_tpu/config.py``), with the same
field names and defaults, except:

- ``input_mode`` defaults to ``"host"``: the host pipeline is the only
  input mode ported; ``"device"`` (a dataset resident on the card) waits
  for ROADMAP slice 5;
- ``async_checkpoints`` defaults to False: saves are synchronous; the
  background saver waits for ROADMAP slice 5.

``validate`` refuses every field this port does not run yet, naming the
ROADMAP item that brings it, instead of ignoring it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

# Fields the port refuses away from their default: (field, test for
# "set", the ROADMAP item that ports it).
_NOT_PORTED = (
    ("input_mode", lambda v: v != "host",
     "input_mode='device' (ROADMAP slice 5, item 9)"),
    ("data_parallel", lambda v: v is not None and v > 1,
     "data_parallel > 1 (ROADMAP slice 5, item 10)"),
    ("model_parallel", lambda v: v > 1,
     "model_parallel > 1 (ROADMAP slice 5, item 11)"),
    ("point_parallel", bool, "point_parallel (ROADMAP slice 5, item 11)"),
    ("bf16_params", bool, "bf16_params (ROADMAP slice 5, item 12)"),
    ("bf16_moments", bool, "bf16_moments (ROADMAP slice 5, item 12)"),
    ("async_checkpoints", bool,
     "async_checkpoints (ROADMAP slice 5, item 12)"),
    ("profile_dir", lambda v: v is not None,
     "profile_dir (ROADMAP slice 6, item 14)"),
    ("compilation_cache_dir", lambda v: v is not None,
     "compilation_cache_dir (no counterpart: the port compiles no XLA "
     "programs; ROADMAP 'Out of scope')"),
)


@dataclasses.dataclass
class TrainConfig:
    model: str = "model"
    category: Optional[str] = None
    log_dir: str = "log"
    num_point: int = 2048
    max_epoch: int = 201
    batch_size: int = 32
    learning_rate: float = 0.001
    momentum: float = 0.9
    optimizer: str = "adam"
    decay_step: int = 200000
    decay_rate: float = 0.7
    no_rotation: bool = False
    data_path: str = "data/shapenetcore_partanno_segmentation_benchmark_v0"

    input_mode: str = "host"      # host batch assembly, pinned copies
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
    async_checkpoints: bool = False

    def validate(self) -> "TrainConfig":
        """Raise NotImplementedError for a field the port does not run
        yet; return self."""
        for name, is_set, item in _NOT_PORTED:
            if is_set(getattr(self, name)):
                raise NotImplementedError(
                    f"{item} is not ported to pointnet_autoencoder_tpu_torch "
                    f"yet (got {name}={getattr(self, name)!r})")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        return cls(**json.loads(text))
