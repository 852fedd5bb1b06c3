"""Text logging and scalar metrics, the port's counterpart of
``pointnet_autoencoder_tpu/train/logging.py``: a text log mirrored to
LOG_DIR/log_train.txt and scalars appended to LOG_DIR/scalars.jsonl, one
JSON object per record. (The reference's optional TensorBoard writers are
not ported.)
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from typing import Dict


class Logger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._fh = open(os.path.join(log_dir, "log_train.txt"), "a")
        self._scalars = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def log(self, msg: str) -> None:
        self._fh.write(msg + "\n")
        self._fh.flush()
        print(msg)
        sys.stdout.flush()

    def scalars(self, split: str, step: int,
                values: Dict[str, float]) -> None:
        rec = {"split": split, "step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._scalars.write(json.dumps(rec) + "\n")
        self._scalars.flush()

    def close(self) -> None:
        if self._fh.closed:  # idempotent
            return
        self._fh.close()
        self._scalars.close()


def snapshot_config(log_dir: str, config) -> None:
    """Record the run's configuration and the port's model and loop source
    (the reference snapshots its model file and train.py into LOG_DIR)."""
    from pointnet_autoencoder_tpu_torch.models import autoencoder, registry
    from pointnet_autoencoder_tpu_torch.train import loop

    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.json"), "w") as f:
        f.write(config.to_json())
    snap = os.path.join(log_dir, "source_snapshot")
    os.makedirs(snap, exist_ok=True)
    for mod in (autoencoder, registry, loop):
        shutil.copy2(mod.__file__, snap)
