"""Text logging and scalar metrics, the port's counterpart of
``pointnet_autoencoder_tpu/train/logging.py``: a text log mirrored to
LOG_DIR/log_train.txt (the reference's train.py:69-72), scalars appended
to LOG_DIR/scalars.jsonl (one JSON object per record) and, where
``torch.utils.tensorboard`` imports, TensorBoard event files in
LOG_DIR/train and LOG_DIR/test like the reference's FileWriters. Without
it there are no writers and the run goes on. Under data parallelism only
rank 0 logs; the other ranks get a ``NullLogger``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from typing import Dict


class Logger:
    def __init__(self, log_dir: str, filename: str = "log_train.txt",
                 echo: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._fh = open(os.path.join(log_dir, filename), "a")
        self._scalars = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self.echo = echo
        self._tb = {}
        try:  # optional TensorBoard writers (train/ and test/ subdirs)
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        for split in ("train", "test"):
            self._tb[split] = SummaryWriter(os.path.join(log_dir, split))

    def log(self, msg: str) -> None:
        self._fh.write(msg + "\n")
        self._fh.flush()
        if self.echo:
            print(msg)
            sys.stdout.flush()

    def scalars(self, split: str, step: int,
                values: Dict[str, float]) -> None:
        rec = {"split": split, "step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._scalars.write(json.dumps(rec) + "\n")
        self._scalars.flush()
        writer = self._tb.get(split)
        if writer is not None:
            for k, v in values.items():
                writer.add_scalar(k, float(v), int(step))

    def flush(self) -> None:
        """Make everything logged so far durable without closing: the text
        and scalars files flush on every write; the TensorBoard writers
        buffer their events and are the reason this exists."""
        for w in self._tb.values():
            w.flush()

    def close(self) -> None:
        if self._fh.closed:  # idempotent
            return
        self._fh.close()
        self._scalars.close()
        for w in self._tb.values():
            w.close()


class NullLogger:
    """A Logger that writes nothing: the one a data-parallel rank other
    than 0 gets, so that only rank 0 opens the run's files."""

    def log(self, msg: str) -> None:
        pass

    def scalars(self, split: str, step: int,
                values: Dict[str, float]) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


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
