"""Checkpointing with the reference's two-tier policy, in ``torch.save``
files. The port's counterpart of
``pointnet_autoencoder_tpu/train/checkpoint.py`` (which writes orbax).

Policy: ``best_model_epoch_NNN.ckpt`` whenever the eval loss improves,
``model.ckpt`` overwritten every 10 epochs. A checkpoint is a directory
holding one ``checkpoint.pt`` (its layout in ``checkpoint_file.py``) with
the model state_dict (parameters and BN moving statistics), the optimizer
state, the step, the epoch and the best loss; ``--resume`` restores all of
it, and ``InferenceSession`` loads its model state_dict.

A save writes beside the target, then swaps it in by renaming the old
checkpoint aside (``_swap_in``), so a crash at any instant leaves a
complete checkpoint under the name, its ``.old`` sibling or its
``.saving`` sibling; ``latest()`` knows to look at those. A save refuses
to overwrite a path that is not one of the port's checkpoints.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

from pointnet_autoencoder_tpu_torch.checkpoint_file import (  # noqa: F401
    MARKER,
    is_checkpoint,
    load,
)


def _swap_in(tmp: str, path: str) -> None:
    """Replace ``path`` with the finished checkpoint at ``tmp``, renaming
    the old one aside (atomic) rather than deleting it first."""
    old = path + ".old"
    if os.path.exists(path):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


class CheckpointManager:
    def __init__(self, log_dir: str):
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)

    def _refuse_foreign(self, path: str) -> None:
        if os.path.exists(path) and not is_checkpoint(path):
            raise ValueError(
                f"refusing to overwrite {path}: it exists and is not a "
                f"checkpoint of the port (no {MARKER} inside)")

    def _save(self, name: str, tree: Dict[str, Any]) -> str:
        path = os.path.join(self.log_dir, name)
        self._refuse_foreign(path)
        tmp = path + ".saving"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, MARKER), "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        self._refuse_foreign(path)  # re-check: the write above is a window
        _swap_in(tmp, path)
        # Pointer to the most recently written checkpoint, so resume picks
        # the newest whichever tier wrote it.
        with open(os.path.join(self.log_dir, "LATEST"), "w") as f:
            f.write(name)
        return path

    def save_best(self, epoch: int, tree: Dict[str, Any]) -> str:
        return self._save(f"best_model_epoch_{epoch:03d}.ckpt", tree)

    def save_periodic(self, tree: Dict[str, Any]) -> str:
        return self._save("model.ckpt", tree)

    def latest(self) -> Optional[str]:
        """The most recently written checkpoint in log_dir (the LATEST
        pointer, or its ``.old``/``.saving`` sibling after a crash
        mid-swap); else the highest-numbered best_model_epoch_*, then
        model.ckpt."""
        pointer = os.path.join(self.log_dir, "LATEST")
        if os.path.exists(pointer):
            with open(pointer) as f:
                path = os.path.join(self.log_dir, f.read().strip())
            for candidate in (path, path + ".old", path + ".saving"):
                if is_checkpoint(candidate):
                    return candidate
        best, best_path = -1, None
        for entry in os.listdir(self.log_dir):
            m = re.fullmatch(r"best_model_epoch_(\d+)\.ckpt", entry)
            path = os.path.join(self.log_dir, entry)
            if m and int(m.group(1)) > best and is_checkpoint(path):
                best, best_path = int(m.group(1)), path
        if best_path is not None:
            return best_path
        periodic = os.path.join(self.log_dir, "model.ckpt")
        return periodic if is_checkpoint(periodic) else None
