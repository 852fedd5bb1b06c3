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

``AsyncSaver`` writes checkpoints on a background thread from a snapshot
of the state taken on the device, so that the device-to-host copy and the
file write overlap training (``snapshot`` and ``to_host`` below).
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import threading
from typing import Any, Callable, Dict, Optional

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


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]
                 ) -> Any:
    """``tree`` (dicts, lists and tuples of tensors and plain values) with
    ``fn`` applied to every tensor; the containers are new."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def snapshot(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are cloned where they lie (on the
    device for a state on the card). Adam updates its moments and step
    tensors in place, so a reference to them is not a snapshot."""
    return _map_tensors(tree, lambda t: t.detach().clone())


def to_host(tree: Any) -> Any:
    """``tree`` with every tensor on the CPU (the tensor itself if it is
    there already)."""
    return _map_tensors(tree, lambda t: t.detach().cpu())


class AsyncSaver:
    """Background checkpoint writer, the port's copy of the JAX package's
    ``AsyncSaver``: the device-to-host copy and the file write run on one
    worker thread while training goes on.

    ``submit`` takes a snapshot (``snapshot``) that the training thread
    will not touch again and, for a snapshot on a card, records a CUDA
    event after its clones: the worker runs on its own stream, which
    waits on that event before the copies. One worker, so saves complete
    in submit order and the LATEST pointer stays the newest checkpoint; at
    most two snapshots wait in the queue, and ``submit`` blocks when it
    is full. A worker's exception is raised again on the training thread
    at the next submit, flush or close: a failed checkpoint fails the
    run."""

    def __init__(self, manager: CheckpointManager,
                 log: Optional[Callable[[str], None]] = None):
        self._mgr = manager
        self._log = log
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pcae-torch-ckpt-saver")
        self._thread.start()

    def _run(self) -> None:
        streams: Dict[torch.device, Any] = {}
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                kind, epoch, tree, ready = item
                if ready is None:
                    tree = to_host(tree)
                else:
                    event, device = ready
                    if device not in streams:
                        streams[device] = torch.cuda.Stream(device=device)
                    with torch.cuda.stream(streams[device]):
                        streams[device].wait_event(event)
                        tree = to_host(tree)
                if kind == "best":
                    path = self._mgr.save_best(epoch, tree)
                else:
                    path = self._mgr.save_periodic(tree)
                if self._log is not None:
                    self._log(f"Model saved in file: {path}")
            except BaseException as e:  # noqa: BLE001 - raised on submit
                self._error = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def submit(self, kind: str, epoch: int, tree: Any,
               device: Optional[torch.device] = None) -> None:
        """Queue a save of ``tree`` (``kind`` 'best' or 'periodic'), a
        snapshot nothing else writes. For a snapshot on a card, pass its
        ``device``: an event is recorded here, on the training thread's
        current stream, after the snapshot's clones."""
        self._check()
        ready = None
        if device is not None and device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            ready = (event, device)
        self._q.put((kind, epoch, tree, ready))

    def flush(self) -> None:
        """Block until every submitted save is on disk."""
        self._q.join()
        self._check()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join()
