"""The on-disk layout of the port's training checkpoints, shared by the
trainer that writes them (``train/checkpoint.py``) and the inference
session that loads their model state_dict.

A checkpoint is a directory holding one ``checkpoint.pt``, a
``torch.save`` of a dict: the model state_dict, the optimizer state, the
step, the epoch and the best loss. The file is also the marker that makes
the directory one of the port's checkpoints.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

MARKER = "checkpoint.pt"


def is_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MARKER))


def load(path: str, map_location="cpu") -> Dict[str, Any]:
    """The dict a checkpoint directory holds (tensors, numbers, lists and
    dicts only: loaded with ``weights_only=True``)."""
    if not is_checkpoint(path):
        raise ValueError(f"{path} is not a checkpoint of the port (no "
                         f"{MARKER} inside)")
    return torch.load(os.path.join(path, MARKER), map_location=map_location,
                      weights_only=True)
