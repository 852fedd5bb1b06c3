"""Device-resident input pipeline, the port's counterpart of
``pointnet_autoencoder_tpu/data/device_pipeline.py``: the decoded dataset
is uploaded to the card once, and each step's batch is gathered,
resampled and rotated there. Per epoch the host uploads one index array
(the epoch's shape order); per step it sends nothing.

Sampling semantics are the reference's: uniform resampling with
replacement over each shape's true point count, fresh randomness on every
access, one rotation angle per shape. The randomness comes from one
``torch.Generator`` on the device, seeded from ``seed``, in place of the
JAX package's PRNG key, so the stream differs from the JAX package's (as
the JAX package's differs from the reference's numpy stream); the epoch's
shape order is numpy's ``default_rng(seed)`` shuffle, the JAX package's.

Batch assembly is split in two so that it can be held against the JAX
package on the same random numbers: ``draw`` makes them, and
``assemble_from`` is a deterministic function of them. Shapes of
different lengths are cyclically padded to the longest; indices are drawn
in [0, true length), so the padding is never sampled.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch import Tensor


class DeviceDataset:
    """A PartDataset's decoded shapes on ``device``.

    data:    (D, P_max, 3) float32, each shape cyclically padded.
    lengths: (D,) int32 true point counts.
    """

    def __init__(self, dataset, device: torch.device | str = "cpu",
                 max_shapes: Optional[int] = None):
        count = len(dataset) if max_shapes is None else min(
            len(dataset), max_shapes)
        shapes = [np.asarray(dataset._load(i)[0], np.float32)
                  for i in range(count)]
        if not shapes:
            raise ValueError("empty dataset")
        lengths = np.array([len(s) for s in shapes], np.int32)
        p_max = int(lengths.max())
        data = np.empty((len(shapes), p_max, 3), np.float32)
        for i, s in enumerate(shapes):
            reps = -(-p_max // len(s))
            data[i] = np.tile(s, (reps, 1))[:p_max]
        self.data = torch.from_numpy(data).to(device)
        self.lengths = torch.from_numpy(lengths).to(device)
        self.num_shapes = len(shapes)
        # The host copies are no longer read; the item cache refills lazily
        # if a host-input consumer shares the dataset.
        if hasattr(dataset, "drop_item_cache"):
            dataset.drop_item_cache()

    def nbytes(self) -> int:
        return self.data.numel() * 4 + self.lengths.numel() * 4


def draw(generator: torch.Generator, batch: int, num_point: int,
         rotate: bool) -> Tuple[Tensor, Optional[Tensor]]:
    """The random numbers of one batch, on the generator's device: ``u``
    (batch, num_point) uniform in [0, 1), and per-shape angles (batch,)
    uniform in [0, 2 pi) when ``rotate`` (else None)."""
    dev = generator.device
    u = torch.rand((batch, num_point), generator=generator, device=dev)
    if not rotate:
        return u, None
    angles = torch.rand((batch,), generator=generator, device=dev)
    return u, angles * (2.0 * math.pi)


def assemble_from(data: Tensor, lengths: Tensor, idxs: Tensor, u: Tensor,
                  angles: Optional[Tensor] = None) -> Tensor:
    """The batch of shapes ``idxs`` (B,) resampled at ``u`` (B, N) and, if
    ``angles`` (B,) is given, rotated about Y: (B, N, 3) float32.

    Point j of shape b is its point ``min(int32(u[b, j] * n), n - 1)``,
    n its true length (the JAX package's rule, in f32). The rotation is
    ``batch @ [[c, 0, s], [0, 1, 0], [-s, 0, c]]`` written as f32
    elementwise products and sums in a fixed order, with c and s taken in
    float64 and rounded to f32, so the card and the CPU agree bit for
    bit (a K=3 matrix product would be a library call, with its own order
    and TF32 setting)."""
    idxs = idxs.long()
    n = lengths[idxs][:, None]
    sel = torch.minimum((u * n.float()).to(torch.int32), n - 1)
    batch = data[idxs[:, None], sel.long()]
    if angles is None:
        return batch
    c = torch.cos(angles.double()).float()[:, None]
    s = torch.sin(angles.double()).float()[:, None]
    x, y, z = batch.unbind(dim=-1)
    return torch.stack([x * c + z * (-s), y, x * s + z * c], dim=-1)


def assemble_batch(data: Tensor, lengths: Tensor, idxs: Tensor,
                   generator: torch.Generator, num_point: int,
                   rotate: bool, rows: slice = slice(None),
                   points: slice = slice(None)) -> Tensor:
    """``draw`` then ``assemble_from``: one batch of shapes ``idxs``, or
    its ``rows`` and ``points``. A data-parallel rank draws the global
    batch's numbers, as one device does, and assembles its own rows only
    (a point-parallel rank its own points of every row), so the ranks'
    slices concatenated are the one-device batch bit for bit."""
    u, angles = draw(generator, idxs.shape[0], num_point, rotate)
    return assemble_from(data, lengths, idxs[rows], u[rows, points],
                         None if angles is None else angles[rows])


class DeviceBatchIterator:
    """Epochs of shape indices on ``device``; the batch itself is built on
    the device by ``assemble_batch`` with this iterator's ``generator``."""

    def __init__(self, num_shapes: int, batch_size: int, shuffle: bool,
                 seed: int = 0, device: torch.device | str = "cpu"):
        self.num_shapes = num_shapes
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def __len__(self) -> int:
        return self.num_shapes // self.batch_size

    def _epoch_indices(self) -> Tensor:
        """The epoch's (len, B) shape indices on the device, in one copy
        (pinned and asynchronous on a card, so the host does not wait for
        the work queued before it)."""
        order = np.arange(self.num_shapes)
        if self.shuffle:
            self._rng.shuffle(order)
        n = len(self)
        host = torch.from_numpy(
            order[:n * self.batch_size].reshape(n, self.batch_size))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def epoch(self) -> Iterator[Tensor]:
        """One (B,) index tensor per batch."""
        yield from self._epoch_indices()

    def epoch_chunks(self, chunk: int) -> Iterator[Tensor]:
        """The epoch as (K, B) index chunks, K = ``chunk`` but for the last
        chunk, which carries the epoch's tail (len % chunk batches)."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        idxs = self._epoch_indices()
        for c0 in range(0, len(idxs), chunk):
            yield idxs[c0:c0 + chunk]
