"""Host-to-device input pipeline, the port's copy of
``pointnet_autoencoder_tpu/data/pipeline.py:BatchPipeline``.

Batch assembly and augmentation run on a background thread with a
bounded queue, so the next batch is ready while the card runs the current
step. On a CUDA device each batch is staged in pinned host memory by the
producer and copied with ``non_blocking=True`` (PyTorch's pinned-memory
allocator keeps the buffer until that copy has finished).

Epoch semantics match the reference: a fresh shuffle per train epoch,
``len(dataset) // batch_size`` full batches (the remainder dropped), a
per-shape Y-axis rotation unless disabled, eval unshuffled and unrotated.
The autoencoder's label is the augmented input, so the pipeline yields one
(B, N, 3) float32 tensor per step. A producer error is re-raised in the
consumer: a failed batch fails the epoch instead of shortening it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch.data.shapenet_part import (
    rotate_point_cloud,
)

_STOP = object()
# Batches assembled ahead of the consumer: one being copied to the device
# while the next is built.
_QUEUE_DEPTH = 2


class _ProducerError:
    """Carries a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class BatchPipeline:
    """Iterable over (B, N, 3) float32 batches on ``device``."""

    def __init__(self, dataset, batch_size: int, rotate: bool = True,
                 shuffle: bool = True, device: torch.device | str = "cpu",
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rotate = rotate
        self.shuffle = shuffle
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _assemble(self, idxs: np.ndarray) -> torch.Tensor:
        n = self.dataset.npoints
        batch = np.empty((len(idxs), n, 3), dtype=np.float32)
        for j, idx in enumerate(idxs):
            pts, _ = self.dataset[int(idx)]
            batch[j] = pts
        if self.rotate:
            batch = rotate_point_cloud(batch, self._rng)
        host = torch.from_numpy(batch)
        return host.pin_memory() if self.device.type == "cuda" else host

    @staticmethod
    def _put_unless_stopped(q: queue.Queue, item, stop: threading.Event
                            ) -> bool:
        """Blocking put that gives up when the consumer abandons the epoch
        (early break, dropped iterator) instead of blocking forever on a
        full queue. Returns False if it gave up."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self, order: np.ndarray, q: queue.Queue,
                  stop: threading.Event):
        try:
            for b in range(len(self)):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                if not self._put_unless_stopped(q, self._assemble(idxs),
                                                stop):
                    return
            self._put_unless_stopped(q, _STOP, stop)
        except BaseException as e:  # delivered to the consumer, re-raised
            self._put_unless_stopped(q, _ProducerError(e), stop)

    def epoch(self) -> Iterator[torch.Tensor]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
        stop = threading.Event()
        worker = threading.Thread(
            target=self._producer, args=(order, q, stop), daemon=True,
            name="pcae-torch-pipeline-producer")
        worker.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    break
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item.to(self.device, non_blocking=True)
        finally:
            # On exhaustion and on early abandonment (generator close):
            # the stop event unblocks a producer waiting on a full queue.
            stop.set()
            worker.join(timeout=5.0)
