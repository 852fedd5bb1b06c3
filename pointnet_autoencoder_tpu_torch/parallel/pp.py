"""Pipeline parallelism for serving: the encoder and the decoder on two
stage devices.

Counterpart of ``pointnet_autoencoder_tpu/parallel/pp.py``, scoped as it
is:

* **Serving** is here. Stage 0 (the PointNet encoder and the neck's FC
  layers) and stage 1 (the decoder) each sit on a device of their own,
  with a CUDA stream each; a batch streams through as microbatches, and
  stage 0 of microbatch i+1 runs while stage 1 of microbatch i does. The
  hop between the stages is the (mb, D) embedding, the smallest tensor of
  the forward. Eval BatchNorm uses the moving statistics, so every shape's
  result is independent of the others in its batch: the microbatched
  forward is the unpipelined one, up to the products' summation order at
  another row count.

* **Training** is not pipelined, by design, as in the JAX package. (a)
  Training BatchNorm normalizes with the global batch's statistics (the
  reference's semantics, which data parallelism keeps): GPipe-style
  microbatches would normalize each microbatch by its own statistics and
  change the function trained. (b) The network has no depth to balance:
  the conv5 product (128 -> 1024 over B*N points) is most of the
  encoder's operations against the decoder's few percent, so no schedule
  keeps both stages busy. Its scaling axes are data (batch), tensor
  (decoder columns, ``parallel/tp.py``) and point (``parallel/sp.py``).
  The same imbalance holds for serving: the pipeline hides the decoder's
  latency behind the next microbatch's encoder; it does not double the
  rate.

On one card both stages may share it (``devices=["cuda:0", "cuda:0"]``):
the two streams still overlap, an event orders each hop, and the hopped
embedding is recorded on the consuming stream, so the caching allocator
does not hand its memory to stage 0's next microbatch while stage 1 still
reads it.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.inference import _on


class PipelinedSession:
    """An ``InferenceSession``'s model as a 2-stage serving pipeline over
    two devices.

    Args:
      session: an ``InferenceSession`` (its weights are copied into the
        two stages; the session itself is untouched).
      devices: the two stage devices, stage 0 first; one may repeat.
        Default: the first two visible cards (raises with fewer).
      num_microbatches: microbatches per batch; must divide the session's
        batch_size. Each microbatch's embedding hops from stage 0 to stage
        1 as soon as it is produced.
    """

    def __init__(self, session, devices: Optional[Sequence] = None,
                 num_microbatches: int = 4):
        if devices is None:
            count = (torch.cuda.device_count() if torch.cuda.is_available()
                     else 0)
            if count < 2:
                raise ValueError(
                    f"expected exactly 2 stage devices, got {count} visible "
                    f"card(s); pass devices=[...] (one device may repeat)")
            devices = ["cuda:0", "cuda:1"]
        devices = [resolve_device(d) for d in devices]
        if len(devices) != 2:
            raise ValueError(
                f"expected exactly 2 stage devices, got {len(devices)}")
        if num_microbatches < 1 or session.batch_size % num_microbatches:
            raise ValueError(
                f"num_microbatches={num_microbatches} must divide "
                f"batch_size={session.batch_size}")
        model = session.model
        self.num_point = session.num_point
        self.batch_size = session.batch_size
        self.model_name = session.model_name
        self.devices = devices
        self._mb = session.batch_size // num_microbatches
        self._dev0, self._dev1 = devices

        # Stage 0: the model without its decoder; stage 1: the decoder.
        self._stage0 = copy.deepcopy(model)
        del self._stage0.decoder
        self._stage0.to(self._dev0)
        self._stage1 = copy.deepcopy(model.decoder).to(self._dev1)
        with torch.inference_mode(), _on(self._dev0):
            self._folded = self._stage0.encoder.fold()
        cuda = self._dev0.type == "cuda"
        self._streams = ((torch.cuda.Stream(self._dev0),
                          torch.cuda.Stream(self._dev1)) if cuda
                         else (None, None))

    # -- the two stages ------------------------------------------------------

    def _stage0_run(self, points: torch.Tensor) -> torch.Tensor:
        return self._stage0.encode(points, folded=self._folded)

    def _stage1_run(self, feat: torch.Tensor) -> torch.Tensor:
        return self._stage1(feat)[0]

    @torch.inference_mode()
    def _microbatched(self, arr: np.ndarray, first, second) -> np.ndarray:
        """Stream ``arr`` (leading axis) through ``first`` on stage 0's
        device (if given) and ``second`` on stage 1's (if given), one
        microbatch at a time, each stage on its own stream; the ragged
        tail is zero-padded and the padding sliced off."""
        total = arr.shape[0]
        pad = -total % self._mb
        if pad:
            arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:],
                                                arr.dtype)])
        s0, s1 = self._streams
        src = self._dev0 if first is not None else self._dev1
        with _stream(s0 if first is not None else s1):
            # One copy in for the whole batch, on the stream that reads it.
            x = torch.from_numpy(arr).to(src)
        outs = []
        for start in range(0, arr.shape[0], self._mb):
            part = x[start:start + self._mb]
            if first is not None:
                with _stream(s0):
                    part = first(part)
                    hop = torch.cuda.Event() if s0 is not None else None
                    if hop is not None:
                        hop.record(s0)
                if second is not None:
                    with _stream(s1):
                        if hop is not None:
                            s1.wait_event(hop)
                            part.record_stream(s1)
                        part = part.to(self._dev1)
            if second is not None:
                with _stream(s1):
                    part = second(part)
            outs.append(part)
        last = s1 if second is not None else s0
        out_dev = self._dev1 if second is not None else self._dev0
        if last is not None:
            current = torch.cuda.current_stream(out_dev)
            current.wait_stream(last)
            for o in outs:
                o.record_stream(current)
        return torch.cat(outs)[:total].float().cpu().numpy()

    # -- the public API ------------------------------------------------------

    def _check_points(self, points) -> Tuple[np.ndarray, bool]:
        pts = np.asarray(points, np.float32)
        single = pts.ndim == 2
        if single:
            pts = pts[None]
        if pts.shape[1:] != (self.num_point, 3):
            raise ValueError(
                f"expected (*, {self.num_point}, 3), got {pts.shape}")
        if pts.shape[0] == 0:
            raise ValueError("got 0 input shapes")
        return pts, single

    def reconstruct(self, points) -> np.ndarray:
        """(B, N, 3) or (N, 3) -> reconstruction(s), the wrapped session's
        forward through both stages."""
        pts, single = self._check_points(points)
        out = self._microbatched(pts, self._stage0_run, self._stage1_run)
        return out[0] if single else out

    def embed(self, points) -> np.ndarray:
        """(B, N, 3) or (N, 3) -> embedding(s): stage 0 alone."""
        pts, single = self._check_points(points)
        out = self._microbatched(pts, self._stage0_run, None)
        return out[0] if single else out

    def decode(self, embeddings) -> np.ndarray:
        """(B, D) or (D,) latent(s) -> decoded cloud(s): stage 1 alone."""
        emb = np.asarray(embeddings, np.float32)
        single = emb.ndim == 1
        if single:
            emb = emb[None]
        if emb.ndim != 2 or emb.shape[0] == 0:
            raise ValueError(f"expected nonempty (B, D) or (D,), "
                             f"got {emb.shape}")
        out = self._microbatched(emb, None, self._stage1_run)
        return out[0] if single else out


def _stream(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())
