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

Compiled stages (``compiled``, the default on cards), the JAX package's
``_enc_jit`` and ``_dec_jit``: each stage's forward at the microbatch
shape is a captured program (``utils/graphs.py``) in a program cache of
its own device, replayed on the stage's stream in the same schedule. A
program's static output is overwritten by its next replay, so stage 0's
embedding of microbatch i is copied into stage 1's static input on
stage 1's stream right after the hop (into a tensor of stage 1's own
while stage 1 warms up, even on one card), and stage 0 waits for that copy
before it replays for microbatch i+1; stage 0 is issued one microbatch
ahead of stage 1. Stage 1's outputs are cloned. The first call of each
stage and shape in each thread runs eagerly as its warm-up; the CPU runs
eager.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.inference import _on
from pointnet_autoencoder_tpu_torch.utils.graphs import ProgramCache


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
      compiled: on cards, each stage's forward replays a captured program
        (one per stage and microbatch shape, the first call of each in
        each thread eager as its warm-up); False runs eager, the
        reference. The CPU runs eager. ``forward_path`` says which runs,
        and why. Callers in several threads take turns, since the
        programs' static inputs and outputs are shared.
    """

    def __init__(self, session, devices: Optional[Sequence] = None,
                 num_microbatches: int = 4, compiled: bool = True):
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
        # A program cache per stage, each with its own memory pool (the
        # stages replay at once); None where the stages run eager.
        self._programs = ((ProgramCache(self._dev0),
                           ProgramCache(self._dev1))
                          if cuda and compiled else None)
        self.forward_path = (
            f"captured CUDA graphs: stage 0 on {self._dev0}, stage 1 on "
            f"{self._dev1}, a program each per microbatch shape"
            if self._programs is not None else
            "eager (" + ("compiled=False: the eager reference" if cuda
                         else "the CPU runs eager") + ")")
        self._lock = threading.Lock()
        self._warmed: set = set()

    def close(self) -> None:
        """Release the captured programs; the session stays usable and
        captures again on its next calls."""
        for programs in self._programs or ():
            programs.close()
        self._warmed.clear()

    # -- the two stages ------------------------------------------------------

    def _stage0_run(self, points: torch.Tensor) -> torch.Tensor:
        return self._stage0.encode(points, folded=self._folded)

    def _stage1_run(self, feat: torch.Tensor) -> torch.Tensor:
        return self._stage1(feat)[0]

    def _runner(self, stage: int, fn: Callable, like: torch.Tensor
                ) -> Tuple[Callable, Optional[torch.Tensor]]:
        """How stage ``stage`` runs ``fn`` on inputs shaped as ``like`` (on
        the stage's device), as ``(run, into)``: ``run(x)`` issues the
        stage on the current stream and returns its output, which a
        program's next replay overwrites; ``into`` is a program's static
        input (None where the stage takes its input as it is): eager, the
        warm-up on the stage's program cache, or the replay of its
        program."""
        if self._programs is None:
            return fn, None
        cache = self._programs[stage]
        key = (stage, tuple(like.shape), like.dtype)
        warm = (threading.get_ident(),) + key
        if warm not in self._warmed:
            self._warmed.add(warm)
            return (lambda x: cache.warm_up(lambda: fn(x))), None
        prog = cache.program(key, fn, (like,))
        return prog.replay, prog.inputs[0]

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
        parts = list(x.split(self._mb))
        with self._lock:
            if first is None or second is None:
                stage, fn = (1, second) if first is None else (0, first)
                outs = self._one_stage(parts, *self._runner(stage, fn,
                                                            parts[0]),
                                       (s0, s1)[stage])
            else:
                outs = self._two_stages(parts, first, second)
        last = s1 if second is not None else s0
        out_dev = self._dev1 if second is not None else self._dev0
        if last is not None:
            current = torch.cuda.current_stream(out_dev)
            current.wait_stream(last)
            for o in outs:
                o.record_stream(current)
        return torch.cat(outs)[:total].float().cpu().numpy()

    @staticmethod
    def _one_stage(parts: List[torch.Tensor], run: Callable,
                   into: Optional[torch.Tensor], stream) -> List[torch.Tensor]:
        """One stage over the microbatches on ``stream``, each output the
        caller's own."""
        with _stream(stream):
            return [run(p).clone() if into is not None else run(p)
                    for p in parts]

    def _two_stages(self, parts: List[torch.Tensor], first: Callable,
                    second: Callable) -> List[torch.Tensor]:
        """Both stages over the microbatches, stage 0 issued one
        microbatch ahead: stage 0's output of microbatch i hops to stage
        1's stream after an event, where it is copied into stage 1's
        static input (a program's), or copied (stage 0's program) or
        recorded on that stream (both eager) for stage 1's warm-up, and
        stage 0 waits for that hand-over before its next microbatch.
        Returns stage 1's outputs, each the caller's own."""
        s0, s1 = self._streams
        run0, into0 = self._runner(0, first, parts[0])
        # A replayed stage 0 leaves its output in its program's static
        # buffer, which its next replay overwrites.
        static0 = into0 is not None
        stage1: List = []  # (run, into) once stage 0's output shape is known

        def stage0(i):
            with _stream(s0):
                out = run0(parts[i])
                hop = _event(s0)
            return out, hop

        def hand(out, hop):
            if not stage1:
                like = (out if out.device == self._dev1 else
                        torch.empty_like(out, device=self._dev1))
                stage1.extend(self._runner(1, second, like))
            into = stage1[1]
            with _stream(s1):
                if hop is not None:
                    s1.wait_event(hop)
                if into is not None:
                    into.copy_(out)
                    out = into
                else:
                    if hop is not None:
                        out.record_stream(s1)
                    # A copy even on stage 0's own device, where stage 0's
                    # buffer is static (stage 1 warming up after stage 0).
                    out = out.to(self._dev1, copy=static0)
                done = _event(s1)
            if done is not None:
                s0.wait_event(done)
            return out

        outs = []
        nxt = hand(*stage0(0))
        for i in range(len(parts)):
            feat = nxt
            if i + 1 < len(parts):
                ahead = stage0(i + 1)
            run1, into = stage1
            with _stream(s1):
                outs.append(run1().clone() if into is not None
                            else run1(feat))
            if i + 1 < len(parts):
                nxt = hand(*ahead)
        return outs

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


def _event(stream) -> Optional[torch.cuda.Event]:
    """An event recorded on ``stream`` now; None without a stream."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event
