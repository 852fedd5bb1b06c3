"""Profiling and timing utilities, the port's counterpart of the JAX
package's ``utils/profiling.py``.

The reference has no profiler integration, only wall-clock prints in its
embedded benchmarks. Here: a step timer with percentile summaries for the
training loop, a thin wrapper over ``torch.profiler`` that writes a
Chrome trace (viewable in Perfetto or chrome://tracing), and what the
program records of itself while a ``torch.profiler`` session runs:

- Host spans (``span``): the library step's layers (``step``, and inside
  it ``step.inputs``, ``step.launch``, ``step.outputs``; an eval step's
  ``eval.*``) and the eager step's phases (``step.forward``,
  ``step.loss``, ``step.backward``, ``step.update``). Each is a
  ``torch.profiler.record_function`` range, so it sits in the session's
  trace, the Trainer's ``--profile_dir`` Chrome trace included.
- Phase clocks on the device: a train program that ``StepPrograms``
  captures while a session runs holds five CUDA event records at the
  phase boundaries of its steps, and ``StepPrograms`` reads them as
  ``PhaseSample``s once a replay has completed: the device's wall time
  from one boundary to the next (forward, loss, backward, update, the
  gaps between their kernels included), which no host span can split
  out of a replayed graph. A program captured with no session running
  holds no clocks.

With no session running, ``span`` checks one flag and does nothing else.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch


def _first_tensor(result) -> Optional[torch.Tensor]:
    """The first tensor in ``result``: a tensor, or dicts (in key order),
    lists and tuples of them."""
    if torch.is_tensor(result):
        return result
    if isinstance(result, dict):
        result = [result[k] for k in sorted(result)]
    if isinstance(result, (list, tuple)):
        for item in result:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


class StepTimer:
    """Wall-clock timer for train or serve steps. ``block=True``
    synchronizes on the result, so timings reflect the device's
    completion, not the launch.

    The barrier copies one element of the first tensor in the result to
    the host: the copy waits for the work queued before it on the
    tensor's stream, so it proves the step finished there. It moves a
    single element, not the whole result."""

    def __init__(self, max_records: int = 10000):
        self._times: List[float] = []
        self._max = max_records
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    @staticmethod
    def _barrier(result) -> None:
        leaf = _first_tensor(result)
        if leaf is not None and leaf.numel():
            leaf.detach().reshape(-1)[:1].cpu()  # host fetch

    def stop(self, result=None, block: bool = True) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without a matching start()")
        if result is not None and block:
            self._barrier(result)
        dt = time.perf_counter() - self._t0
        if len(self._times) < self._max:
            self._times.append(dt)
        self._t0 = None
        return dt

    @contextlib.contextmanager
    def step(self, block: bool = True):
        self.start()
        box = {}
        try:
            yield box
        finally:
            self.stop(box.get("result"), block=block)

    def summary(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
        }

    def reset(self) -> None:
        self._times.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """``torch.profiler`` trace of the block, written as a Chrome trace JSON
    under ``log_dir``; a no-op when ``log_dir`` is falsy.

    The trace records host activity, and the card's kernels, copies and
    memsets when ``device`` is a CUDA device (``None``: when a card is
    present). The file is ``trace_rank<r>_<ns>.json``, r this process's
    rank in its ``torch.distributed`` group (0 outside one), so the ranks
    of a data-, point- or tensor-parallel run each write their own. It is
    written on every exit from the block, an exception included; the card
    is synchronized first, so every kernel launched in the block is in
    it."""
    if not log_dir:
        yield
        return
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_rank{rank}_{time.time_ns()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(path)


# Phase samples that a ``StepPrograms`` keeps: the newest, the oldest
# dropped first.
RING = 65536
# The phases of a train step, in order; a clocked step marks their
# boundaries with one CUDA event each, five in all.
PHASES_OF_A_STEP = ("forward", "loss", "backward", "update")


class PhaseSample(NamedTuple):
    """One train step's phases, in ms, from its phase clocks: the device's
    wall time between two boundaries, gaps included; ``step``: the steps
    taken before it."""

    step: int
    forward_ms: float
    loss_ms: float
    backward_ms: float
    update_ms: float


def enabled() -> bool:
    """Whether a ``torch.profiler`` session is running."""
    return torch.autograd._profiler_enabled()


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks its block as the span ``name`` (a
    ``torch.profiler.record_function`` range) while a ``torch.profiler``
    session runs. With no session it is a shared no-op context, and the
    flag check is all the work it does."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def phase_medians(samples: Iterable[PhaseSample]) -> Dict[str, float]:
    """Each phase's median ms over ``samples`` ({} for none)."""
    samples = list(samples)
    if not samples:
        return {}
    return {p: statistics.median(getattr(s, f"{p}_ms") for s in samples)
            for p in PHASES_OF_A_STEP}
