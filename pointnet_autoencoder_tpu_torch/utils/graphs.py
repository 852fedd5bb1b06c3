"""Captured programs: CUDA graphs of the Trainer's steps, the serving
forwards and the op benchmarks. The port's counterpart of the JAX
package's jitted, donated programs (``train/loop.py``,
``inference.py``), with no JAX module of its own.

A program is one call of a function captured once with
``torch.cuda.CUDAGraph`` and replayed with one launch from the host:

- Its inputs and outputs are static tensors: the inputs are copies of
  the first call's, made before capture; each replay copies its call's
  inputs into them, and the caller reads (or copies out) the outputs
  before the next replay of any program of the same ``ProgramCache``,
  whose programs share one memory pool.
- Capture follows a warm-up: the first call of each kind of work runs
  eagerly on the cache's side stream (``ProgramCache.warm_up``), which
  creates what the work keeps (optimizer slots, library handles, the
  kernels' libraries, built at first use), so that capture records the
  work and nothing else. The warm-up's result is a real result: the
  Trainer takes its first step, a session answers its first call.
- Random numbers drawn from a ``torch.Generator`` inside the program come
  from the generator's stream: the generator is registered with the
  graph, and each replay advances it as the eager calls would.
- Launch counts stay honest. A kernel wrapper adds one to its
  ``.launches`` when its Python code runs, which happens at capture, not
  at replay. Capture restores every counter to its value before capture
  and keeps the difference; each replay adds it. A run's counts are then
  the counts of the eager run that does the same work.
- A capture or a replay that fails raises; nothing runs the eager
  function in its place.

A tape is such a program over collectives that cannot be captured (a
rank of a gloo group: gloo copies each tensor to the host and back). Its
capture ends the open graph at each collective that the function reaches
(``collective``), runs the collective eagerly, and begins the next graph
in the same pool; a replay runs graph, collective, graph, ... in capture
order, each collective on the static tensor that the graph before it
wrote and the graph after it reads. A collective of the backward runs on
autograd's device thread, not on the thread that began the capture, so
a tape's graphs are captured in ``relaxed`` mode, which lets another
thread end a capture (``thread_local`` and ``global`` do not); the work
inside each graph is the one-card step's, which makes no host sync.
Under NCCL the collectives are captured inside the one graph.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Tuple

import torch

from pointnet_autoencoder_tpu_torch.ops import batch_norm, chamfer, emd
from pointnet_autoencoder_tpu_torch.ops import fused_encoder, fused_head

# Every kernel wrapper that counts its launches.
COUNTED = (chamfer.nn_distance_cuda, chamfer.nn_distance_grad_cuda,
           emd.emd_forward_cuda, fused_encoder.encoder_extrema_cuda,
           fused_head.head_max_cuda, fused_head.head_bwd_cuda,
           batch_norm.batch_norm_fwd_cuda, batch_norm.batch_norm_bwd_cuda)


def launch_counts() -> Tuple[int, ...]:
    """Each counted wrapper's ``.launches``, in ``COUNTED`` order."""
    return tuple(fn.launches for fn in COUNTED)


# The tape being recorded, if any. Process-wide, not per thread: the
# backward's collectives reach it from autograd's device thread.
_recording: Optional["CapturedProgram"] = None


def collective(run: Callable[[], None]) -> None:
    """Run ``run``, a collective that works in place on tensors a step
    made, now; or, while a tape is recorded, at a boundary of the tape:
    the open graph's capture ends, ``run`` runs eagerly, the next graph's
    capture begins, and every replay runs ``run`` again at that point."""
    tape = _recording
    if tape is None:
        run()
    else:
        tape._boundary(run)


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` captured on ``stream`` into the memory
    ``pool``, with ``generators`` registered: the calls ``CapturedProgram``
    makes of a graph (``capture``, or ``begin`` and ``end`` for a tape's
    graph; ``replay``; ``reset``). One graph's capture is thread-local, so
    another thread's copies (a background checkpoint save) do not break
    it; a tape's are relaxed, which breaks on them neither. It calls ``capture_begin`` and ``capture_end`` itself: the
    ``torch.cuda.graph`` context also empties the allocator's caches at
    every capture, after which the next clones of the state (a
    checkpoint snapshot) wait on fresh device allocations. As there, the
    card is synchronized first: ``capture_begin`` resets each registered
    generator's offset tensor on the capture stream, which an earlier
    replay still running on another stream reads."""

    def __init__(self, stream: torch.cuda.Stream, pool,
                 generators: Iterable[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        self.stream = stream
        self.pool = pool

    def begin(self, mode: str = "relaxed") -> None:
        """Begin capturing the work queued on ``stream``, from any thread
        (a tape's graph; ``capture`` runs one graph on one thread)."""
        torch.cuda.synchronize(self.stream.device)
        with torch.cuda.stream(self.stream):
            self.graph.capture_begin(self.pool, capture_error_mode=mode)

    def end(self) -> None:
        """End the capture, from any thread in ``relaxed`` mode."""
        with torch.cuda.stream(self.stream):
            self.graph.capture_end()

    @contextlib.contextmanager
    def capture(self):
        self.begin("thread_local")
        try:
            with torch.cuda.stream(self.stream):
                yield
        except BaseException:
            try:
                self.end()
            except RuntimeError:
                pass  # the capture's own failure is the one raised
            raise
        self.end()
        # Replays run on the caller's stream, after what capture_begin
        # queued on the capture stream.
        torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)

    def replay(self) -> None:
        self.graph.replay()

    def reset(self) -> None:
        self.graph.reset()


class CapturedProgram:
    """``fn(*inputs)`` captured into ``graph`` (a ``CudaGraph``, or any
    object with ``capture()``, ``replay()`` and ``reset()``). ``inputs``
    are the static input tensors, ``outputs`` what ``fn`` returned at
    capture: the static tensors every replay overwrites. ``launches``
    holds each counted wrapper's launches in one replay.

    ``next_graph`` makes the program a tape: a factory of the graphs that
    follow ``graph`` (each with ``begin()`` and ``end()``, which ``graph``
    then needs too), one after each ``collective`` that ``fn`` reaches.
    ``steps`` holds the graphs and collectives in replay order;
    ``graphs`` and ``collectives`` count them; ``replays`` counts the
    replays."""

    def __init__(self, fn: Callable, graph,
                 inputs: Tuple[torch.Tensor, ...] = (),
                 next_graph: Optional[Callable] = None):
        self.inputs = inputs
        self.steps: Optional[List] = [graph]
        self._next_graph = next_graph
        before = launch_counts()
        try:
            if next_graph is None:
                with graph.capture():
                    self.outputs = fn(*inputs)
            else:
                self.outputs = self._record(fn, inputs)
        finally:
            self._next_graph = None
            after = launch_counts()
            for counted, n in zip(COUNTED, before):
                counted.launches = n
        self.launches = tuple(a - b for a, b in zip(after, before))
        self.graphs = (len(self.steps) + 1) // 2
        self.collectives = len(self.steps) // 2
        self.replays = 0

    def _record(self, fn: Callable, inputs: Tuple[torch.Tensor, ...]):
        """``fn(*inputs)`` recorded as a tape (on the first graph's
        stream, if it has one); returns its outputs."""
        global _recording
        if _recording is not None:
            raise RuntimeError("a tape is already being recorded")
        stream = getattr(self.steps[0], "stream", None)
        work = (contextlib.nullcontext() if stream is None
                else torch.cuda.stream(stream))
        with work:
            self.steps[0].begin()
            _recording = self
            try:
                out = fn(*inputs)
            except BaseException:
                _recording = None
                try:
                    self.steps[-1].end()
                except RuntimeError:
                    pass  # the recording's own failure is the one raised
                raise
            _recording = None
            self.steps[-1].end()
        if stream is not None:
            torch.cuda.current_stream(stream.device).wait_stream(stream)
        return out

    def _boundary(self, run: Callable[[], None]) -> None:
        """End the open graph, run the collective ``run``, begin the
        next graph."""
        self.steps[-1].end()
        run()
        graph = self._next_graph()
        self.steps += [run, graph]
        graph.begin()

    def load(self, *inputs: torch.Tensor) -> None:
        """Copy ``inputs`` into the static inputs."""
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)

    def replay(self, *inputs: torch.Tensor):
        """Copy ``inputs`` into the static inputs (``load``; none given:
        the inputs as they are) and run the captured work once (a tape's
        graphs and collectives in capture order); returns ``outputs``."""
        if self.steps is None:
            raise RuntimeError("replay of a released program")
        self.load(*inputs)
        for i, step in enumerate(self.steps):
            if i % 2:
                step()
            else:
                step.replay()
        for counted, n in zip(COUNTED, self.launches):
            counted.launches += n
        self.replays += 1
        return self.outputs

    def close(self) -> None:
        """Release the graphs; their inputs and outputs go with them."""
        if self.steps is not None:
            for graph in self.steps[::2]:
                graph.reset()
        self.steps = None
        self.inputs = self.outputs = None


class ProgramCache:
    """The captured programs of one owner on one card (a Trainer, or a
    session's replica): a side stream for warm-up and capture, one memory
    pool that its programs share (they are never replayed at once, and
    each program's outputs are consumed before the next replay), and the
    programs by key. ``close`` releases them all. ``taped``: every program
    is a tape (a rank of a gloo group). ``replays``: the replays of its
    programs, released ones included."""

    def __init__(self, device: torch.device, taped: bool = False):
        if device.type != "cuda":
            raise ValueError(f"captured programs run on a card, not on "
                             f"{device}")
        self.device = device
        self.taped = taped
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
        self._programs: Dict[Hashable, CapturedProgram] = {}
        self._released_replays = 0

    @property
    def replays(self) -> int:
        return self._released_replays + sum(
            p.replays for p in self._programs.values())

    def warm_up(self, fn: Callable):
        """``fn()`` run eagerly on the side stream, ordered after the work
        queued before it and before the work queued after it; returns its
        result. The card is synchronized after it, so that what it
        allocated on the side stream is safe to reuse."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)
        return out

    def program(self, key: Hashable, fn: Callable,
                inputs: Tuple[torch.Tensor, ...] = (),
                generators: Iterable[torch.Generator] = ()
                ) -> CapturedProgram:
        """The program of ``key``; if there is none, ``fn`` captured on
        static copies of ``inputs`` (made before capture, outside the
        graph's pool), as a tape if the cache is ``taped``, every graph
        registering ``generators``."""
        prog = self._programs.get(key)
        if prog is None:
            static = tuple(t.clone() for t in inputs)
            generators = tuple(generators)

            def graph():
                return CudaGraph(self.stream, self.pool, generators)

            with torch.cuda.device(self.device):
                prog = CapturedProgram(fn, graph(), static,
                                       graph if self.taped else None)
            self._programs[key] = prog
        return prog

    def release(self, key: Hashable) -> None:
        """Release the program of ``key``, if there is one."""
        prog = self._programs.pop(key, None)
        if prog is not None:
            self._close([prog])

    def clear(self) -> None:
        """Release every program (before the state they captured is
        replaced)."""
        programs, self._programs = list(self._programs.values()), {}
        self._close(programs)

    def _close(self, programs: List[CapturedProgram]) -> None:
        """Release ``programs``, already out of the cache. Once the cache
        holds none, later captures take a new pool: PyTorch's allocator
        refuses a capture into a pool whose graphs were all released."""
        for prog in programs:
            self._released_replays += prog.replays
            prog.close()
        if programs and not self._programs:
            with torch.cuda.device(self.device):
                self.pool = torch.cuda.graph_pool_handle()

    close = clear

