"""Train state: the model (parameters and BN moving statistics), the
optimizer and its slots, and the global step, kept together so that one
checkpoint holds them all. The port's counterpart of
``pointnet_autoencoder_tpu/train/state.py``.

The step reads the learning rate and the BN momentum from 0-dim f32
tensors on the model's device, computed there from a device step
counter (``train/schedules.py``), and the optimizers of
``make_optimizer`` take the learning rate as that tensor: a step makes
no host sync, so it can be captured as a CUDA graph
(``utils/graphs.py``) and replayed with the values of each later step.

A train step's phases (forward, loss, backward, update) are host spans
(``utils/profiling.span``) while a ``torch.profiler`` session runs. A
train program that ``StepPrograms`` captures while a session runs also
marks them with five CUDA events, as event-record nodes, so that each of
its replays stamps its own phases on the device; one captured with no
session running holds no events, so the programs of a run that is not
profiled replay nothing but the step.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable, Deque, Dict, Iterable, Optional, Tuple

import torch
from torch import Tensor, nn

from pointnet_autoencoder_tpu_torch.train.master import MasterOptimizer
from pointnet_autoencoder_tpu_torch.train.schedules import Staircase
from pointnet_autoencoder_tpu_torch.utils import profiling, roofline
from pointnet_autoencoder_tpu_torch.utils.graphs import ProgramCache


# The metrics a train step reports of its schedules: the values it
# applied, the same on every rank of a parallel step.
SCHEDULE_KEYS = ("learning_rate", "bn_decay", "alpha")


class PairedBatch(tuple):
    """An (input, target) batch, for a family whose input and target
    differ (PCN): a tuple of the two tensors whose ``shape`` is the
    input's and whose slices take the same rows of both, so code that
    handles a batch by its rows handles a pair alike."""

    def __new__(cls, inputs: Tensor, target: Tensor):
        return super().__new__(cls, (inputs, target))

    @property
    def shape(self) -> torch.Size:
        return tuple.__getitem__(self, 0).shape

    def __getitem__(self, index):
        if isinstance(index, slice):
            return PairedBatch(*(t[index] for t in self))
        return tuple.__getitem__(self, index)


def split_batch(batch) -> Tuple[Tensor, Tensor]:
    """(input, label) of a batch: a ``PairedBatch``'s two parts, or a
    tensor twice (its own label)."""
    if isinstance(batch, PairedBatch):
        return batch[0], batch[1]
    return batch, batch


def loss_kwargs(loss_fn: Callable, step: Tensor) -> Dict[str, Tensor]:
    """The keywords a loss takes beyond (pred, label, end_points): the
    step counter, for a loss that reads a schedule of it (PCN's alpha)."""
    return {"step": step} if getattr(loss_fn, "reads_step", False) else {}


def combined_metrics(metrics: Dict[str, Any], group,
                     divisor: int) -> Dict[str, Any]:
    """One rank's ``metrics`` with each 0-dim tensor but the schedules'
    summed over ``group`` (a ``parallel.mesh.DataGroup``) in one
    all-reduce and divided by ``divisor``: the global batch's values of a
    grouped step. The schedules' values are every rank's own."""
    keys = sorted(k for k, v in metrics.items()
                  if torch.is_tensor(v) and k not in SCHEDULE_KEYS)
    values = group.sum_(torch.stack([metrics[k].float()
                                     for k in keys])) / divisor
    return dict(metrics, **dict(zip(keys, values.unbind())))


class TraceSGD(torch.optim.Optimizer):
    """Momentum SGD in optax.sgd's trace form (no Nesterov, no dampening):
    ``buf = g + momentum * buf`` from a zero slot, then ``p += -lr * buf``,
    as a few ``torch._foreach_*`` ops. ``lr`` may be a 0-dim tensor on the
    parameters' device, read when the update runs (``torch.optim.SGD``
    turns a tensor learning rate into a host number, which a captured step
    cannot do). The slot is ``momentum_buffer``, as ``torch.optim.SGD``
    names it."""

    def __init__(self, params: Iterable[nn.Parameter], lr: Any = 0.0,
                 momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TraceSGD takes no closure")
        for group in self.param_groups:
            live = [p for p in group["params"] if p.grad is not None]
            if not live:
                continue
            bufs = []
            for p in live:
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                bufs.append(state["momentum_buffer"])
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, [p.grad for p in live])
            lr = group["lr"]
            torch._foreach_add_(live, torch._foreach_mul(bufs, -lr))


def make_optimizer(name: str, params: Iterable[nn.Parameter],
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """'adam' or 'momentum', the reference's two choices: TF's Adam
    defaults (b1 0.9, b2 0.999, eps 1e-8, the same update as optax.adam)
    and ``TraceSGD``. The learning rate is a 0-dim f32 tensor on the
    parameters' device that ``TrainState.set_lr`` writes before each
    step; 0.0 until then. On a card Adam is ``capturable``: its step count
    lives on the card and its update makes no host sync, in the eager
    step and in a captured one alike."""
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    lr = torch.zeros((), dtype=torch.float32, device=device)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=device.type == "cuda")
    if name == "momentum":
        return TraceSGD(params, lr=lr, momentum=momentum)
    raise ValueError(f"unknown optimizer {name!r} (use 'adam' or 'momentum')")


class TrainState:
    """model, optimizer, the learning-rate schedule and the global step
    (the reference's ``batch`` variable): the number of optimizer steps
    taken. The schedules read the step before it advances, as optax reads
    its schedule at the pre-increment count.

    ``step`` is the host's count; ``step_tensor`` the same count on the
    model's device, which the step advances itself (so a replayed step
    advances it too). Setting ``step`` sets both; ``count_steps`` moves
    the host's count alone, after replays that advanced the device's.

    The schedules are ``train.schedules.Staircase``s: the step reads their
    ``tensor`` form of ``step_tensor``, so a replayed step reads each
    later step's values.

    ``phase_clocks``: on a card, five timing events (external, so that a
    captured step records them as graph nodes) that a train step records
    on its stream before its forward and after its forward, loss,
    backward and update while ``clocking`` is set (``StepPrograms`` sets
    it for a capture while a profiler runs); each step overwrites them.
    None on the CPU."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 lr_schedule: Staircase, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self._device = next(model.parameters()).device
        self.step_tensor = torch.zeros((), dtype=torch.int64,
                                       device=self._device)
        self._step = 0
        self.step = step
        # Bumped by load_state_dict, which replaces the optimizer's slot
        # tensors: a captured step of an older generation is stale.
        self.generation = 0
        self.phase_clocks = (tuple(
            torch.cuda.Event(enable_timing=True, external=True)
            for _ in range(len(profiling.PHASES_OF_A_STEP) + 1))
            if self._device.type == "cuda" else None)
        self.clocking = False

    def _clock(self, i: int) -> None:
        """Record phase clock ``i`` on the device's current stream, while
        ``clocking``."""
        if self.clocking:
            self.phase_clocks[i].record(
                torch.cuda.current_stream(self._device))

    def phase_ms(self) -> Optional[Tuple[float, ...]]:
        """The device ms between the phase clocks of the last step that
        recorded them, once the device has passed its last clock; None
        before then, and on the CPU."""
        clocks = self.phase_clocks
        if clocks is None or not clocks[-1].query():
            return None
        return tuple(a.elapsed_time(b) for a, b in zip(clocks, clocks[1:]))

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self._step = int(value)
        self.step_tensor.fill_(self._step)

    def count_steps(self, k: int) -> None:
        """Advance the host's count by ``k`` steps that the device took."""
        self._step += k

    def set_lr(self) -> Tensor:
        """Write lr(step) into the optimizer's groups' tensor learning
        rates, in place, and return it."""
        lr = self.lr_schedule.tensor(self.step_tensor)
        for group in self.optimizer.param_groups:
            group["lr"].copy_(lr)
        return lr

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a checkpoint of any device, written with the learning rate
        as a tensor or a float. The optimizer's groups keep their own
        learning-rate tensors and ``capturable`` flags, which
        ``torch.optim.Optimizer.load_state_dict`` takes from the saved
        groups, and Adam's step counts move to where ``capturable`` wants
        them (the parameter's device, or the host)."""
        kept = [(g["lr"], g.get("capturable"))
                for g in self.optimizer.param_groups]
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        for group, (lr, capturable) in zip(self.optimizer.param_groups,
                                           kept):
            if torch.is_tensor(lr):
                lr.fill_(float(group["lr"]))
                group["lr"] = lr
            if capturable is None:
                continue
            group["capturable"] = capturable
            for p in group["params"]:
                slots = self.optimizer.state.get(p, {})
                if torch.is_tensor(slots.get("step")):
                    slots["step"] = slots["step"].to(
                        p.device if capturable else "cpu", torch.float32)
        self.step = int(state["step"])
        self.generation += 1

    def train_step(self, batch: Tensor, loss_fn: Callable,
                   bn_schedule: Staircase,
                   reduce_gradients: Optional[Callable] = None,
                   context: Callable = contextlib.nullcontext
                   ) -> Dict[str, Tensor]:
        """One optimizer step on ``batch``, its own label, or on a
        ``PairedBatch`` (input, label): forward of the input with
        bn_momentum = bn_schedule(step) and the learning rate lr(step)
        (both read before the step advances), ``loss_fn(pred, label,
        end_points)`` (with ``step=step_tensor`` for a loss that
        ``reads_step``), backward, ``reduce_gradients(parameters)`` (the
        collectives of a parallel step), the optimizer. The forward,
        loss and backward run inside ``context()``. Returns the loss, the
        metrics (detached), and the learning rate and BN momentum the step
        applied, all 0-dim tensors on the device.

        Each phase is a host span (``step.forward``: the schedules and the
        forward; ``step.loss``; ``step.backward``: ``zero_grad``, backward
        and ``reduce_gradients``; ``step.update``: the optimizer and the
        step counts), and while ``clocking`` the phase clocks mark its
        ends."""
        inputs, label = split_batch(batch)
        self._clock(0)
        with profiling.span("step.forward"):
            bn_momentum = bn_schedule.tensor(self.step_tensor)
            lr = self.set_lr()
            with context():
                pred, end_points = self.model(inputs, train=True,
                                              bn_momentum=bn_momentum)
        self._clock(1)
        with profiling.span("step.loss"), context():
            loss, metrics = loss_fn(pred, label, end_points,
                                    **loss_kwargs(loss_fn, self.step_tensor))
        self._clock(2)
        with profiling.span("step.backward"):
            with context():
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            if reduce_gradients is not None:
                reduce_gradients(self.model.parameters())
        self._clock(3)
        with profiling.span("step.update"):
            # The update is the part of a step the card and the CPU run
            # differently by design (utils/roofline.StepCost).
            with roofline.region("optimizer"):
                self.optimizer.step()
            self._step += 1
            self.step_tensor.add_(1)
        self._clock(4)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        out["learning_rate"] = lr
        out["bn_decay"] = bn_momentum
        return out

    @torch.no_grad()
    def eval_step(self, batch: Tensor, loss_fn: Callable,
                  context: Callable = contextlib.nullcontext
                  ) -> Dict[str, Any]:
        """The loss and metrics of the eval forward on ``batch`` (or a
        ``PairedBatch``), at the step's schedules."""
        inputs, label = split_batch(batch)
        with context():
            pred, end_points = self.model(inputs, train=False)
            loss, metrics = loss_fn(pred, label, end_points,
                                    **loss_kwargs(loss_fn, self.step_tensor))
        out = dict(metrics)
        out["loss"] = loss
        return out


class StepPrograms:
    """A ``TrainState``'s steps as captured programs on a card, kept in
    ``programs`` (a ``utils/graphs.ProgramCache``; tapes on a rank of a
    gloo group). The first call of each kind in each thread runs eagerly
    as its warm-up (``warm_up``): a thread's first cuBLAS or cuDNN call
    makes its handle, which cannot happen under capture, and the first
    step makes the optimizer's slots. A new generation of the state
    (``load_state_dict`` replaced the slots) releases every program and
    needs a warm-up again. ``master``: a ``MasterOptimizer``, whose noise
    generators every train program registers, set to the program's first
    step's draw before each replay. ``log``: told each tape's graphs and
    collectives at its capture.

    A train program captured while a ``torch.profiler`` session runs
    holds the state's phase clocks; ``release_clocked`` releases such
    programs, so that the next calls capture them again without. While a
    session runs, each ``run`` first samples the clocks of the last
    replay of a clocked program into ``phases`` (``sample_phases``).
    Every replay of a train program overwrites them, so a loop that
    dispatches ahead gets a sample only after it waited for the device
    (a metrics fetch); a program of several steps (the Trainer's chunk)
    gives its last step's."""

    def __init__(self, state: TrainState, programs,
                 master=None, log: Optional[Callable[[str], None]] = None):
        self.state = state
        self.programs = programs
        self.master = master
        self.log = log
        self._warmed: set = set()
        self._generation = state.generation
        self._logged: set = set()
        # The keys of the programs captured with the phase clocks; the
        # step whose phases the clocks hold after the last replay of one,
        # and the last step sampled.
        self._clocked_keys: set = set()
        self._clocked: Optional[int] = None
        self._sampled: Optional[int] = None
        self.phases: Deque[profiling.PhaseSample] = collections.deque(
            maxlen=profiling.RING)

    def sample_phases(self) -> None:
        """Append the phases of the last replayed clocked train step to
        ``phases``, once, if the device has finished it."""
        if self._clocked is None or self._clocked == self._sampled:
            return
        ms = self.state.phase_ms()
        if ms is not None:
            self.phases.append(profiling.PhaseSample(self._clocked, *ms))
            self._sampled = self._clocked

    def release_clocked(self) -> None:
        """Release the programs captured with the phase clocks; the next
        call of each captures it again, with the clocks only if a
        profiler runs then."""
        for key in self._clocked_keys:
            self.programs.release(key)
        self._clocked_keys.clear()
        self._clocked = None

    def warm(self, kind: str) -> bool:
        """Whether ``kind`` has run its warm-up in this thread and in the
        state's generation."""
        if self._generation != self.state.generation:
            self.programs.clear()
            self._warmed.clear()
            self._generation = self.state.generation
            self._clocked_keys.clear()
            self._clocked = None
        return (threading.get_ident(), kind) in self._warmed

    def warm_up(self, kind: str, fn: Callable):
        """``fn()`` as ``kind``'s warm-up, run eagerly on the programs'
        side stream; returns its result."""
        out = self.programs.warm_up(fn)
        self._warmed.add((threading.get_ident(), kind))
        return out

    def _count_steps(self, k: int) -> None:
        """Advance the host's step counts (the state's, and the master
        optimizer's) by ``k``."""
        self.state.count_steps(k)
        if self.master is not None:
            self.master.count_steps(k)

    def run(self, key, step_rows: Callable, inputs: Tuple[Tensor, ...],
            steps: int = 0, generators: Tuple[torch.Generator, ...] = ()
            ) -> Tensor:
        """Replay the program of ``key`` on ``inputs`` (capturing
        ``step_rows(*inputs)`` first, which returns the f32 rows of its
        steps' metrics); returns the rows, which the next replay
        overwrites. ``steps``: train steps in one replay, which the
        capture counted on the host and each replay counts; a train
        program also registers the master optimizer's noise generators,
        and ``generators``."""

        def record(*static):
            rows = step_rows(*static)
            self._count_steps(-steps)
            if self.state.clocking:
                self._clocked_keys.add(key)
            return rows

        profiled = profiling.enabled()
        if profiled:
            self.sample_phases()
        if steps and self.master is not None:
            generators += self.master.generators
        # A capture holds the phase clocks only while a profiler runs.
        self.state.clocking = (profiled and steps > 0
                               and self.state.phase_clocks is not None)
        try:
            prog = self.programs.program(key, record, inputs, generators)
        finally:
            self.state.clocking = False
        if prog.collectives and self.log and key not in self._logged:
            self._logged.add(key)
            per = max(steps, 1)
            self.log(f"tape {key}: {prog.graphs} graphs and "
                     f"{prog.collectives} collectives a replay "
                     f"({prog.graphs / per:g} and {prog.collectives / per:g} "
                     f"a {'step' if steps else 'replay'})")
        if steps and self.master is not None:
            self.master.seek(self.state.step)
        kind = "step" if steps else "eval"
        with profiling.span(f"{kind}.inputs"):
            prog.load(*inputs)
        with profiling.span(f"{kind}.launch"):
            rows = prog.replay()
        self._count_steps(steps)
        if key in self._clocked_keys:
            self._clocked = self.state.step - 1
        return rows


def _captured(step: Callable, programs: StepPrograms, kind: str,
              train: bool) -> Callable:
    """``step`` (a batch -> 0-dim metric tensors) replayed from a captured
    program of ``programs`` per batch shape, after its warm-up; a train
    step counts one step a replay. A ``PairedBatch`` is a program of two
    static inputs, per pair of shapes. Each call is the span ``step`` (a
    train step) or ``eval``, holding ``<span>.inputs`` and
    ``<span>.launch`` (``StepPrograms.run``) and ``<span>.outputs``: the
    metrics copied out of the program's rows."""
    keys = {}
    name = "step" if train else "eval"

    def call(batch: Tensor):
        with profiling.span(name):
            if not programs.warm(kind):
                return programs.warm_up(kind, lambda: step(batch))
            if isinstance(batch, PairedBatch):
                inputs = tuple(batch)
                key = (kind,) + tuple((tuple(t.shape), t.dtype)
                                      for t in inputs)
            else:
                inputs = (batch,)
                key = (kind, tuple(batch.shape), batch.dtype)

            def rows(*x):
                out = step(x[0] if len(x) == 1 else PairedBatch(*x))
                keys[key] = sorted(out)
                return torch.stack([out[k].float() for k in keys[key]])

            rows = programs.run(key, rows, inputs, steps=int(train))
            with profiling.span(f"{name}.outputs"):
                return dict(zip(keys[key], rows.clone().unbind()))

    call.programs = programs.programs
    call.step_programs = programs
    return call


def captured_step_fns(state: TrainState, train_step: Callable,
                      eval_step: Callable, taped: bool = False
                      ) -> Tuple[Callable, Callable]:
    """``train_step`` and ``eval_step`` of ``state`` (each a batch -> its
    0-dim metric tensors, the train step advancing ``state``) as captured
    programs on the state's card, one per batch shape, the first call of
    each eager as its warm-up; the library steps of ``train/loop.py`` and
    ``parallel/sp.py``. The programs share one ``StepPrograms`` over a
    ``utils/graphs.ProgramCache`` (tapes when ``taped``: a rank of a gloo
    group), held by each function as ``.programs`` (and the
    ``StepPrograms``, whose ``phases`` hold the phase samples, as
    ``.step_programs``); a
    ``MasterOptimizer``'s noise generators are registered with every
    train program, as the Trainer's are."""
    master = (state.optimizer if isinstance(state.optimizer,
                                            MasterOptimizer) else None)
    programs = StepPrograms(
        state, ProgramCache(next(state.model.parameters()).device,
                            taped=taped), master)
    return (_captured(train_step, programs, "train", True),
            _captured(eval_step, programs, "eval", False))
