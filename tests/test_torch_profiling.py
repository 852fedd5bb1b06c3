"""StepTimer and trace (utils/profiling.py), the twin of the JAX package's
tests/test_profiling.py, the program's spans and phase clocks, and the
Trainer's --profile_dir trace on the CPU; also the synthetic fixture's
real-archive scale (data/synthetic.py), the calibration input of
full-dataset timings, against the JAX package's.
"""

import contextlib
import filecmp
import json
import os
import signal

import pytest
import torch

from pointnet_autoencoder_tpu.data import synthetic as jsynthetic
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.train import schedules
from pointnet_autoencoder_tpu_torch.train.loop import Trainer, make_step_fns
from pointnet_autoencoder_tpu_torch.train.state import (
    StepPrograms, TrainState, _captured, make_optimizer)
from pointnet_autoencoder_tpu_torch.utils import graphs, profiling
from pointnet_autoencoder_tpu_torch.utils.profiling import StepTimer, trace

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 4
CPU = [torch.profiler.ProfilerActivity.CPU]
PHASE_SPANS = ["step.forward", "step.loss", "step.backward", "step.update"]


def test_step_timer_records_and_summarizes():
    t = StepTimer()
    for _ in range(5):
        with t.step() as box:
            box["result"] = {"loss": torch.ones((4,)) * 2}
    s = t.summary()
    assert s["steps"] == 5
    assert s["mean_ms"] > 0
    assert s["p50_ms"] <= s["p90_ms"] <= s["p99_ms"]
    t.reset()
    assert t.summary() == {}


def test_trace_noop_without_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None):
        pass
    with trace(""):
        pass
    assert os.listdir(tmp_path) == []


def test_trace_writes(tmp_path):
    with trace(str(tmp_path / "tr"), device="cpu"):
        torch.ones((8, 8)).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].startswith("trace_rank0_")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with trace(str(tmp_path / "tr"), device="cpu"):
            torch.ones((4,)).sum()
            raise ValueError("inside")
    assert len(os.listdir(tmp_path / "tr")) == 1


def test_step_timer_stop_without_start_raises():
    """Misuse (stop with no start, or double stop) must raise, not record
    a ~0 sample that silently drags the percentile summary toward zero."""
    t = StepTimer()
    with pytest.raises(RuntimeError, match="without a matching start"):
        t.stop()
    t.start()
    t.stop()
    with pytest.raises(RuntimeError, match="without a matching start"):
        t.stop()
    assert t.summary()["steps"] == 1


def test_a_span_without_a_profiler_records_nothing(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not profiling.enabled()
    with profiling.span("outer"):
        with profiling.span("inner"):
            torch.ones(2).sum()
    assert entered == []
    # The same spans in a session enter the (counting) range.
    with torch.profiler.profile(activities=CPU):
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    assert entered == ["outer", "inner"]


def test_spans_in_a_session_nest():
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(8).sum()
            with profiling.span("second"):
                pass
        with profiling.span("alone"):
            pass
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    for name in ("outer", "inner", "second", "alone"):
        assert len(events[name]) == 1, name
    (outer,), (inner,), (second,), (alone,) = (
        events[n] for n in ("outer", "inner", "second", "alone"))
    assert inner.cpu_parent.name == "outer"
    assert second.cpu_parent.name == "outer"
    assert alone.cpu_parent is None
    o, i, s2 = outer.time_range, inner.time_range, second.time_range
    assert o.start <= i.start <= i.end <= s2.start <= s2.end <= o.end \
        <= alone.time_range.start


def test_phase_medians():
    samples = [profiling.PhaseSample(s, s, 2 * s, 3 * s, 1.0)
               for s in (1, 5, 3)]
    assert profiling.phase_medians(samples) == {
        "forward": 3, "loss": 6, "backward": 9, "update": 1.0}
    assert profiling.phase_medians([]) == {}


def _state(seed=0):
    model = get_model_spec("model").make(
        NUM_POINT, dtype=torch.float32,
        generator=torch.Generator().manual_seed(seed))
    lr = schedules.learning_rate_schedule(1e-3, 0.7, BATCH, 200000)
    return TrainState(model, make_optimizer("adam", model.parameters()), lr)


def _batches(n=3):
    gen = torch.Generator().manual_seed(5)
    return [torch.rand((BATCH, NUM_POINT, 3), generator=gen)
            for _ in range(n)]


def _names(prof):
    """The names of the session's host events, in start order."""
    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)]


def test_the_eager_step_spans_its_phases_in_order():
    state = _state()
    assert state.phase_clocks is None  # no CUDA events on the CPU
    loss_fn = get_model_spec("model").loss_fn
    bn = schedules.bn_momentum_schedule(BATCH, 200000)
    batch = _batches(1)[0]
    with torch.profiler.profile(activities=CPU) as prof:
        state.train_step(batch, loss_fn, bn)
    assert [n for n in _names(prof) if n in PHASE_SPANS] == PHASE_SPANS
    spans = {e.name: e.time_range for e in prof.events()
             if e.name in PHASE_SPANS}
    ranges = [spans[n] for n in PHASE_SPANS]
    assert all(a.end <= b.start for a, b in zip(ranges, ranges[1:]))
    assert state.phase_ms() is None


def test_profiling_leaves_the_library_step_bit_equal():
    bn = schedules.bn_momentum_schedule(BATCH, 200000)
    losses, names = {}, []
    for traced in (False, True):
        state = _state()
        step, _ = make_step_fns(state, "model", bn, compiled=False)
        session = (torch.profiler.profile(activities=CPU) if traced
                   else contextlib.nullcontext())
        with session as prof:
            losses[traced] = [step(b)["loss"] for b in _batches()]
        if traced:
            names = [n for n in _names(prof) if n in PHASE_SPANS]
    assert all(torch.equal(a, b) for a, b in zip(losses[False],
                                                 losses[True]))
    assert names == PHASE_SPANS * 3


class StandInGraph:
    """A capture that runs the function once; a replay that runs nothing."""

    def capture(self):
        return contextlib.nullcontext()

    def replay(self):
        pass

    def reset(self):
        pass


class StandInCache:
    """``ProgramCache``'s calls on the CPU, over ``StandInGraph``s;
    ``released``: the keys released one by one."""

    def __init__(self):
        self.programs = {}
        self.released = []

    def warm_up(self, fn):
        return fn()

    def program(self, key, fn, inputs=(), generators=()):
        if key not in self.programs:
            self.programs[key] = graphs.CapturedProgram(
                fn, StandInGraph(), tuple(t.clone() for t in inputs))
        return self.programs[key]

    def release(self, key):
        if self.programs.pop(key, None) is not None:
            self.released.append(key)

    def clear(self):
        self.programs.clear()

    close = clear


class StandInEvent:
    """A phase clock on the CPU: counts its records."""

    def __init__(self):
        self.records = 0

    def record(self, stream):
        self.records += 1


CLOCKS = (1.0, 0.5, 2.0, 0.25)


def _stand_in_clocks(state, monkeypatch, done):
    """Phase clocks on ``state`` that count their records and read
    ``CLOCKS`` ms once ``done["now"]``."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    state.phase_clocks = tuple(StandInEvent() for _ in range(5))
    monkeypatch.setattr(state, "phase_ms",
                        lambda: CLOCKS if done["now"] else None)


def test_the_library_step_spans_and_samples_each_step_once(monkeypatch):
    """The captured library step under a stand-in cache: a call is a
    ``step`` span over ``step.inputs``, ``step.launch`` and
    ``step.outputs``; a capture in a session records the phase clocks,
    and each call in a session first samples the last replayed step's
    clocks, once, and only once they are done. A program captured with
    no session, after ``release_clocked``, holds no clocks."""
    state = _state()
    loss_fn = get_model_spec("model").loss_fn
    bn = schedules.bn_momentum_schedule(BATCH, 200000)
    programs = StepPrograms(state, StandInCache())
    step = _captured(lambda b: state.train_step(b, loss_fn, bn), programs,
                     "train", True)
    done = {"now": False}
    _stand_in_clocks(state, monkeypatch, done)

    def records():
        return [e.records for e in state.phase_clocks]

    batches = _batches(5)
    with torch.profiler.profile(activities=CPU) as prof:
        step(batches[0])   # warm-up, eager: no clocks, nothing to sample
        assert records() == [0] * 5
        step(batches[1])   # capture with the clocks, replays step 1
        assert records() == [1] * 5
        step(batches[2])   # step 1 still running: no sample; replays 2
        done["now"] = True
        step(batches[3])   # samples step 2, replays step 3
    step(batches[4])       # no session: no sample, no span
    assert list(programs.phases) == [profiling.PhaseSample(2, *CLOCKS)]
    with torch.profiler.profile(activities=CPU):
        programs.sample_phases()
        programs.sample_phases()
    assert [s.step for s in programs.phases] == [2, 4]
    names = [n for n in _names(prof) if n.startswith("step")]
    assert names.count("step") == 4
    assert names[-4:] == ["step", "step.inputs", "step.launch",
                          "step.outputs"]
    assert state.step == 5

    programs.release_clocked()
    assert programs.programs.released == [("train", tuple(batches[0].shape),
                                           batches[0].dtype)]
    step(batches[0])       # captured again, with no session: no clocks
    with torch.profiler.profile(activities=CPU):
        step(batches[1])   # replays the program without clocks
    programs.sample_phases()
    assert records() == [1] * 5 and len(programs.phases) == 2
    assert state.step == 7


def test_a_new_generation_forgets_the_clocked_programs(monkeypatch):
    """A loaded state (a new generation) releases every program: the
    clocks of the old ones are neither sampled nor released again."""
    state = _state()
    loss_fn = get_model_spec("model").loss_fn
    bn = schedules.bn_momentum_schedule(BATCH, 200000)
    programs = StepPrograms(state, StandInCache())
    step = _captured(lambda b: state.train_step(b, loss_fn, bn), programs,
                     "train", True)
    _stand_in_clocks(state, monkeypatch, {"now": True})
    batches = _batches(2)
    with torch.profiler.profile(activities=CPU):
        step(batches[0])
        step(batches[1])
    state.generation += 1
    assert not programs.warm("train") and programs.programs.programs == {}
    programs.sample_phases()
    programs.release_clocked()
    assert len(programs.phases) == 0 and programs.programs.released == []


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """30 Chair shapes: 25 trainval (6 batches of 4), 5 test (1 batch)."""
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 30, NUM_POINT, categories=["Chair"])


def _config(fixture_root, tmp_path, **kw):
    return TrainConfig(data_path=fixture_root, category="Chair",
                       num_point=NUM_POINT, batch_size=BATCH,
                       log_dir=str(tmp_path / "log"),
                       profile_dir=str(tmp_path / "prof"), bf16=False,
                       **kw)


def _log(tmp_path) -> str:
    with open(tmp_path / "log" / "log_train.txt") as f:
        return f.read()


def test_trainer_traces_only_its_first_epoch(fixture_root, tmp_path):
    trainer = Trainer(_config(fixture_root, tmp_path, max_epoch=2),
                      device="cpu")
    try:
        trainer.train()
    finally:
        trainer.close()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names  # the train steps and the eval are inside
    assert set(PHASE_SPANS) <= names  # the eager steps' phases
    log = _log(tmp_path)
    assert log.count("profiler trace written to") == 1
    first = log.index("profiler trace written to")
    phases = log.index("step phases on the device: none sampled (the CPU "
                       "has no phase clocks)")
    assert log.index("---- EPOCH 000 EVALUATION ----") < first < phases \
        < log.index("**** EPOCH 001 ****")


def test_the_trainer_logs_the_medians_of_its_own_samples(
        fixture_root, tmp_path, monkeypatch):
    """The Trainer's chunks under a stand-in cache with phase clocks that
    read done: the traced epoch's line gives the medians of the samples
    it took, and the programs captured with the clocks are released
    after it, so that the next epoch captures them again without."""
    trainer = Trainer(_config(fixture_root, tmp_path, max_epoch=2,
                              log_every=2), device="cpu")
    try:
        trainer._steps = StepPrograms(trainer.state, StandInCache())
        _stand_in_clocks(trainer.state, monkeypatch, {"now": True})
        trainer.train()
        taken = len(trainer._steps.phases)
        released = trainer._steps.programs.released
        records = [e.records for e in trainer.state.phase_clocks]
        kept = sorted(trainer._steps.programs.programs)
    finally:
        trainer.close()
    assert taken >= 1
    assert (f"step phases on the device, median ms of {taken} sampled "
            f"steps: forward 1.0000, loss 0.5000, backward 2.0000, update "
            f"0.2500") in _log(tmp_path)
    # Each train program of the first epoch held the clocks (a chunk of
    # two steps records each clock twice), and was captured again.
    assert released and all(key[0] == "train" for key in released)
    assert records == [2 * len(released)] * 5
    assert set(released) <= set(kept)


def test_trainer_writes_the_trace_on_preemption(fixture_root, tmp_path):
    """SIGTERM after the first step: the epoch stops at the next step
    boundary and its trace is written before the preemption save."""
    trainer = Trainer(_config(fixture_root, tmp_path, max_epoch=3),
                      device="cpu")
    real_step = trainer.train_step

    def step_and_signal(batch):
        out = real_step(batch)
        signal.raise_signal(signal.SIGTERM)
        return out

    trainer.train_step = step_and_signal
    try:
        trainer.train()
    finally:
        trainer.close()
    assert trainer.state.step == 1
    assert len(os.listdir(tmp_path / "prof")) == 1
    log = _log(tmp_path)
    assert log.index("profiler trace written to") \
        < log.index("preemption checkpoint saved")
    assert "EVALUATION" not in log


def test_write_fixture_category_counts_match_the_jax_package(tmp_path):
    counts = {"Mug": 3, "Rocket": 5, "Chair": 2}
    ours = synthetic.write_fixture(str(tmp_path / "a"), points_per_shape=40,
                                   seed=5, variable_points=True,
                                   category_counts=counts)
    theirs = jsynthetic.write_fixture(str(tmp_path / "b"),
                                      points_per_shape=40, seed=5,
                                      variable_points=True,
                                      category_counts=counts)
    _assert_same_tree(ours, theirs)
    with open(os.path.join(ours, "synsetoffset2category.txt")) as f:
        assert [line.split()[0] for line in f] == list(counts)


def _assert_same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    for sub in cmp.subdirs:
        _assert_same_tree(os.path.join(a, sub), os.path.join(b, sub))
    # dircmp compares by stat; hold the bytes of every file too.
    for name in cmp.common_files:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def test_real_scale_fixture_takes_the_published_counts(tmp_path,
                                                       monkeypatch):
    assert synthetic.REAL_V0_COUNTS == jsynthetic.REAL_V0_COUNTS
    assert len(synthetic.REAL_V0_COUNTS) == 16
    assert sum(synthetic.REAL_V0_COUNTS.values()) == 16881
    small = {c: 1 + i % 3 for i, c in enumerate(synthetic.REAL_V0_COUNTS)}
    monkeypatch.setattr(synthetic, "REAL_V0_COUNTS", small)
    monkeypatch.setattr(jsynthetic, "REAL_V0_COUNTS", small)
    ours = synthetic.write_real_scale_fixture(str(tmp_path / "a"),
                                              points_per_shape=30, seed=2)
    theirs = jsynthetic.write_real_scale_fixture(str(tmp_path / "b"),
                                                 points_per_shape=30, seed=2)
    _assert_same_tree(ours, theirs)
    sizes = set()
    for cat, synset in synthetic._SYNSETS.items():
        pts = os.listdir(os.path.join(ours, synset, "points"))
        assert len(pts) == small[cat], cat
        for name in pts:
            with open(os.path.join(ours, synset, "points", name)) as f:
                sizes.add(len(f.readlines()))
    assert min(sizes) >= 15 and max(sizes) <= 30 and len(sizes) > 1
