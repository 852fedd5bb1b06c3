"""The tape of a rank of a gloo group (``utils/graphs.py``): a captured
program whose graphs end and begin at each collective, the collectives
run eagerly between the replays.

On 2 CPU ranks over gloo (``parallel.mesh.launch``, rank bodies in
tests/torch_dp_workers.py), a Trainer at f32, N=128, B=8 takes 3 steps
on host input, eager and through a tape of stand-in graphs (the first
step the eager warm-up, the second captured, the third replayed) that
record the aten ops between two collectives and replay them on the
same tensors: the data-parallel ``model`` step and the point-parallel
``model_emd`` step (its EMD's 10 column sums among the collectives).
The tape holds as many collectives as an eager step issues, at most one
graph more, replays them in capture order, and its steps are bit-equal
to the eager steps (every loss, parameter and BN statistic), with equal
launch counts. The momentum optimizer: Adam on the CPU reads its step
count on the host, which no capture can replay (Adam is capturable on a
card only).

Single-process cases hold the tape's bookkeeping with stand-in graphs:
capture order, one run of each collective at capture and one per
replay, the launch counters, a failed recording, and a program without
a tape, whose collectives stay inside its one graph (NCCL).
"""

import contextlib

import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.ops import chamfer
from pointnet_autoencoder_tpu_torch.parallel import mesh
from pointnet_autoencoder_tpu_torch.utils import graphs

torch.set_num_threads(2)

NUM_POINT = 128
BATCH = 8
STEPS = 3
CASES = {"dp-model": dict(model="model"),
         "sp-model_emd": dict(model="model_emd", point_parallel=True,
                              data_parallel=2)}
# The collectives of one data-parallel `model` step: conv1-4's BN, the
# head's statistics, fc1's and fc2's BN, forward and backward, and the
# gradients.
DP_MODEL_COLLECTIVES = 15


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tape")
    root = synthetic.write_fixture(str(tmp / "fixture"), 20, NUM_POINT,
                                   categories=["Chair"])
    configs = {tag: TrainConfig(
        data_path=root, category="Chair", num_point=NUM_POINT,
        batch_size=BATCH, bf16=False, optimizer="momentum",
        input_mode="host", log_dir=str(tmp / tag), **flags).to_json()
        for tag, flags in CASES.items()}
    batch = np.random.RandomState(0).rand(BATCH, NUM_POINT, 3).astype(
        np.float32)
    out = tmp / "ranks"
    out.mkdir()
    mesh.launch(workers.tape_rank, devices=["cpu", "cpu"], backend="gloo",
                init_method=f"file://{tmp / 'store'}",
                args=(configs, batch, str(out), STEPS))
    return workers.load_ranks(str(out), 2)


def _collectives(log):
    return sum(1 for e in log if e == ("collective",))


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_tape_holds_the_eager_steps_collectives(ranks, case):
    for rank in ranks:
        eager, tape = rank[case]["eager"], rank[case]["tape"]
        issued = {_collectives(log) for log in eager["log"]}
        assert len(issued) == 1
        assert tape["collectives"] == issued.pop()
        # The warm-up is the eager step.
        assert _collectives(tape["log"][0]) == tape["collectives"]
    if case == "dp-model":
        assert ranks[0][case]["tape"]["collectives"] == DP_MODEL_COLLECTIVES


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_tape_replays_its_graphs_in_capture_order(ranks, case):
    for rank in ranks:
        tape = rank[case]["tape"]
        n = tape["collectives"]
        assert tape["graphs"] == n + 1
        replay = [("graph", 0)]
        for i in range(1, n + 1):
            replay += [("collective",), ("graph", i)]
        capture = [("begin", 0)]
        for i in range(1, n + 1):
            capture += [("collective",), ("begin", i)]
        # The second step captures, then replays; the third replays.
        assert tape["log"][1] == capture + replay
        assert tape["log"][2] == replay
        assert tape["recording"] is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_tape_steps_are_bit_equal_to_eager_steps(ranks, case):
    for rank in ranks:
        eager, tape = rank[case]["eager"], rank[case]["tape"]
        assert eager["step"] == tape["step"] == STEPS
        for a, b in zip(tape["losses"], eager["losses"]):
            assert torch.equal(a, b)
        for kind in ("params", "buffers"):
            assert eager[kind].keys() == tape[kind].keys()
            for name, want in eager[kind].items():
                assert torch.equal(tape[kind][name], want), (kind, name)
    # The ranks hold one model.
    for kind in ("params", "buffers"):
        for name, t in ranks[0][case]["tape"][kind].items():
            assert torch.equal(t, ranks[1][case]["tape"][kind][name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_tape_launches_equal_eager(ranks, case):
    for rank in ranks:
        launches = rank[case]["tape"]["launches"]
        assert launches == rank[case]["eager"]["launches"]
        assert all(n % STEPS == 0 for n in launches) and any(launches)


# -- the bookkeeping, in one process ------------------------------------------


class CountingGraph:
    """A stand-in graph that notes its capture's begin and end and each
    replay in ``log``."""

    def __init__(self, log, index):
        self.log, self.index = log, index

    def begin(self):
        self.log.append(("begin", self.index))

    def end(self):
        self.log.append(("end", self.index))

    @contextlib.contextmanager
    def capture(self):
        self.begin()
        yield
        self.end()

    def replay(self):
        self.log.append(("replay", self.index))

    def reset(self):
        pass


def _graphs(log):
    made = []

    def graph():
        made.append(CountingGraph(log, len(made)))
        return made[-1]

    return graph


def test_a_tape_runs_each_collective_once_at_capture_and_once_a_replay():
    log = []
    x = torch.zeros(2)
    before = graphs.launch_counts()

    def step(t):
        chamfer.nn_distance_cuda.launches += 1
        graphs.collective(lambda: log.append(("collective", "a")))
        chamfer.nn_distance_cuda.launches += 2
        graphs.collective(lambda: log.append(("collective", "b")))
        return t

    new_graph = _graphs(log)
    try:
        prog = graphs.CapturedProgram(step, new_graph(), (x,), new_graph)
        assert graphs._recording is None
        assert graphs.launch_counts() == before
        assert (prog.graphs, prog.collectives) == (3, 2)
        assert log == [("begin", 0), ("end", 0), ("collective", "a"),
                       ("begin", 1), ("end", 1), ("collective", "b"),
                       ("begin", 2), ("end", 2)]
        del log[:]
        for _ in range(2):
            prog.replay(torch.ones(2))
        assert log == [("replay", 0), ("collective", "a"), ("replay", 1),
                       ("collective", "b"), ("replay", 2)] * 2
        assert torch.equal(x, torch.ones(2))
        i = graphs.COUNTED.index(chamfer.nn_distance_cuda)
        assert graphs.launch_counts()[i] - before[i] == 6
        prog.close()
        with pytest.raises(RuntimeError, match="released"):
            prog.replay()
    finally:
        for fn, n in zip(graphs.COUNTED, before):
            fn.launches = n


def test_a_failed_tape_raises_and_stops_recording():
    log = []
    before = graphs.launch_counts()

    def broken():
        chamfer.nn_distance_cuda.launches += 1
        graphs.collective(lambda: log.append(("collective",)))
        raise RuntimeError("capture failed")

    new_graph = _graphs(log)
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.CapturedProgram(broken, new_graph(), (), new_graph)
    assert graphs._recording is None
    assert graphs.launch_counts() == before
    # The open graph was ended; the next collective runs at once.
    assert log[-1] == ("end", 1)
    graphs.collective(lambda: log.append(("after",)))
    assert log[-1] == ("after",)


def test_a_tape_inside_a_tape_is_refused():
    log = []
    new_graph = _graphs(log)

    def nested():
        graphs.CapturedProgram(lambda: None, new_graph(), (), new_graph)

    with pytest.raises(RuntimeError, match="already being recorded"):
        graphs.CapturedProgram(nested, new_graph(), (), new_graph)
    assert graphs._recording is None


def test_without_a_tape_the_collectives_stay_in_the_graph():
    """A program over NCCL: one graph, its collectives run inside the
    capture (captured with the rest), none at a replay."""
    log = []
    new_graph = _graphs(log)

    def step():
        graphs.collective(lambda: log.append(("collective",)))
        graphs.collective(lambda: log.append(("collective",)))

    prog = graphs.CapturedProgram(step, new_graph())
    assert (prog.graphs, prog.collectives) == (1, 0)
    assert log == [("begin", 0), ("collective",), ("collective",),
                   ("end", 0)]
    del log[:]
    prog.replay()
    assert log == [("replay", 0)]
