"""The pieces of the port's captured steps that run on the CPU, against
the JAX package:

- the schedules' tensor form (a device step counter in, an f32 scalar
  out, as the JAX package computes them inside its jit) bit-equal to the
  JAX package's f32 schedules at every staircase boundary and one step
  either side, and to the host's ``f32`` form;
- two train steps across a staircase (batch 4, decay_step 4: the
  learning rate and the BN momentum change at every step) with the
  optimizer's tensor learning rate and the BN's tensor momentum, against
  the JAX package's two steps, at ``test_one_train_step_matches_jax``'s
  tolerances (loss and pcloss rtol 1e-4, BN statistics rtol 1e-4 atol
  1e-5; the learning rate and momentum each step applied equal in f32);
- BatchNorm's moving statistics with a tensor momentum against JAX's at
  rtol 1e-6, and bit-equal to the same momentum given as a float;
- a checkpoint of another version or device resuming with the
  optimizer's flags this device needs;
- the launch-counter accounting of a captured program, under a stand-in
  graph that records a capture and counts replays;
- bf16 master weights (``MasterOptimizer`` in the card's form: the
  learning rate a tensor, the step count on the device): two steps across
  the staircase against the JAX package's ``--bf16_params`` step, both
  with zero rounding noise, at the same tolerances; and a chunk program of
  3 steps under a stand-in cache, which registers the noise generator and
  sets its offset to its first step's draw before each replay;
- the epoch metric buffer: the same log windows as the per-step metric
  dicts the loop kept before it (the earlier ``fetch_metric_windows``,
  copied here as the oracle).
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.nn.layers import PointMLP as JPointMLP
from pointnet_autoencoder_tpu.train import master as jmaster
from pointnet_autoencoder_tpu.train import schedules as jschedules
from pointnet_autoencoder_tpu.train.loop import make_step_fns
from pointnet_autoencoder_tpu.train.state import TrainState as JTrainState
from pointnet_autoencoder_tpu.train.state import make_optimizer as jopt
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.inference import chunked_dispatch
from pointnet_autoencoder_tpu_torch.nn.layers import PointMLP
from pointnet_autoencoder_tpu_torch.ops import chamfer, fused_head
from pointnet_autoencoder_tpu_torch.train import master, schedules
from pointnet_autoencoder_tpu_torch.train.loop import (
    EpochMetrics,
    Trainer,
    window_means,
)
from pointnet_autoencoder_tpu_torch.train.state import (
    StepPrograms,
    TraceSGD,
    TrainState,
    make_optimizer,
)
from pointnet_autoencoder_tpu_torch.utils import graphs
from test_torch_master import _truncate, inc, stand_in_noise

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 4

# (base_lr, decay_rate, batch_size, decay_step, floor): the reference's
# defaults at B=32, the repo's CPU test settings, a floor that binds, and
# a schedule that steps every batch.
SCHEDULES = [(0.001, 0.7, 32, 200000, None), (0.001, 0.7, 8, 20, None),
             (0.001, 0.7, 8, 20, 6e-4), (0.01, 0.5, 8, 16, None),
             (0.002, 0.9, 16, 100, None), (0.001, 0.7, 4, 4, None)]


@pytest.mark.parametrize("base,rate,batch,decay,floor", SCHEDULES)
def test_tensor_schedules_bit_equal_jax_at_the_boundaries(base, rate, batch,
                                                          decay, floor):
    """Exponents 0..40: the first step of each, and one step either
    side."""
    steps = sorted({max(s + d, 0) for k in range(41)
                    for s in [-(-k * decay // batch)] for d in (-1, 0, 1)})
    jsteps = jnp.asarray(steps, jnp.int32)
    tsteps = torch.tensor(steps, dtype=torch.int64)
    for ours, theirs in (
            (schedules.learning_rate_schedule(base, rate, batch, decay,
                                              floor=floor),
             jschedules.learning_rate_schedule(base, rate, batch, decay,
                                               floor=floor)),
            (schedules.bn_momentum_schedule(batch, decay),
             jschedules.bn_momentum_schedule(batch, decay))):
        want = np.asarray(jax.vmap(theirs)(jsteps))
        got = ours.tensor(tsteps)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            np.array([ours.f32(s) for s in steps], np.float32), want)


def test_train_state_reads_the_schedules_from_its_device_step():
    model = torch.nn.Linear(3, 2)
    lr = schedules.learning_rate_schedule(0.01, 0.5, 8, 16)
    bn = schedules.bn_momentum_schedule(8, 16)
    st = TrainState(model, make_optimizer("adam", model.parameters()), lr)
    st.step = 5
    assert int(st.step_tensor) == 5
    assert float(bn.tensor(st.step_tensor)) == bn.f32(5)
    assert float(st.set_lr()) == lr.f32(5)
    assert float(st.optimizer.param_groups[0]["lr"]) == lr.f32(5)
    st.count_steps(3)  # replays advanced the device's count itself
    assert st.step == 8 and int(st.step_tensor) == 5


def test_load_state_dict_keeps_the_lr_tensor_and_bumps_the_generation():
    model = torch.nn.Linear(3, 2)
    st = TrainState(model, make_optimizer("adam", model.parameters()),
                    schedules.learning_rate_schedule(0.01, 0.5, 8, 16))
    lr_tensor = st.optimizer.param_groups[0]["lr"]
    model(torch.ones(1, 3)).sum().backward()
    st.set_lr()
    st.optimizer.step()
    st.step = 1
    saved = st.state_dict()
    other = TrainState(torch.nn.Linear(3, 2),
                       make_optimizer("adam", model.parameters()),
                       st.lr_schedule)
    mine = other.optimizer.param_groups[0]["lr"]
    other.load_state_dict(saved)
    assert other.generation == 1 and other.step == 1
    assert other.optimizer.param_groups[0]["lr"] is mine
    assert float(mine) == float(lr_tensor)


@pytest.mark.parametrize("capturable,float_lr", [(False, True),
                                                  (True, False)])
def test_a_checkpoint_of_another_version_or_device_resumes(capturable,
                                                           float_lr):
    """An Adam checkpoint from before the learning rate was a tensor (a
    float, capturable False) and one a card wrote (capturable True):
    ``load_state_dict`` gives the groups back the flag ``make_optimizer``
    gave them (False on the CPU), with the step counts on the host, and
    the next step equals the original state's."""
    def state(seed):
        torch.manual_seed(seed)
        model = torch.nn.Linear(3, 2)
        return TrainState(model, make_optimizer("adam", model.parameters()),
                          schedules.learning_rate_schedule(0.01, 0.5, 8, 16))

    def step(st):
        st.set_lr()
        st.optimizer.zero_grad()
        st.model(torch.ones(4, 3)).square().sum().backward()
        st.optimizer.step()
        st.step += 1

    original = state(0)
    step(original)
    saved = copy.deepcopy(original.state_dict())
    for group in saved["optimizer"]["param_groups"]:
        group["capturable"] = capturable
        group["lr"] = float(group["lr"]) if float_lr else group["lr"]
    resumed = state(1)
    mine = resumed.optimizer.param_groups[0]["lr"]
    resumed.load_state_dict(saved)
    group = resumed.optimizer.param_groups[0]
    assert group["capturable"] is False and group["lr"] is mine
    assert all(resumed.optimizer.state[p]["step"].device.type == "cpu"
               for p in resumed.model.parameters())
    step(original)
    step(resumed)
    for a, b in zip(original.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)


def test_trace_sgd_takes_a_tensor_lr_in_optax_trace_form():
    rng = np.random.RandomState(4)
    p0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) for _ in range(3)]
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = TraceSGD([p], lr=torch.tensor(0.1), momentum=0.9)
    buf = np.zeros(6, np.float32)
    want = p0.copy()
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        buf = g + np.float32(0.9) * buf
        want = want + np.float32(-0.1) * buf
    np.testing.assert_array_equal(p.detach().numpy(), want)
    assert set(opt.state[p]) == {"momentum_buffer"}


# -- two train steps across a staircase --------------------------------------


def _perturbed(variables, seed=0):
    """Variables as numpy with BN parameters and statistics moved off
    their init values (a quarter of the gammas negative), as
    test_torch_train.py moves them."""
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "gamma":
            return (a * np.where(rng.rand(*a.shape) < 0.25, -1, 1)
                    * (1 + 0.2 * rng.rand(*a.shape))).astype(np.float32)
        if name == "var":
            return (a + 0.5 * rng.rand(*a.shape)).astype(np.float32)
        if a.ndim == 1:
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


def _sync(trainer, state, optimizer):
    """The port's weights, BN statistics and optimizer slots (and Adam's
    count) set to the JAX state's."""
    trainer.model.load_state_dict(from_flax_variables(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats})))
    first = state.opt_state[0]
    slots = ({"exp_avg": first.mu, "exp_avg_sq": first.nu}
             if optimizer == "adam" else {"momentum_buffer": first.trace})
    opt = trainer.state.optimizer
    if isinstance(opt, master.MasterOptimizer):
        sd = opt.state_dict()
        for slot, tree in slots.items():
            arrays = from_flax_variables({"params": jax.device_get(tree)})
            for name, stored in sd["slots"].items():
                stored[slot] = arrays[name]
        opt.load_state_dict(dict(sd, steps=int(state.step)))
        return
    params = dict(trainer.model.named_parameters())
    for slot, tree in slots.items():
        arrays = from_flax_variables({"params": jax.device_get(tree)})
        for name, p in params.items():
            opt.state[p][slot].copy_(arrays[name])
            if optimizer == "adam":
                opt.state[p]["step"].fill_(int(first.count))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 12, NUM_POINT, categories=["Chair"])


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_two_train_steps_across_a_staircase_match_jax(tmp_path, fixture_root,
                                                      optimizer):
    """Step 0, then step 1 from the JAX state after step 0 (weights,
    statistics and slots copied over: Adam turns gradients that are
    rounding noise into full-size updates, so two steps apart would
    compare that noise), each against the JAX package's step."""
    _two_steps_against_jax(tmp_path, fixture_root, optimizer)


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_two_master_steps_across_a_staircase_match_jax(
        tmp_path, fixture_root, optimizer, monkeypatch):
    """The same two steps with bf16 matmul weights (``--bf16_params``):
    ``MasterOptimizer`` in the card's form, its learning rate a tensor
    and its step count on the device, against the JAX package's step with
    ``f32_math`` and ``apply_updates_sr``, the rounding noise zero on both
    sides (truncation). After each step the matmul weight matrices equal
    JAX's bit for bit in all but 0.5% of their entries, and no entry is
    further from JAX's than one bf16 ulp plus 3 learning rates (a
    gradient near zero may take the other sign, which Adam scales to a
    full update; the biases ahead of BN, whose gradients are all such
    rounding noise, are not compared)."""
    monkeypatch.setattr(jmaster, "stochastic_round_bf16",
                        lambda x, key: _truncate(x))
    monkeypatch.setattr(master, "draw_noise", lambda shape, generator:
                        torch.zeros(tuple(shape), dtype=torch.int32))
    _two_steps_against_jax(tmp_path, fixture_root, optimizer,
                           bf16_params=True)


def _two_steps_against_jax(tmp_path, fixture_root, optimizer,
                           bf16_params=False):
    spec = jspec("model")
    module, variables = spec.init_variables(jax.random.PRNGKey(0), NUM_POINT)
    variables = _perturbed(variables)
    lr = jschedules.learning_rate_schedule(0.001, 0.7, BATCH, BATCH)
    tx = jopt(optimizer, lr, 0.9)
    if bf16_params:
        variables = dict(variables,
                         params=jmaster.cast_master_bf16(variables["params"]))
        tx = jmaster.f32_math(tx)
    rng = np.random.RandomState(3)
    batches = [rng.randn(BATCH, NUM_POINT, 3).astype(np.float32)
               for _ in range(2)]
    bn = jschedules.bn_momentum_schedule(BATCH, BATCH)
    train_step = jax.jit(make_step_fns(module, spec, tx, bn, lr,
                                       stochastic_round=bf16_params)[0])
    states = [JTrainState.create(variables, tx)]
    want = []
    for x in batches:
        state, m = train_step(states[-1], x)
        states.append(state)
        want.append(m)

    cfg = TrainConfig(data_path=fixture_root, category="Chair",
                      num_point=NUM_POINT, batch_size=BATCH, bf16=False,
                      decay_step=BATCH, optimizer=optimizer,
                      bf16_params=bf16_params, log_dir=str(tmp_path / "log"))
    trainer = Trainer(cfg, device="cpu")
    if bf16_params:
        # The card's form of the step, on the CPU.
        trainer.state.optimizer.capturable = True
    got = []
    try:
        trainer.model.load_state_dict(from_flax_variables(variables))
        for i, x in enumerate(batches):
            if i:
                _sync(trainer, states[i], optimizer)
            got.append(trainer.train_step(torch.from_numpy(x)))
            if bf16_params:
                want_w = from_flax_variables(jax.device_get(
                    {"params": states[i + 1].params,
                     "batch_stats": states[i + 1].batch_stats}),
                    keep_bf16=True)
                lr_i = float(got[-1]["learning_rate"])
                differ = total = 0
                for name, p in trainer.model.named_parameters():
                    if name.endswith("dense.weight"):
                        w = want_w[name]
                        assert p.dtype == w.dtype == torch.bfloat16
                        gap = (p.float() - w.float()).abs()
                        assert bool((gap <= w.float().abs() * 2.0 ** -7
                                     + 3 * lr_i).all()), (i, name)
                        differ += int((p != w).sum())
                        total += p.numel()
                assert differ <= 0.005 * total, (i, differ, total)
    finally:
        trainer.close()
    assert trainer.state.step == 2 and int(trainer.state.step_tensor) == 2
    if bf16_params:
        assert trainer.state.optimizer.steps == 2
    for g, w in zip(got, want):
        for key in ("loss", "pcloss"):
            np.testing.assert_allclose(float(g[key]), float(w[key]),
                                       rtol=1e-4, err_msg=key)
        for key in ("learning_rate", "bn_decay"):
            assert g[key].dtype == torch.float32
            assert g[key].numpy() == np.asarray(w[key]), key
    assert float(got[0]["learning_rate"]) != float(got[1]["learning_rate"])
    assert float(got[0]["bn_decay"]) != float(got[1]["bn_decay"])
    want_sd = from_flax_variables(jax.device_get(
        {"params": states[-1].params, "batch_stats": states[-1].batch_stats}))
    for name, buf in trainer.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("step", [0, 4, 8, 24])
def test_bn_update_with_a_tensor_momentum_matches_jax(step):
    """The staircase's momentum at ``step`` (0.5, 0.75, 0.875, 0.99)."""
    momentum = schedules.bn_momentum_schedule(8, 32).tensor(
        torch.tensor(step))
    x = np.random.RandomState(1).randn(3, 40, 8).astype(np.float32) * 2 + 1
    jmod = JPointMLP(16)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), x,
                                         train=False))
    _, mutated = jmod.apply(variables, x, train=True,
                            bn_momentum=jnp.asarray(momentum.numpy()),
                            mutable=["batch_stats"])
    mods = []
    for m in (momentum, float(momentum)):
        mod = PointMLP(8, 16, bn=True)
        mod.load_state_dict(from_flax_variables(variables))
        mod(torch.from_numpy(x), train=True, bn_momentum=m)
        mods.append(mod)
    for name in ("mean", "var"):
        got = getattr(mods[0].bn, name)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(mutated["batch_stats"]["bn"][name]),
            rtol=1e-6, atol=1e-7, err_msg=name)
        assert torch.equal(got, getattr(mods[1].bn, name)), name


# -- launch counters under a stand-in replay ---------------------------------


class StandInGraph:
    """Records a capture by running the function once; a replay runs
    nothing (a real graph replays on the card without Python)."""

    def __init__(self):
        self.replays = 0

    def capture(self):
        return contextlib.nullcontext()

    def replay(self):
        self.replays += 1

    def reset(self):
        pass


def test_counters_count_replays_not_the_capture():
    counted = (chamfer.nn_distance_cuda, chamfer.nn_distance_grad_cuda,
               fused_head.head_max_cuda)
    before = graphs.launch_counts()

    def captured_work():
        # What the wrappers add when their Python code runs at capture.
        chamfer.nn_distance_cuda.launches += 2
        chamfer.nn_distance_grad_cuda.launches += 1
        fused_head.head_max_cuda.launches += 3
        return "outputs"

    graph = StandInGraph()
    prog = graphs.CapturedProgram(captured_work, graph)
    try:
        assert graphs.launch_counts() == before
        assert prog.outputs == "outputs"
        for _ in range(3):
            assert prog.replay() == "outputs"
        assert graph.replays == 3
        deltas = [a - b for a, b in zip(graphs.launch_counts(), before)]
        assert [deltas[graphs.COUNTED.index(f)] for f in counted] == [6, 3, 9]
        assert sum(deltas) == 18
        prog.close()
        with pytest.raises(RuntimeError):
            prog.replay()
    finally:
        for fn, n in zip(graphs.COUNTED, before):
            fn.launches = n


def test_a_replay_copies_its_inputs_into_the_static_ones():
    static = (torch.zeros(3), torch.zeros(2))
    prog = graphs.CapturedProgram(lambda x, y: (x, y), StandInGraph(),
                                  static)
    assert prog.outputs[0] is static[0]
    prog.replay(torch.ones(3), torch.full((2,), 2.0))
    assert torch.equal(static[0], torch.ones(3))
    assert torch.equal(static[1], torch.full((2,), 2.0))


def test_a_failed_capture_raises_and_restores_the_counters():
    before = graphs.launch_counts()

    def broken():
        chamfer.nn_distance_cuda.launches += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.CapturedProgram(broken, StandInGraph())
    assert graphs.launch_counts() == before


class StandInCache:
    """``ProgramCache``'s calls on the CPU: the warm-up runs the function;
    a program is captured on a ``StandInGraph`` whose capture sets
    ``capturing[0]``, and the generators each program registers are
    kept by key."""

    def __init__(self, capturing):
        self.capturing = capturing
        self.programs, self.registered = {}, {}

    def warm_up(self, fn):
        return fn()

    def program(self, key, fn, inputs=(), generators=()):
        if key not in self.programs:
            self.registered[key] = tuple(generators)
            graph = StandInGraph()
            graph.capture = self.capture
            self.programs[key] = graphs.CapturedProgram(
                fn, graph, tuple(t.clone() for t in inputs))
        return self.programs[key]

    @contextlib.contextmanager
    def capture(self):
        self.capturing[0] = True
        try:
            yield
        finally:
            self.capturing[0] = False

    def clear(self):
        self.programs.clear()

    close = clear


def test_a_master_chunk_program_registers_and_seeks_the_noise_generator(
        tmp_path, fixture_root, monkeypatch):
    """``--bf16_params --bf16_moments`` at log_every 3: the first chunk
    (steps 0-2) is the eager warm-up, its draws at s * inc after the draw
    that reads inc; the program of the next chunks registers the device
    pipeline's generator and the noise generator, its capture sets no
    offset (its draws run on from where the capture finds the generator),
    and each replay starts at its first step's draw: 3 * inc, then 6 *
    inc."""
    cfg = TrainConfig(data_path=fixture_root, category="Chair",
                      num_point=NUM_POINT, batch_size=BATCH, bf16=False,
                      bf16_params=True, bf16_moments=True, log_every=3,
                      log_dir=str(tmp_path / "log"))
    trainer = Trainer(cfg, device="cpu")
    try:
        gen = stand_in_noise(monkeypatch, trainer.state.optimizer)
        capturing = [False]
        monkeypatch.setattr(master, "_capturing", lambda: capturing[0])
        cache = StandInCache(capturing)
        trainer._steps = StepPrograms(trainer.state, cache,
                                      trainer.state.optimizer)
        metrics = EpochMetrics(9, "cpu")
        for _ in range(3):
            trainer._chunk("train", torch.zeros((3, BATCH), dtype=torch.long),
                           metrics)
        assert trainer.state.step == 9 and metrics.count == 9
        assert cache.registered == {
            ("train", 3): (trainer.train_pipe.generator, gen)}
        # The weights' noise and the two bf16 moment slots'.
        i = inc(3 * sum(p.numel()
                        for n, p in trainer.model.named_parameters()
                        if master.is_matmul_param(n)))
        assert gen.sets == [0, 0, i, 2 * i, 3 * i, 6 * i]
        assert gen.draws == [0, 0, i, 2 * i, 3 * i, 4 * i, 5 * i]
    finally:
        trainer.close()


def test_program_cache_refuses_the_cpu():
    with pytest.raises(ValueError):
        graphs.ProgramCache(torch.device("cpu"))


# -- the epoch metric buffer ---------------------------------------------------


def fetch_metric_windows(pending, windows):
    """The loop's metric fetch before the epoch buffer: the f32 mean of
    each metric over each window of a list of per-step dicts (tensors or
    floats), the tensors in one stacked copy."""
    keys = sorted(pending[0])
    tensor_keys = [k for k in keys if torch.is_tensor(pending[0][k])]
    host = np.array([[float(m[k]) for k in keys if k not in tensor_keys]
                     for m in pending], np.float32).reshape(len(pending), -1)
    if tensor_keys:
        dev = torch.stack([torch.stack([m[k].float() for k in tensor_keys])
                           for m in pending]).cpu().numpy()
        host = np.concatenate([host, dev], axis=1)
    names = [k for k in keys if k not in tensor_keys] + tensor_keys
    return [dict(zip(names, map(float, host[a:b].mean(axis=0))))
            for a, b in windows]


@pytest.mark.parametrize("steps,every", [(10, 10), (23, 4), (7, 3), (1, 1)])
def test_epoch_buffer_gives_the_earlier_log_windows(steps, every):
    rng = np.random.RandomState(steps)
    pending = [{k: torch.tensor(rng.rand(), dtype=torch.float32) * scale
                for k, scale in (("loss", 300.0), ("pcloss", 3.0),
                                 ("learning_rate", 1e-3),
                                 ("bn_decay", 1.0))} for _ in range(steps)]
    full = steps // every * every
    windows = [(a, a + every) for a in range(0, full, every)]
    metrics = EpochMetrics(steps, "cpu")
    # Row by row (eager steps) and a chunk at once (a replayed program).
    metrics.put(pending[0])
    if steps > 1:
        keys, _ = EpochMetrics.row(pending[0])
        metrics.put_rows(keys, torch.stack(
            [EpochMetrics.row(m)[1] for m in pending[1:]]))
    assert metrics.count == steps and metrics.keys == sorted(pending[0])
    got = window_means(metrics.rows.numpy(), metrics.keys, windows)
    assert got == fetch_metric_windows(pending, windows)
    assert window_means(metrics.rows.numpy(), metrics.keys, [(0, steps)]) \
        == fetch_metric_windows(pending, [(0, steps)])


def test_chunked_dispatch_cuts_a_tuple_of_arrays_alike():
    a = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
    b = -np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    seen = []

    def run(x, y, i):
        seen.append((x.shape[0], y.shape[0]))
        return x.sum(dim=1) + y.sum(dim=1)

    out = chunked_dispatch(run, (a, b), 4, [torch.device("cpu")] * 2)
    np.testing.assert_array_equal(out, a.sum(1) + b.sum(1))
    assert seen == [(2, 2)] * 6


def test_the_cpu_trainer_says_it_runs_eager(tmp_path, fixture_root):
    cfg = TrainConfig(data_path=fixture_root, category="Chair",
                      num_point=NUM_POINT, batch_size=BATCH, bf16=False,
                      log_dir=str(tmp_path / "log"))
    trainer = Trainer(cfg, device="cpu")
    trainer.close()
    with open(tmp_path / "log" / "log_train.txt") as f:
        first = f.readline()
    assert first.startswith("step path: eager (the CPU")
