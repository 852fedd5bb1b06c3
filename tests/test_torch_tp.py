"""Tensor parallelism of the port (parallel/tp.py) on gloo CPU ranks,
against the one-device step and against the JAX package's TP step: the
twins of tests/test_parallel.py's test_tp_matches_single_device,
test_tp_higher_degrees_match_single_device and
test_tp_rejects_indivisible_degree, and of tests/test_master.py's
test_bf16_params_composes_with_model_parallel (at 2 data x 2 model ranks,
not 4 x 2), plus InferenceSession(model_parallel=...) against the session
alone, and which of its replicas capture their forwards (``plan_programs``,
with a stand-in program cache and ``torch.device`` values only).

Grids: 1 x 2, 2 x 2 and 1 x 4 (data x model) at N=64 (the upconv family
emits 2048 points from 128), B=16 (8 for model_fc_upconv). The ranks
replay the one-device step's ReLU masks, Chamfer argmins and head argmax
(a split layer's masks at the rank's columns), as the data-parallel tests
do. Tolerances:
- loss and metrics rtol 1e-4, BN statistics rtol 1e-4 and atol 2e-5
  (JAX's test_tp_matches_single_device), against the port's one-device
  step and, from JAX's init, against JAX's one-device and TP steps;
- gradients, gathered over the model group and averaged over the data
  group: within twice the f32 floor of the step itself (the one-device
  step with the batch's rows swapped in pairs), for the whole gradient's
  relative error norm and the worst leaf's largest gap over its largest
  entry, as the point-parallel tests hold theirs;
- the replicated leaves' gradients bit-equal on every rank of a model
  group; serving rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.parallel import mesh as jmesh
from pointnet_autoencoder_tpu.parallel import tp as jtp
from pointnet_autoencoder_tpu.train import schedules as jschedules
from pointnet_autoencoder_tpu.train.loop import make_step_fns as jstep_fns
from pointnet_autoencoder_tpu.train.state import TrainState as JTrainState
from pointnet_autoencoder_tpu.train.state import make_optimizer as jopt
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.inference import (
    InferenceSession,
    plan_programs,
)
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.parallel import mesh, tp

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 16
# (num_point, input points, batch) per model.
SIZES = {"model": (64, 64, 16), "model_emd": (64, 64, 16),
         "model_hierachy": (64, 64, 16),
         "model_fc_upconv": (2048, 128, 8)}
# (data, model) grid -> the models stepped on it.
GRIDS = {(1, 2): ["model", "model_emd", "model_hierachy",
                  "model_fc_upconv"],
         (2, 2): ["model", "model_emd"],
         (1, 4): ["model", "model_hierachy"]}


def _perturbed_state(name, num_point, seed=3):
    """The port's seeded init with BN parameters and statistics moved off
    their init values (a quarter of the gammas negative)."""
    model = get_model_spec(name).make(
        num_point, generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    sd = {}
    for key, v in model.state_dict().items():
        a = v.numpy()
        if key.endswith(".gamma"):
            a = a * np.where(rng.rand(*a.shape) < 0.25, -1, 1) \
                * (1 + 0.2 * rng.rand(*a.shape))
        elif key.endswith(".var"):
            a = a + 0.5 * rng.rand(*a.shape)
        elif a.ndim == 1:
            a = a + 0.1 * rng.randn(*a.shape)
        sd[key] = torch.from_numpy(np.asarray(a, np.float32))
    return sd


def _jax_case():
    """`model` from JAX's init at N=64, B=16: the port's state, the batch,
    the momentum, and after one step of JAX's one-device step and of its
    TP step on make_mesh(model_parallel=2) (4 x 2): the metrics and the
    BN statistics in the port's names."""
    spec = jspec("model")
    module, variables = spec.init_variables(jax.random.PRNGKey(0),
                                            NUM_POINT, BATCH)
    lr = jschedules.learning_rate_schedule(0.001, 0.7, BATCH, 200000)
    bn = jschedules.bn_momentum_schedule(BATCH, 200000)
    tx = jopt("adam", lr)
    batch = np.random.RandomState(9).randn(BATCH, NUM_POINT, 3).astype(
        np.float32)
    step, _ = jstep_fns(module, spec, tx, bn, lr)
    s1, m1 = jax.jit(step)(JTrainState.create(variables, tx),
                           jax.device_put(jnp.asarray(batch),
                                          jax.devices()[0]))
    grid = jmesh.make_mesh(model_parallel=2)
    tp_step, _ = jstep_fns(module, spec, tx, bn, lr,
                           pred_sharding=jmesh.batch_sharding(grid))
    s2, m2 = jax.jit(tp_step)(
        jtp.shard_state(grid, JTrainState.create(variables, tx)),
        jmesh.shard_batch(grid, jnp.asarray(batch)))

    def stats(state):
        tree = jax.device_get({"params": state.params,
                               "batch_stats": state.batch_stats})
        return {k: v for k, v in from_flax_variables(tree).items()
                if k.endswith((".mean", ".var"))}

    return dict(state=from_flax_variables(jax.device_get(variables)),
                batch=batch, momentum=float(bn(0)),
                one=({k: float(v) for k, v in m1.items()}, stats(s1)),
                tp=({k: float(v) for k, v in m2.items()}, stats(s2)))


def _run_grid(grid, tmp, cases):
    d, m = grid
    path = str(tmp / "cases.pt")
    torch.save(cases, path)
    out = tmp / "out"
    out.mkdir()
    mesh.launch(workers.tp_step_rank, devices=["cpu"] * (d * m),
                backend="gloo", init_method=f"file://{tmp / 'store'}",
                args=(path, str(out), m))
    return workers.load_ranks(str(out), d * m)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per grid: each model's one-device step (its choices recorded), the
    same step on the batch's rows swapped in pairs (the f32 floor), and
    every rank's TP step; on 1 x 2 and 2 x 2 also JAX's case."""
    singles, floors, base = {}, {}, {}
    for name, (num_point, n_in, b) in SIZES.items():
        case = dict(model=name, num_point=num_point,
                    state=_perturbed_state(name, num_point),
                    batch=np.random.RandomState(7).randn(
                        b, n_in, 3).astype(np.float32),
                    momentum=0.5, choices={})
        args = (name, num_point, case["state"], case["batch"],
                case["momentum"])
        singles[name] = workers.step(*args, case["choices"])
        pairs = np.arange(b).reshape(-1, 2)[:, ::-1].reshape(-1)
        floors[name] = workers.step(*args, dict(case["choices"]),
                                    rows=pairs, replay=True)
        base[name] = case
    jcase = _jax_case()
    jstate = dict(model="model", num_point=NUM_POINT, state=jcase["state"],
                  batch=jcase["batch"], momentum=jcase["momentum"],
                  choices={})
    out = {}
    for grid, names in GRIDS.items():
        cases = {n: base[n] for n in names}
        if grid[1] == 2:
            cases["model_jax"] = jstate
        out[grid] = _run_grid(grid, tmp_path_factory.mktemp(
            f"tp{grid[0]}x{grid[1]}"), cases)
    return dict(singles=singles, floors=floors, ranks=out, jax=jcase)


def _grad_gaps(got, want):
    """(relative error norm of the whole gradient, the largest gap of a
    leaf over its largest entry), leaves that are zero in exact arithmetic
    (a bias before a training BN) left out after checking that they read
    as rounding noise on both sides."""
    total = np.sqrt(sum(float(g.double().square().sum())
                        for g in want.values()))
    num = den = worst = 0.0
    for n, w in want.items():
        g = got[n]
        if float(w.double().norm()) < 1e-5 * total:
            assert float(g.double().norm()) < 1e-5 * total, n
            continue
        num += float((g - w).double().square().sum())
        den += float(w.double().square().sum())
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    return (num / den) ** 0.5, worst


def _close_stats(got, want):
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(w), rtol=1e-4,
                                   atol=2e-5, err_msg=n)


def _check_tp_step(runs, grid, name):
    """Loss and metrics, BN statistics and the gathered gradients of a TP
    step against the one-device step; the decoder's split leaves hold
    their slices, the rest whole; the replicated leaves' gradients are
    bit-equal across each model group."""
    d, m = grid
    single, floor = runs["singles"][name], runs["floors"][name]
    ranks = [r[name] for r in runs["ranks"][grid]]
    full = dict(get_model_spec(name).make(SIZES[name][0]).named_parameters())
    for r in ranks:
        assert sorted(r["scalars"]) == sorted(single["scalars"])
        for key, value in r["scalars"].items():
            np.testing.assert_allclose(value, single["scalars"][key],
                                       rtol=1e-4, err_msg=key)
        _close_stats(r["buffers"], single["buffers"])
        norm, worst = _grad_gaps(r["grads"], single["grads"])
        fl_norm, fl_worst = _grad_gaps(floor["grads"], single["grads"])
        assert norm <= 2 * fl_norm, (norm, fl_norm)
        assert worst <= 2 * fl_worst, (worst, fl_worst)
        for n, shape in r["shapes"].items():
            want = list(full[n].shape)
            dim = tp.spec_for_name(n)
            if dim is not None:
                want[dim] //= m
            assert shape == tuple(want), n
    assert ranks[0]["shapes"]["decoder.fc1.dense.weight"][0] == \
        full["decoder.fc1.dense.weight"].shape[0] // m
    assert "encoder.conv5.dense.weight" in ranks[0]["replicated"]
    for group in range(d):
        first = ranks[group * m]["replicated"]
        for r in ranks[group * m + 1:(group + 1) * m]:
            for n, g in r["replicated"].items():
                assert torch.equal(g, first[n]), n


@pytest.mark.parametrize("grid,name", [(g, n) for g in ((1, 2), (2, 2))
                                       for n in GRIDS[g]])
def test_tp_matches_single_device(runs, grid, name):
    """Degree 2, alone and beside 2 data shards (JAX: 4 x 2)."""
    _check_tp_step(runs, grid, name)


@pytest.mark.parametrize("name", GRIDS[(1, 4)])
def test_tp_higher_degrees_match_single_device(runs, name):
    """Degree 4, pure TP (JAX: 2 x 4 and 1 x 8), for the fc family and
    the hierarchy's fc1 (512 x 16384)."""
    _check_tp_step(runs, (1, 4), name)


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_tp_matches_the_jax_package(runs, grid):
    """From JAX's init on the same batch: the port's TP step's loss and
    pcloss against JAX's one-device step and its TP step on a 4 x 2 mesh
    (rtol 1e-4), and its BN statistics against both (rtol 1e-4, atol
    2e-5)."""
    for r in runs["ranks"][grid]:
        got = r["model_jax"]
        for metrics, stats in (runs["jax"]["one"], runs["jax"]["tp"]):
            for key in ("loss", "pcloss"):
                np.testing.assert_allclose(got["scalars"][key],
                                           metrics[key], rtol=1e-4,
                                           err_msg=key)
            _close_stats(got["buffers"], stats)


def test_tp_rejects_indivisible_degree():
    """model_parallel=3 does not divide 1024: the split, the session and
    the JAX package raise the same message before anything moves."""
    model = get_model_spec("model").make(NUM_POINT)
    with pytest.raises(ValueError, match="model_parallel=3 does not divide"):
        tp.shard_dims(model, 3)
    grid = jmesh.make_mesh(data_parallel=2, model_parallel=3)
    spec = jspec("model")
    _, variables = spec.init_variables(jax.random.PRNGKey(0), NUM_POINT, 8)
    tx = jopt("adam", jschedules.learning_rate_schedule(0.001, 0.7, 8,
                                                        200000))
    with pytest.raises(ValueError, match="model_parallel=3 does not divide"):
        jtp.shard_state(grid, JTrainState.create(variables, tx))
    with pytest.raises(ValueError, match="model_parallel=3 does not divide"):
        tp.parallelize_in_process_(model.decoder, ["cpu"] * 3)


@pytest.mark.parametrize("name,num_point", [
    ("model", 64), ("model_hierachy", 128), ("model_fc_upconv", 2048),
    ("model_upconv", 2048)])
def test_inference_session_model_parallel(tmp_path, name, num_point):
    """InferenceSession(model_parallel=2), and 2 replicas x 2, against the
    session alone: reconstruct (a ragged batch of 5), embed and decode
    within rtol 1e-5, atol 1e-6."""
    weights = str(tmp_path / "w.pt")
    torch.save(_perturbed_state(name, num_point), weights)
    one = InferenceSession(name, weights, num_point, batch_size=4,
                           device="cpu")
    x = np.random.RandomState(5).randn(5, num_point, 3).astype(np.float32)
    emb = one.embed(x)
    for kw in (dict(model_parallel=2, device="cpu"),
               dict(model_parallel=2, data_parallel=2,
                    devices=["cpu"] * 4)):
        split = InferenceSession(name, weights, num_point, batch_size=4,
                                 **kw)
        assert len(split.devices) == kw.get("data_parallel", 1)
        np.testing.assert_allclose(split.reconstruct(x), one.reconstruct(x),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(split.embed(x), emb, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(split.decode(emb), one.decode(emb),
                                   rtol=1e-5, atol=1e-6)
        for a, b in zip(split.model.state_dict().values(),
                        one.model.state_dict().values()):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 60, NUM_POINT, categories=["Chair"])


def test_bf16_params_composes_with_model_parallel(fixture_root, tmp_path):
    """--bf16_params on 2 data x 2 model ranks: the bf16 fc1 weight and its
    f32 slot are this rank's column slice, one epoch trains to a finite
    loss, and the replicated leaves stay bit-equal across each model
    group (the same rounding noise on every rank of it)."""
    cfg = TrainConfig(model="model", category="Chair", num_point=NUM_POINT,
                      batch_size=8, data_path=fixture_root, seed=0,
                      log_dir=str(tmp_path / "log"), max_epoch=1,
                      log_every=10, bf16=False, bf16_params=True,
                      data_parallel=2, model_parallel=2)
    out = tmp_path / "ranks"
    out.mkdir()
    mesh.launch(workers.tp_trainer_rank, devices=["cpu"] * 4,
                backend="gloo", init_method=f"file://{tmp_path / 'store'}",
                args=(cfg.to_json(), str(out)))
    ranks = workers.load_ranks(str(out), 4)
    for r in ranks:
        assert r["before"]["fc1"] == (torch.bfloat16, (512, 1024))
        assert r["before"]["slot"] == (torch.float32, (512, 1024))
        assert np.isfinite(r["best"])
    replicated = tp.replicated_names(get_model_spec("model").make(NUM_POINT))
    for a, b in ((0, 1), (2, 3)):
        for n in replicated:
            assert torch.equal(ranks[a]["state"][n], ranks[b]["state"][n]), n
    # The data group's ranks hold the same slices.
    for n, t in ranks[0]["state"].items():
        assert torch.equal(t, ranks[2]["state"][n]), n


def test_a_split_replica_is_captured_only_on_one_card():
    """A replica whose m devices are one card gets a program cache; one
    over two cards runs eager and says why; the CPU and compiled=False run
    eager."""
    made = []

    def cache(device):
        made.append(device)
        return ("cache", device)

    c0, c1 = torch.device("cuda:0"), torch.device("cuda:1")
    plans = plan_programs([c0, c0, c0, c1], 2, True, cache)
    assert plans[0] == (("cache", c0), "captured CUDA graphs on cuda:0")
    assert plans[1] == (None, "eager (a replica over cuda:0, cuda:1: one "
                              "card cannot check a capture across cards)")
    assert made == [c0]
    assert [c for c, _ in plan_programs([c1, c1, c1, c1], 4, True,
                                        cache)] == [("cache", c1)]
    assert [c for c, _ in plan_programs([c0, c1], 1, True, cache)] == [
        ("cache", c0), ("cache", c1)]
    assert plan_programs([c0, c0], 2, False, cache) == [
        (None, "eager (compiled=False: the eager reference)")]
    cpu = torch.device("cpu")
    assert plan_programs([cpu, cpu], 2, True, cache) == [
        (None, "eager (the CPU runs eager)")]
    assert len(made) == 4
