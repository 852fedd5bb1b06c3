"""One point-parallel f32 train step of the port (parallel/sp.py through
the model's point group, the SP losses and the gradient sum, as
train/loop.py runs it) on k gloo CPU ranks, against the one-device step:
all six --model families at k = 2, `model` at k = 4, and `model` and
`model_emd` from JAX's init against the JAX package's make_sp_step_fns.

Each rank holds N/k points of every shape of the global batch (B=8,
N=128). The ranks replay the one-device step's ReLU masks and Chamfer
argmins at their points (a near-tie falls either way under another
summation order of the BN statistics, and the upconv decoders emit
near-duplicate points at init); the head's argmax is their own.

Tolerances:
- loss and metrics (the ranks' shares summed) rtol 1e-5, against the
  one-device step and, for `model` and `model_emd`, JAX's point-sharded
  step and its one-device step (tests/test_parallel.py:493-560);
- BN statistics rtol 1e-4, atol 2e-5 (JAX's bound), each entry raised to
  twice the f32 floor below where that is higher;
- gradients: within twice the f32 floor of the step itself, for the
  whole gradient's relative error norm and the worst leaf's largest gap
  over its largest entry. The floor is the one-device step on the same
  batch with every shape's points rolled by N/2 (the choices rolled with
  them), which changes only the order of the sums over points, as the
  ranks do. It moves a leaf by up to 3e-4 of its largest entry, past an
  elementwise rtol 1e-4, atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.parallel import mesh as jmesh
from pointnet_autoencoder_tpu.parallel import sp as jsp
from pointnet_autoencoder_tpu.train import schedules as jschedules
from pointnet_autoencoder_tpu.train.loop import make_step_fns as jstep_fns
from pointnet_autoencoder_tpu.train.state import TrainState as JTrainState
from pointnet_autoencoder_tpu.train.state import make_optimizer as jopt
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.parallel import mesh

torch.set_num_threads(2)

STEP_BATCH = 8
# model -> (num_point, input points per cloud); the upconv decoders emit
# 2048 points from any input.
STEP_SIZES = {"model": (128, 128), "model_cpu": (128, 128),
              "model_emd": (128, 128), "model_hierachy": (128, 128),
              "model_upconv": (2048, 128), "model_fc_upconv": (2048, 128)}
STEP_MODELS = {2: sorted(STEP_SIZES), 4: ["model"]}


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


def _jax_cases(num_point=128):
    """`model` and `model_emd` from JAX's init: the port's state, the
    batch, the momentum, and the metrics of JAX's make_sp_step_fns on
    make_mesh(data_parallel=2) and of its one-device step."""
    out = {}
    for name in ("model", "model_emd"):
        spec = jspec(name)
        module, variables = spec.init_variables(jax.random.PRNGKey(0),
                                                num_point, STEP_BATCH)
        lr = jschedules.learning_rate_schedule(0.001, 0.7, STEP_BATCH,
                                               200000)
        bn = jschedules.bn_momentum_schedule(STEP_BATCH, 200000)
        tx = jopt("adam", lr)
        batch = np.random.RandomState(12).randn(
            STEP_BATCH, num_point, 3).astype(np.float32)
        m2 = jmesh.make_mesh(data_parallel=2)
        step, _ = jsp.make_sp_step_fns(module, spec, tx, bn, lr, m2)
        _, metrics = jax.jit(step)(
            jmesh.replicate(m2, JTrainState.create(variables, tx)),
            jax.device_put(jnp.asarray(batch), jsp.point_batch_sharding(m2)))
        plain, _ = jstep_fns(module, spec, tx, bn, lr)
        _, one = jax.jit(plain)(JTrainState.create(variables, tx),
                                jax.device_put(jnp.asarray(batch),
                                               jax.devices()[0]))
        out[name] = dict(
            state=from_flax_variables(jax.device_get(variables)),
            batch=batch, momentum=float(bn(0)),
            metrics={k: float(v) for k, v in metrics.items()},
            one={k: float(v) for k, v in one.items()})
    return out


def _runs(k, tmp):
    """For k ranks: per model, (the one-device step, its floor, every
    rank's step); at k = 2 also JAX's cases with the ranks' steps."""
    cases, singles, floors = {}, {}, {}
    for name in STEP_MODELS[k]:
        num_point, n_in = STEP_SIZES[name]
        case = dict(model=name, num_point=num_point,
                    state=_perturbed_state(name, num_point),
                    batch=np.random.RandomState(7).randn(
                        STEP_BATCH, n_in, 3).astype(np.float32),
                    momentum=0.5, choices={})
        args = (name, num_point, case["state"], case["batch"],
                case["momentum"])
        singles[name] = workers.step(*args, case["choices"])
        rolled = torch.roll(torch.arange(n_in), n_in // 2)
        floors[name] = workers.sp_step(*args, choices=case["choices"],
                                       points=rolled)
        cases[name] = case
    jcases = _jax_cases() if k == 2 else {}
    for name, case in jcases.items():
        cases[f"{name}_jax"] = dict(model=name, num_point=128,
                                    state=case["state"], batch=case["batch"],
                                    momentum=case["momentum"])
    path = str(tmp / "cases.pt")
    torch.save(cases, path)
    out = tmp / "out"
    out.mkdir()
    mesh.launch(workers.sp_step_rank, devices=["cpu"] * k, backend="gloo",
                init_method=f"file://{tmp / 'store'}", args=(path, str(out)))
    ranks = workers.load_ranks(str(out), k)
    return dict(singles=singles, floors=floors, ranks=ranks, jax=jcases)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    return {k: _runs(k, tmp_path_factory.mktemp(f"sp_step{k}"))
            for k in STEP_MODELS}


def _grad_gaps(got, want):
    """(relative error norm of the whole gradient, the largest gap of a
    leaf over its largest entry) of ``got`` against ``want``, leaves that
    are zero in exact arithmetic (a bias before a training BN) left out
    after checking that they read as rounding noise on both sides."""
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


@pytest.mark.parametrize("k,name", [(k, n) for k in STEP_MODELS
                                    for n in STEP_MODELS[k]])
def test_sp_step_matches_the_one_device_step(step_runs, k, name):
    """Loss and metrics (the ranks' shares summed), every gradient after
    the sum over the ranks and the new BN statistics of a k-rank step,
    each rank holding N/k points of every shape, against the one-device
    step on the whole batch."""
    runs = step_runs[k]
    single, floor = runs["singles"][name], runs["floors"][name]
    ranks = [r[name] for r in runs["ranks"]]
    for r in ranks:
        assert sorted(r["scalars"]) == sorted(single["scalars"])
        for key, value in r["scalars"].items():
            np.testing.assert_allclose(value, single["scalars"][key],
                                       rtol=1e-5, err_msg=key)
        # Every rank holds the same gradients and statistics.
        for key in ("grads", "buffers"):
            for n, t in r[key].items():
                assert torch.equal(t, ranks[0][key][n]), (key, n)
    sp_norm, sp_worst = _grad_gaps(ranks[0]["grads"], single["grads"])
    fl_norm, fl_worst = _grad_gaps(floor["grads"], single["grads"])
    assert sp_norm <= 2 * fl_norm, (sp_norm, fl_norm)
    assert sp_worst <= 2 * fl_worst, (sp_worst, fl_worst)
    for n, want in single["buffers"].items():
        want = want.numpy()
        err = np.abs(ranks[0]["buffers"][n].numpy() - want)
        reorder = np.abs(floor["buffers"][n].numpy() - want).max()
        bound = np.maximum(2e-5 + 1e-4 * np.abs(want), 2 * reorder)
        assert (err <= bound).all(), (n, float(err.max()))


@pytest.mark.parametrize("name", ["model", "model_emd"])
def test_sp_step_matches_jax_make_sp_step_fns(step_runs, name):
    """From JAX's init on the same batch: the port's 2-rank step's loss
    and pcloss against JAX's point-sharded step on
    make_mesh(data_parallel=2) and its one-device step, rtol 1e-5."""
    want = step_runs[2]["jax"][name]
    for r in step_runs[2]["ranks"]:
        got = r[f"{name}_jax"]["scalars"]
        for ref in (want["metrics"], want["one"]):
            for key in ("loss", "pcloss"):
                np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                           err_msg=key)
