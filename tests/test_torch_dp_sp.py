"""DP x SP on the port (parallel/sp.py with a batch axis): 4 gloo CPU
ranks on a (2 data, 2 model) grid (parallel.mesh.ProcessMesh), the batch
split over the data axis and every shape's points over the model axis.
The twins of tests/test_parallel.py's test_dp_sp_losses_match_unsharded
and test_dp_sp_train_step_matches_single_device, at 2 x 2 ranks instead
of 2 x 4.

Tolerances:
- the point-sharded Chamfer loss rtol 1e-6, its gradients rtol 1e-5,
  atol 1e-6, the EMD cost rtol 1e-5, against the port's and the JAX
  package's unsharded ops (JAX's test);
- one f32 step of `model` and `model_emd` (B=4, N=128): loss and pcloss
  rtol 1e-5, BN statistics rtol 1e-4 and atol 2e-5, against the port's
  one-device step and, from JAX's init, JAX's one-device step and its
  DP x SP step on a 2 x 4 mesh (JAX's test);
- the gradients, with the one-device step's ReLU masks and Chamfer
  argmins replayed at each rank's rows and points, within twice the f32
  floor of the one-device step with every shape's points rolled by N/2
  (the point-parallel tests' bound), and equal on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.ops import emd as jemd
from pointnet_autoencoder_tpu.ops.chamfer import chamfer_loss as jchamfer
from pointnet_autoencoder_tpu.parallel import mesh as jmesh
from pointnet_autoencoder_tpu.parallel import sp as jsp
from pointnet_autoencoder_tpu.train import schedules as jschedules
from pointnet_autoencoder_tpu.train.loop import make_step_fns as jstep_fns
from pointnet_autoencoder_tpu.train.state import TrainState as JTrainState
from pointnet_autoencoder_tpu.train.state import make_optimizer as jopt
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.ops.chamfer import chamfer_loss
from pointnet_autoencoder_tpu_torch.ops.emd import emd_cost
from pointnet_autoencoder_tpu_torch.parallel import mesh

torch.set_num_threads(2)

RANKS = 4
DATA = 2
NUM_POINT = 128
BATCH = 4
MODELS = ("model", "model_emd")


def _jax_step_case(name):
    """From JAX's init: the port's state, the batch, the momentum, and the
    metrics and BN statistics (port names) of JAX's one-device step and
    of its DP x SP step on make_mesh(2, 4) (data 2, model 4)."""
    spec = jspec(name)
    module, variables = spec.init_variables(jax.random.PRNGKey(0),
                                            NUM_POINT, BATCH)
    lr = jschedules.learning_rate_schedule(0.001, 0.7, BATCH, 200000)
    bn = jschedules.bn_momentum_schedule(BATCH, 200000)
    tx = jopt("adam", lr)
    batch = np.random.RandomState(21).randn(BATCH, NUM_POINT, 3).astype(
        np.float32)
    step, _ = jstep_fns(module, spec, tx, bn, lr)
    s1, m1 = jax.jit(step)(JTrainState.create(variables, tx),
                           jax.device_put(jnp.asarray(batch),
                                          jax.devices()[0]))
    grid = jmesh.make_mesh(data_parallel=2, model_parallel=4)
    sp_step, _ = jsp.make_sp_step_fns(
        module, spec, tx, bn, lr, grid, axis=jmesh.MODEL_AXIS,
        batch_axis=jmesh.DATA_AXIS)
    s2, m2 = jax.jit(sp_step)(
        jmesh.replicate(grid, JTrainState.create(variables, tx)),
        jax.device_put(jnp.asarray(batch), jsp.point_batch_sharding(
            grid, jmesh.MODEL_AXIS, jmesh.DATA_AXIS)))

    def stats(state):
        tree = jax.device_get({"params": state.params,
                               "batch_stats": state.batch_stats})
        return {k: v for k, v in from_flax_variables(tree).items()
                if k.endswith((".mean", ".var"))}

    return dict(state=from_flax_variables(jax.device_get(variables)),
                batch=batch, momentum=float(bn(0)),
                refs=[({k: float(v) for k, v in m1.items()}, stats(s1)),
                      ({k: float(v) for k, v in m2.items()}, stats(s2))])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_sp")
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    x = np.array(jax.random.normal(k1, (4, 128, 3)), np.float32)
    y = np.array(jax.random.normal(k2, (4, 96, 3)), np.float32)
    steps, singles, floors, jcases = {}, {}, {}, {}
    for name in MODELS:
        jcases[name] = _jax_step_case(name)
        case = dict(model=name, num_point=NUM_POINT,
                    state=jcases[name]["state"],
                    batch=jcases[name]["batch"],
                    momentum=jcases[name]["momentum"], choices={})
        args = (name, NUM_POINT, case["state"], case["batch"],
                case["momentum"])
        singles[name] = workers.step(*args, case["choices"])
        rolled = torch.roll(torch.arange(NUM_POINT), NUM_POINT // 2)
        floors[name] = workers.sp_step(*args, choices=case["choices"],
                                       points=rolled)
        steps[name] = case
    path = str(tmp / "cases.pt")
    torch.save({"losses": (x, y), "steps": steps}, path)
    out = tmp / "out"
    out.mkdir()
    mesh.launch(workers.dp_sp_rank, devices=["cpu"] * RANKS,
                backend="gloo", init_method=f"file://{tmp / 'store'}",
                args=(path, str(out)))
    return dict(x=x, y=y, ranks=workers.load_ranks(str(out), RANKS),
                singles=singles, floors=floors, jax=jcases)


def _assembled(run):
    """The ranks' Chamfer shares, gradients and EMD cost shares put back
    together: the global loss is the sum of the shares over the ranks
    divided by the data axis's size; x's gradient is each rank's at its
    rows and points; y's and the EMD cost are summed over the point
    group."""
    x, y = run["x"], run["y"]
    per_b, per_n = x.shape[0] // DATA, x.shape[1] // (RANKS // DATA)
    gx, gy = np.zeros_like(x), np.zeros_like(y)
    cost = np.zeros(x.shape[0], np.float32)
    loss = 0.0
    for r, rank in enumerate(run["ranks"]):
        d, t = divmod(r, RANKS // DATA)
        got = rank["losses"]
        rows = slice(d * per_b, (d + 1) * per_b)
        loss += float(got["share"]) / DATA
        gx[rows, t * per_n:(t + 1) * per_n] = got["gx"].numpy()
        gy[rows] += got["gy"].numpy()
        cost[rows] += got["cost"].numpy()
    return loss, gx, gy, cost


def test_dp_sp_losses_match_unsharded(run):
    """Both point-sharded losses on the 2 x 2 grid against the unsharded
    ops of the port and of the JAX package; a batch of 3 is refused with
    the JAX package's message."""
    x, y = run["x"], run["y"]
    loss, gx, gy, cost = _assembled(run)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    want = chamfer_loss(xt, yt)
    want.backward()
    np.testing.assert_allclose(loss, float(want.detach()), rtol=1e-6)
    np.testing.assert_allclose(loss, float(jchamfer(x, y, impl="xla")),
                               rtol=1e-6)
    jgx, jgy = jax.grad(lambda a, b: jchamfer(a, b, impl="xla"),
                        argnums=(0, 1))(x, y)
    for got, mine, theirs in ((gx, xt.grad, jgx), (gy, yt.grad, jgy)):
        np.testing.assert_allclose(got, mine.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(theirs), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        cost, emd_cost(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        rtol=1e-5)
    np.testing.assert_allclose(
        cost, np.asarray(jemd.emd_cost(x, y, impl="xla")), rtol=1e-5)
    for rank in run["ranks"]:
        assert "batch axis B=3 must divide" in rank["losses"]["refused"]


def _grad_gaps(got, want):
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


@pytest.mark.parametrize("name", MODELS)
def test_dp_sp_train_step_matches_single_device(run, name):
    """One DP x SP step (make_sp_step_fns(..., batch_axis=DATA_AXIS)) with
    the batch AND the points split: every rank holds (2, 64, 3); its
    global loss and pcloss, its BN statistics and its gradients against
    the one-device step, and its loss, pcloss and statistics against
    JAX's one-device and DP x SP steps."""
    single, floor = run["singles"][name], run["floors"][name]
    ranks = [r[name] for r in run["ranks"]]
    fl_norm, fl_worst = _grad_gaps(floor["grads"], single["grads"])
    for r in ranks:
        assert r["shape"] == (BATCH // DATA, NUM_POINT // 2, 3)
        refs = [(single["scalars"], {n: b.numpy() for n, b in
                                     single["buffers"].items()})]
        refs += run["jax"][name]["refs"]
        for metrics, stats in refs:
            for key in ("loss", "pcloss"):
                np.testing.assert_allclose(r["scalars"][key], metrics[key],
                                           rtol=1e-5, err_msg=key)
            for n, want in stats.items():
                np.testing.assert_allclose(r["buffers"][n].numpy(),
                                           np.asarray(want), rtol=1e-4,
                                           atol=2e-5, err_msg=n)
        norm, worst = _grad_gaps(r["grads"], single["grads"])
        assert norm <= 2 * fl_norm, (norm, fl_norm)
        assert worst <= 2 * fl_worst, (worst, fl_worst)
        for n, g in r["grads"].items():
            assert torch.equal(g, ranks[0]["grads"][n]), n
