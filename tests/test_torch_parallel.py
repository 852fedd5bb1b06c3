"""The port's data parallelism (pointnet_autoencoder_tpu_torch/parallel/
mesh.py) on the CPU: the mesh, the launcher hook and the batch check;
BatchNorm and the fused head's statistics under a group of k = 2 and 4
gloo ranks against the full batch and against the JAX package's
batch-sharded jit; one f32 train step of every --model on 2 ranks against
the one-device step, and `model`'s against the JAX package's step on
make_mesh(data_parallel=2).

Ranks are processes spawned by ``mesh.launch`` (start method spawn, a
``file://`` store in the test's tmp_path); their bodies are in
tests/torch_dp_workers.py, which imports no JAX. Each test spawns once.

Tolerances:
- BatchNorm and head_stats: outputs within 1e-6 (rtol and atol); the
  gradient wrt x through the all-reduce within 1e-6 of its largest entry;
  every rank's moving statistics bit-equal;
- the train step, 2 ranks against one device at global B=8: loss and
  metrics rtol 1e-5; BN statistics rtol 1e-5, atol 1e-5; the ranks
  replay the one-device step's discrete choices (argmins, argmax, ReLU
  masks, EMD outputs), and their own differ at no more than 1e-4 of them.
  Gradients are held to the f32 floor of the step itself: the one-device
  step on the same batch with its rows swapped in pairs (the same
  choices, so only the order of the batch sums changes, as it does
  across ranks) moves the gradient by a relative error norm of 9e-6 to
  6.5e-5 and a leaf by up to 1.7e-4 of its largest entry, above the 1e-5
  a tighter bound would ask. The ranks' gradient must lie within twice
  that floor, both for the whole gradient's relative error norm and for
  the worst leaf's largest gap over its largest entry; a leaf that is
  zero in exact arithmetic (a bias before a training BN) reads as
  rounding noise, under 1e-5 of the whole gradient's norm, on both
  sides;
- against JAX's data-parallel step: loss rtol 1e-5, BN statistics rtol
  1e-4, atol 1e-6 (tests/test_parallel.py:86-111).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp_workers as workers
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.nn.layers import BatchNorm as JBatchNorm
from pointnet_autoencoder_tpu.ops import fused_head as jfused_head
from pointnet_autoencoder_tpu.parallel import mesh as jmesh
from pointnet_autoencoder_tpu.train import schedules as jschedules
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.models.registry import (get_model_spec,
                                                            reference_models)
from pointnet_autoencoder_tpu_torch.nn.layers import BatchNorm, PointMLP
from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
from pointnet_autoencoder_tpu_torch.parallel import mesh

torch.set_num_threads(2)

STEP_BATCH = 8
# model -> (num_point, input points per cloud); the upconv decoders emit
# 2048 points from any input.
STEP_SIZES = {"model": (128, 128), "model_cpu": (128, 128),
              "model_emd": (128, 128), "model_hierachy": (128, 128),
              "model_upconv": (2048, 128), "model_fc_upconv": (2048, 128)}


def _launch(fn, k, tmp_path, *args):
    out = tmp_path / f"out{k}"
    out.mkdir()
    mesh.launch(fn, devices=["cpu"] * k, backend="gloo",
                init_method=f"file://{tmp_path / f'store{k}'}",
                args=(str(out), *args))
    return workers.load_ranks(str(out), k)


# -- mesh, launcher hook, batch check -----------------------------------------


def test_make_mesh_refuses_cards_that_do_not_exist():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for kwargs in ({}, {"data_parallel": 1}, {"data_parallel": 2}):
        with pytest.raises(ValueError, match="CUDA device"):
            mesh.make_mesh(**kwargs)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh(devices=["cuda:0"])


def test_make_mesh_takes_explicit_devices_in_order():
    cpu = torch.device("cpu")
    assert mesh.make_mesh(devices=["cpu", "cpu", "cpu"]) == [cpu] * 3
    assert mesh.make_mesh(devices=["cpu"] * 4, data_parallel=2) == [cpu] * 2
    with pytest.raises(ValueError, match="needs 3 devices"):
        mesh.make_mesh(devices=["cpu", "cpu"], data_parallel=3)
    with pytest.raises(ValueError, match=">= 1"):
        mesh.make_mesh(devices=["cpu"], data_parallel=0)


def test_check_batch_divisible():
    mesh.check_batch_divisible(16, 8)
    mesh.check_batch_divisible(7, 1)
    with pytest.raises(ValueError, match="divisible"):
        mesh.check_batch_divisible(12, 8)


def test_launch_refuses_nccl_with_two_ranks_on_one_device():
    with pytest.raises(ValueError, match="NCCL"):
        mesh.launch(workers.stats_rank, devices=["cpu", "cpu"],
                    backend="nccl")


def _clear_launcher_env(monkeypatch):
    for var in mesh.LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)


def test_launcher_hook_without_a_launcher(monkeypatch):
    """Bare environment: the hook touches no process group (JAX
    tests/test_parallel.py:231-241)."""
    _clear_launcher_env(monkeypatch)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    assert mesh.initialize_distributed_if_requested("cpu") is False
    assert calls == [] and not dist.is_initialized()


def test_launcher_hook_with_a_launcher(monkeypatch):
    """torchrun's five variables join the group they describe, gloo on the
    CPU (JAX tests/test_parallel.py:244-254)."""
    _clear_launcher_env(monkeypatch)
    for var, value in zip(mesh.LAUNCHER_ENV,
                          ("2", "4", "0", "10.0.0.1", "1234")):
        monkeypatch.setenv(var, value)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    assert mesh.initialize_distributed_if_requested("cpu") is True
    assert calls == [(("gloo",), {"init_method": "env://", "world_size": 4,
                                  "rank": 2})]


def test_launcher_hook_refuses_a_partial_environment(monkeypatch):
    _clear_launcher_env(monkeypatch)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: pytest.fail("initialized"))
    with pytest.raises(RuntimeError, match="LOCAL_RANK, MASTER_ADDR, "
                                           "MASTER_PORT missing"):
        mesh.initialize_distributed_if_requested("cpu")


def test_config_accepts_data_parallel_and_the_trainer_needs_its_group(
        tmp_path):
    TrainConfig(data_parallel=2).validate()
    TrainConfig(data_parallel=None).validate()
    cfg = TrainConfig(data_parallel=2, log_dir=str(tmp_path / "log"),
                      data_path=str(tmp_path / "nowhere"))
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    with pytest.raises(ValueError, match="data_parallel=2 needs a process "
                                         "group of 2 ranks"):
        Trainer(cfg, device="cpu")


# -- BatchNorm and head_stats -------------------------------------------------


def _jax_sharded(fn, k, *arrays):
    """``fn`` jitted on JAX's make_mesh(data_parallel=k) with its first
    argument batch-sharded (the JAX package's data parallelism)."""
    m = jmesh.make_mesh(data_parallel=k)
    return jax.jit(fn)(jmesh.shard_batch(m, jnp.asarray(arrays[0])),
                       *map(jnp.asarray, arrays[1:]))


@pytest.mark.parametrize("k", [2, 4])
def test_batchnorm_and_head_stats_cover_the_global_batch(tmp_path, k):
    rng = np.random.RandomState(k)
    bn_x = (rng.randn(16, 6, 8) * 2 + 1).astype(np.float32)
    bn_w = rng.randn(16, 6, 8).astype(np.float32)
    head_x = rng.randn(16, 4, 128).astype(np.float32)
    head_w = (rng.randn(128, 256) * 0.1).astype(np.float32)
    head_b = rng.randn(256).astype(np.float32)
    head_gm, head_gv = rng.randn(2, 256).astype(np.float32)
    ranks = _launch(workers.stats_rank, k, tmp_path, bn_x, bn_w, head_x,
                    head_w, head_b, head_gm, head_gv)

    # The full batch in one process, without a group.
    x = torch.from_numpy(bn_x).requires_grad_(True)
    bn = BatchNorm(8)
    y = bn(x, True, 0.5)
    (y * torch.from_numpy(bn_w)).sum().backward()
    hx = torch.from_numpy(head_x).requires_grad_(True)
    mean, var = fh.head_stats(hx, torch.from_numpy(head_w),
                              torch.from_numpy(head_b))
    ((mean * torch.from_numpy(head_gm)).sum()
     + (var * torch.from_numpy(head_gv)).sum()).backward()

    # JAX: the same functions under its batch-sharded jit.
    jbn = JBatchNorm()
    jvars = jbn.init(jax.random.PRNGKey(0), jnp.asarray(bn_x), train=False,
                     momentum=0.5)

    def jbn_loss(xx, w):
        out, mutated = jbn.apply(jvars, xx, train=True, momentum=0.5,
                                 mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mutated["batch_stats"])

    (_, (jy, jstats)), jgx = _jax_sharded(
        jax.value_and_grad(jbn_loss, has_aux=True), k, bn_x, bn_w)

    def jhead_loss(xx, w, b, gm, gv):
        m, v = jfused_head.head_stats(xx, w, b)
        return jnp.sum(m * gm) + jnp.sum(v * gv), (m, v)

    (_, (jm, jv)), jhgx = _jax_sharded(
        jax.value_and_grad(jhead_loss, has_aux=True), k, head_x, head_w,
        head_b, head_gm, head_gv)

    tol = dict(rtol=1e-6, atol=1e-6)

    def close_rel(got, want, what):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-6, (what, err)

    got_y = torch.cat([r["y"] for r in ranks]).numpy()
    got_gx = torch.cat([r["gx"] for r in ranks]).numpy()
    got_head = [r["head"] for r in ranks]
    got_hgx = torch.cat([r["head_gx"] for r in ranks]).numpy()
    for want_y, want_gx, want_m, want_v, want_hgx, who in (
            (y.detach().numpy(), x.grad.numpy(), mean.detach().numpy(),
             var.detach().numpy(), hx.grad.numpy(), "full batch"),
            (np.asarray(jy), np.asarray(jgx), np.asarray(jm), np.asarray(jv),
             np.asarray(jhgx), "JAX")):
        np.testing.assert_allclose(got_y, want_y, err_msg=who, **tol)
        close_rel(got_gx, want_gx, f"BN dx against {who}")
        for r in got_head:
            np.testing.assert_allclose(r[0].numpy(), want_m, err_msg=who,
                                       **tol)
            np.testing.assert_allclose(r[1].numpy(), want_v, err_msg=who,
                                       **tol)
        close_rel(got_hgx, want_hgx, f"head_stats dx against {who}")
    np.testing.assert_allclose(ranks[0]["moving"][0].numpy(),
                               np.asarray(jstats["mean"]), **tol)
    np.testing.assert_allclose(ranks[0]["moving"][1].numpy(),
                               np.asarray(jstats["var"]), **tol)
    for r in ranks:
        for i, want in enumerate((bn.mean, bn.var)):
            assert torch.equal(r["moving"][i], ranks[0]["moving"][i])
            np.testing.assert_allclose(r["moving"][i].numpy(), want.numpy(),
                                       **tol)
    # Each rank's gamma and beta gradients are its rows' share: their sum
    # is the full batch's.
    for key, want in (("ggamma", bn.gamma.grad), ("gbeta", bn.beta.grad)):
        close_rel(sum(r[key] for r in ranks).numpy(), want.numpy(), key)


def test_batchnorm_without_a_group_is_unchanged():
    """No group: the statistics are the batch's own, computed as before
    the group existed (mean, then mean of squares, in f32)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 5, 6)
                         .astype(np.float32))
    bn = BatchNorm(6)
    assert bn.group is None
    y = bn(x, True, 0.5)
    xf = x.float()
    mean = xf.mean(dim=(0, 1))
    var = torch.clamp_min(xf.square().mean(dim=(0, 1)) - mean.square(), 0.0)
    inv = torch.rsqrt(var + bn.epsilon)
    assert torch.equal(y, x * inv + (0.0 - mean * inv))
    assert torch.equal(bn.mean, 0.5 * mean)
    assert torch.equal(bn.var, 0.5 + 0.5 * var)


# -- one train step of every --model on 2 ranks -------------------------------


def _perturbed_state(name, num_point):
    """The port's seeded init with BN parameters and statistics moved off
    their init values (a quarter of the gammas negative)."""
    model = get_model_spec(name).make(
        num_point, generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(4)
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


def _jax_model_case():
    """`model` at JAX's perturbed init, as a port state_dict, and JAX's
    step on make_mesh(data_parallel=2): (state, batch, momentum, JAX's
    ReLU masks, loss and metrics, and the new BN statistics of JAX's
    data-parallel step and of its one-device step)."""
    num_point = STEP_SIZES["model"][0]
    spec = jspec("model")
    module, variables = spec.init_variables(jax.random.PRNGKey(0), num_point)
    rng = np.random.RandomState(5)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "gamma":
            return (a * np.where(rng.rand(*a.shape) < 0.25, -1, 1)
                    * (1 + 0.2 * rng.rand(*a.shape))).astype(np.float32)
        if path[-1].key == "var":
            return (a + 0.5 * rng.rand(*a.shape)).astype(np.float32)
        return a

    variables = jax.tree_util.tree_map_with_path(
        perturb, jax.device_get(variables))
    batch = np.random.RandomState(6).randn(
        STEP_BATCH, num_point, 3).astype(np.float32)
    bn = jschedules.bn_momentum_schedule(STEP_BATCH, 200000)
    momentum = bn(0)

    def loss_fn(params, pts):
        (pred, ep), mutated = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            pts, train=True, bn_momentum=momentum,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
        loss, metrics = spec.loss_fn(pred, pts, ep)
        return loss, (metrics, mutated)

    runs = []
    for k in (2, 1):
        m = jmesh.make_mesh(data_parallel=k)
        # The conv5 head as on the TPU: the Pallas kernel (interpreted on
        # the CPU), whose statistics come from moments as the port's do.
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jfused_head, "_auto_impl", lambda: "pallas")
            loss, (metrics, mutated) = jax.jit(loss_fn)(
                jmesh.replicate(m, variables["params"]),
                jmesh.shard_batch(m, jnp.asarray(batch)))
        sd = from_flax_variables(jax.device_get(
            {"params": variables["params"],
             "batch_stats": mutated["batch_stats"]}))
        runs.append({k: v for k, v in sd.items()
                     if k.endswith((".mean", ".var"))})
        if k == 2:
            dp = loss, metrics, mutated
    # JAX's ReLU masks in the port's call order: conv1-4 (conv5's ReLU is
    # inside the fused head), then the decoder's fc1 and fc2.
    loss, metrics, mutated = dp
    masks = _relu_masks(mutated["intermediates"])
    order = [n for n, mod in get_model_spec("model").make(num_point)
             .named_modules() if isinstance(mod, PointMLP) and mod.relu
             and n != "encoder.conv5"]
    metrics = dict({k: float(v) for k, v in metrics.items()},
                   loss=float(loss))
    return (from_flax_variables(variables), batch, float(momentum),
            {"relu": [masks[n] for n in order]}, metrics, runs)


def _relu_masks(intermediates) -> dict:
    """Port module name -> JAX's ReLU mask of that layer (its output > 0),
    for every layer whose output is a ReLU's (tests/test_torch_families.py
    reads them the same way)."""
    out = {}

    def walk(node, path):
        y = node.get("__call__", (None,))[0]
        if isinstance(y, np.ndarray) and y.ndim >= 2 and (y >= 0).all():
            out[".".join(path)] = torch.from_numpy(y > 0)
        for k, v in node.items():
            if k != "__call__":
                walk(v, path + (k,))

    walk(jax.device_get(intermediates), ())
    return out


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """name -> (one-device step, the 2 ranks' steps) for every --model
    from the port's perturbed init, and 'model_jax' from JAX's, with JAX's
    data-parallel result beside it."""
    tmp = tmp_path_factory.mktemp("dp_steps")
    cases, singles = {}, {}
    momentum = 0.5
    for name in reference_models():
        num_point, n_in = STEP_SIZES[name]
        batch = np.random.RandomState(7).randn(
            STEP_BATCH, n_in, 3).astype(np.float32)
        cases[name] = dict(model=name, num_point=num_point,
                           state=_perturbed_state(name, num_point),
                           batch=batch, momentum=momentum)
    floors = {}
    pairs_swapped = np.arange(STEP_BATCH).reshape(-1, 2)[:, ::-1].reshape(-1)
    for name, case in cases.items():
        case["choices"] = {}
        args = (case["model"], case["num_point"], case["state"],
                case["batch"], case["momentum"])
        singles[name] = workers.step(*args, case["choices"])
        floors[name] = workers.step(
            *args, dict(case["choices"]), rows=torch.from_numpy(
                pairs_swapped.copy()), replay=True)
    # `model` from JAX's init: the ranks replay JAX's ReLU masks.
    jstate, jbatch, jmomentum, jmasks, jmetrics, jbuffers = _jax_model_case()
    cases["model_jax"] = dict(model="model", num_point=STEP_SIZES["model"][0],
                              state=jstate, batch=jbatch, momentum=jmomentum,
                              choices=jmasks)
    path = str(tmp / "cases.pt")
    torch.save(cases, path)
    out = tmp / "out"
    out.mkdir()
    mesh.launch(workers.step_rank, devices=["cpu", "cpu"], backend="gloo",
                init_method=f"file://{tmp / 'store'}", args=(path, str(out)))
    ranks = workers.load_ranks(str(out), 2)
    result = {name: (singles[name], [r[name] for r in ranks], floors[name])
              for name in singles}
    return result, ([r["model_jax"] for r in ranks], jmetrics, jbuffers)


def _grad_gaps(got, want):
    """(relative error norm of the whole gradient, the largest gap of a
    leaf over its largest entry) of ``got`` against ``want``, leaves that
    are zero in exact arithmetic left out after checking that they read
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


@pytest.mark.parametrize("name", sorted(STEP_SIZES))
def test_dp_step_matches_the_one_device_step(dp_steps, name):
    """Loss and metrics (the ranks' mean), every gradient after the
    all-reduce and the BN statistics of a 2-rank step at global B=8 equal
    the one-device step's. For model_hierachy this also says that its
    center term, a sum of two per-rank means, is the global batch's (equal
    shards)."""
    single, ranks, floor = dp_steps[0][name]
    for r in ranks:
        differed, made = r["flips"]
        assert made > 0 and differed <= 1e-4 * made, (differed, made)
        assert sorted(r["scalars"]) == sorted(single["scalars"])
        for key, value in r["scalars"].items():
            np.testing.assert_allclose(value, single["scalars"][key],
                                       rtol=1e-5, err_msg=key)
    # Every rank holds the same gradients and statistics after the
    # all-reduce, bit for bit.
    for key in ("grads", "buffers"):
        for n, t in ranks[0][key].items():
            assert torch.equal(t, ranks[1][key][n]), (key, n)
    # The pairs-swapped rows of the floor step are the one-device step's
    # rows in another order: its gradients are a sum over the whole batch.
    dp_norm, dp_worst = _grad_gaps(ranks[0]["grads"], single["grads"])
    floor_norm, floor_worst = _grad_gaps(floor["grads"], single["grads"])
    assert dp_norm <= 2 * floor_norm, (dp_norm, floor_norm)
    assert dp_worst <= 2 * floor_worst, (dp_worst, floor_worst)
    for n, want in single["buffers"].items():
        np.testing.assert_allclose(ranks[0]["buffers"][n].numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_dp_step_matches_jax_data_parallel(dp_steps):
    """`model` from JAX's init on 2 ranks, which take JAX's ReLU masks,
    against JAX's step on make_mesh(data_parallel=2): loss rtol 1e-5, the
    new BN statistics rtol 1e-4, atol 1e-6 (the bounds of
    tests/test_parallel.py:86-111). On this data JAX's own one-device and
    data-parallel steps differ past that bound at 2 of fc2's 1024 means
    (1.6e-6 at a mean of 1e-3 that cancels across the batch); where they
    do, the port must lie within twice JAX's own gap."""
    ranks, jmetrics, (jbuffers, jbuffers1) = dp_steps[1]
    differed, made = ranks[0]["flips"]
    assert made > 0 and differed <= 1e-4 * made, (differed, made)
    for key in ("loss", "pcloss"):
        np.testing.assert_allclose(ranks[0]["scalars"][key], jmetrics[key],
                                   rtol=1e-5, err_msg=key)
    assert sorted(jbuffers) == sorted(ranks[0]["buffers"])
    floored = 0
    for n, want in jbuffers.items():
        want = want.numpy()
        own_gap = np.abs(jbuffers1[n].numpy() - want)
        bound = 1e-6 + 1e-4 * np.abs(want)
        floored += int((own_gap > bound).sum())
        err = np.abs(ranks[0]["buffers"][n].numpy() - want)
        assert (err <= np.maximum(bound, 2 * own_gap)).all(), (
            n, float(err.max()))
    assert floored <= 4, floored
