"""The port's point parallelism (pointnet_autoencoder_tpu_torch/parallel/
sp.py) on the CPU, on k = 2 and 4 gloo ranks, against the unsharded ops
and the JAX package's parallel/sp.py on a mesh of k of the 8 virtual CPU
devices.

Ranks are processes spawned by ``mesh.launch`` (a ``file://`` store in the
test's tmp_path); their bodies are in tests/torch_dp_workers.py, which
imports no JAX. One launch per k runs every op case; the train step is
tests/test_torch_sp_step.py's.

Tolerances (the JAX package's, tests/test_parallel.py:372-560):
- nn_distance: indices equal (ties across shards included), distances
  rtol 1e-6; the Chamfer loss's gradients rtol 1e-5, atol 1e-6;
- EMD cost rtol 1e-5 against JAX's point-sharded cost and the port's
  unsharded one; its gradients rtol 1e-4, atol 2e-5;
- the conv5 head's combined max and argmax equal to the unsharded head's
  (duplicated points across shards and all-zero channels included), dx
  equal, dw and the affine's gradients rtol 1e-5, atol 1e-6;
- the eval embedding bit-equal to the unsharded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from pointnet_autoencoder_tpu.parallel import mesh as jmesh
from pointnet_autoencoder_tpu.parallel import sp as jsp
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
from pointnet_autoencoder_tpu_torch.ops import emd as em
from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
from pointnet_autoencoder_tpu_torch.parallel import mesh, sp

torch.set_num_threads(2)

B = 2
N, M = 128, 96
HEAD_B, HEAD_N, HEAD_F = 3, 32, 256


def _ops_cases(k):
    rng = np.random.RandomState(10 + k)
    x = rng.randn(B, N, 3).astype(np.float32)
    y = rng.randn(B, M, 3).astype(np.float32)
    tie = x.copy()
    tie[:, 100] = tie[:, 3]  # the same point in shard 0 and the last shard
    hx = rng.randn(HEAD_B, HEAD_N, 128).astype(np.float32)
    # Duplicated points across the shards: the lower copy must win.
    half = HEAD_N // 2
    hx[:, half + 1] = hx[:, 1]
    hx[:, HEAD_N - 1] = hx[:, 5]
    hw = (0.1 * rng.randn(128, HEAD_F)).astype(np.float32)
    hb = (0.1 * rng.randn(HEAD_F)).astype(np.float32)
    gamma = (1 + 0.2 * rng.randn(HEAD_F)).astype(np.float32)
    gamma[::7] *= -1
    beta = (0.1 * rng.randn(HEAD_F)).astype(np.float32)
    beta[::5] = -50.0  # all-zero channels: point 0 of shard 0 wins
    mean = (0.1 * rng.randn(HEAD_F)).astype(np.float32)
    var = (1 + rng.rand(HEAD_F)).astype(np.float32)
    g = rng.randn(HEAD_B, HEAD_F).astype(np.float32)
    state = _perturbed_state("model", N, seed=k)
    points = rng.randn(B, N, 3).astype(np.float32)
    return {"chamfer": (x, y), "tie": (tie, y), "emd": (x, y),
            "head": (hx, hw, hb, gamma, beta, mean, var, g),
            "eval": (state, points)}


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


@pytest.fixture(scope="module", params=[2, 4])
def sp_runs(request, tmp_path_factory):
    """For k ranks: the ops' cases and every rank's outputs."""
    k = request.param
    tmp = tmp_path_factory.mktemp(f"sp{k}")
    ops = _ops_cases(k)
    out = tmp / "out"
    out.mkdir()
    mesh.launch(workers.sp_ops_rank, devices=["cpu"] * k, backend="gloo",
                init_method=f"file://{tmp / 'store'}", args=(str(out), ops))
    return dict(k=k, ops=ops, ops_out=workers.load_ranks(str(out), k))


def _cat(ranks, key, i):
    return torch.cat([r[key][i] for r in ranks], dim=1)


# -- Chamfer ------------------------------------------------------------------


def test_nn_distance_point_sharded_matches_unsharded_and_jax(sp_runs):
    k, ranks = sp_runs["k"], sp_runs["ops_out"]
    x, y = sp_runs["ops"]["chamfer"]
    want = ch.nn_distance_plain(torch.from_numpy(x), torch.from_numpy(y))
    jm = jmesh.make_mesh(data_parallel=k)
    jwant = jax.jit(lambda a, b: jsp.nn_distance_point_sharded(a, b, jm))(
        jnp.asarray(x), jnp.asarray(y))
    got = (_cat(ranks, "chamfer", 0), _cat(ranks, "chamfer", 1),
           ranks[0]["chamfer"][2], ranks[0]["chamfer"][3])
    for r in ranks[1:]:
        assert torch.equal(r["chamfer"][2], got[2])
        assert torch.equal(r["chamfer"][3], got[3])
    for ref in (want, [torch.from_numpy(np.array(t)) for t in jwant]):
        for i in (1, 3):
            assert torch.equal(got[i], ref[i].int())
        for i in (0, 2):
            np.testing.assert_allclose(got[i].numpy(), ref[i].numpy(),
                                       rtol=1e-6)


def test_tie_break_across_shards_takes_the_lowest_global_index(sp_runs):
    """tests/test_parallel.py:423: point 100 duplicates point 3 in another
    shard; 3 wins every tie, as unsharded."""
    ranks = sp_runs["ops_out"]
    x, y = sp_runs["ops"]["tie"]
    _, _, _, want = ch.nn_distance_plain(torch.from_numpy(x),
                                         torch.from_numpy(y))
    got = ranks[0]["tie"][3]
    assert torch.equal(got, want)
    assert (got == 3).any() and not (got == 100).any()


def test_chamfer_loss_gradients_match_unsharded_and_jax(sp_runs):
    k, ranks = sp_runs["k"], sp_runs["ops_out"]
    x, y = sp_runs["ops"]["chamfer"]
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    loss = ch.chamfer_loss(xt, yt)
    loss.backward()
    jm = jmesh.make_mesh(data_parallel=k)
    jgx, jgy = jax.jit(jax.grad(
        lambda a, b: jsp.chamfer_loss_point_sharded(a, b, jm),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(y))
    shares = [r["chamfer_loss"] for r in ranks]
    np.testing.assert_allclose(float(sum(s[0] for s in shares)),
                               float(loss.detach()), rtol=1e-6)
    gx = torch.cat([s[1] for s in shares], dim=1).numpy()
    gy = sum(s[2] for s in shares).numpy()
    for wx, wy in ((xt.grad.numpy(), yt.grad.numpy()),
                   (np.asarray(jgx), np.asarray(jgy))):
        np.testing.assert_allclose(gx, wx, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gy, wy, rtol=1e-5, atol=1e-6)


def test_points_that_do_not_divide_raise():
    with pytest.raises(ValueError, match="must divide"):
        sp.point_slice(126, 0, 4)
    with pytest.raises(ValueError, match="must divide"):
        sp.check_points_divisible(2047, 2)


# -- EMD ----------------------------------------------------------------------


def test_emd_point_sharded_matches_unsharded_and_jax(sp_runs):
    """The shares' sum against the port's unsharded EMD and JAX's
    point-sharded one: cost rtol 1e-5; gradients rtol 1e-4, atol 2e-5
    against the port's unsharded ones. Against JAX's, the gradients are
    held by their distance to the float64 EMD (the port's plain version
    in double): no further than twice JAX's, since the 10 annealing
    levels amplify the last bits differently in each framework (on k =
    2's input JAX's f32 gradient lies 10x further from float64 than the
    port's)."""
    k, ranks = sp_runs["k"], sp_runs["ops_out"]
    x, y = sp_runs["ops"]["emd"]
    jm = jmesh.make_mesh(data_parallel=k)
    jcost = np.asarray(jax.jit(
        lambda a, b: jsp.emd_cost_point_sharded(a, b, jm))(
            jnp.asarray(x), jnp.asarray(y)))
    jgy, jgx = jax.jit(jax.grad(
        lambda a, b: jsp.emd_loss_point_sharded(a, b, jm),
        argnums=(0, 1)))(jnp.asarray(y), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    cost = em.emd_cost(xt, yt)
    em.emd_loss(yt, xt).backward()
    got_cost = sum(r["emd"][0] for r in ranks).numpy()
    for want in (jcost, cost.detach().numpy()):
        np.testing.assert_allclose(got_cost, want, rtol=1e-5)
    np.testing.assert_allclose(float(sum(r["emd"][1] for r in ranks)),
                               float(cost.detach().mean()), rtol=1e-5)
    gx = torch.cat([r["emd"][2] for r in ranks], dim=1).numpy()
    gy = sum(r["emd"][3] for r in ranks).numpy()
    np.testing.assert_allclose(gx, xt.grad.numpy(), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(gy, yt.grad.numpy(), rtol=1e-4, atol=2e-5)
    b = x.shape[0]
    _, f64x, f64y = em.emd_forward_plain(torch.from_numpy(x).double(),
                                         torch.from_numpy(y).double())
    for got, jwant, exact in ((gx, jgx, f64x), (gy, jgy, f64y)):
        exact = exact.numpy() / b
        ours = np.abs(got - exact).max()
        theirs = np.abs(np.asarray(jwant) - exact).max()
        assert ours <= 2 * theirs, (ours, theirs)


# -- the encoder --------------------------------------------------------------


def test_head_combine_matches_the_unsharded_head(sp_runs):
    ranks = sp_runs["ops_out"]
    hx, hw, hb, gamma, beta, mean, var, g = (
        torch.from_numpy(a) for a in sp_runs["ops"]["head"])
    scale, shift = fh.fold_affine(hb, gamma, beta, mean, var, 1e-3)
    want_max, want_arg = fh.head_max_plain(hx, hw, scale, shift)
    # The ties: the lower copy's index, and point 0 for the dead channels.
    half = HEAD_N // 2
    assert not ((want_arg == half + 1) | (want_arg == HEAD_N - 1)).any()
    assert (want_arg[:, ::5] == 0).all() and (want_max[:, ::5] == 0).all()

    x = hx.clone().requires_grad_(True)
    params = [t.clone().requires_grad_(True) for t in (hw, hb, gamma, beta)]
    feat = fh.fused_dense_bn_relu_max(x, *params, mean, var)
    (feat * g).sum().backward()
    for r in ranks:
        assert torch.equal(r["head_grad"][0], feat.detach())
    assert torch.equal(torch.cat([r["head_grad"][1] for r in ranks], dim=1),
                       x.grad)
    for i, p in enumerate(params):
        got = sum(r["head_grad"][2][i] for r in ranks)
        np.testing.assert_allclose(got.numpy(), p.grad.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_eval_embedding_bit_equal_to_unsharded(sp_runs):
    state, points = sp_runs["ops"]["eval"]
    model = get_model_spec("model").make(points.shape[1])
    model.load_state_dict(state)
    with torch.no_grad():
        want = fe.fused_encoder_eval(torch.from_numpy(points),
                                     model.encoder.fold())
    for r in sp_runs["ops_out"]:
        assert torch.equal(r["eval"], want)
