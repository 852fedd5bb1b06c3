"""The model families beside model and model_emd (model_cpu,
model_hierachy, model_upconv, model_fc_upconv) against the JAX package, on
the CPU: weights moved from perturbed JAX variables by both routes
(``from_flax_variables`` and the reference-named ``.npz`` of
``tf_import.export_reference_arrays``), then the eval forward, one train
forward with its loss, metrics, every gradient and the new BN statistics,
the point constraints, model_cpu's dense loss and InferenceSession.

Tolerances (f32), the port's earlier ones for the same comparisons
(tests/test_torch_model.py, tests/test_torch_train.py):
- eval forward (pred, embedding, extras): rtol 1e-4, atol 1e-5; the
  train forward's by relative error norm under 1e-4 (TRAIN_FWD_REL);
- loss and metrics: rtol 1e-4;
- gradients: each leaf by its relative error norm, under 1e-3; a leaf
  that is zero in exact arithmetic (the bias before a training BN) must
  read under 1e-5 of the whole gradient's norm on both sides;
- BN moving statistics: rtol 1e-4, atol 1e-5.

Sizes: B=2 (B=8 for the train step, see TRAIN_BATCH); the upconv
decoders always emit 2048 points, so their inputs hold 128 points. The
train step shares JAX's ReLU masks with the port (_shared_relu_masks), as
chip_smoke.py shares the card's with the CPU.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.ops import fused_head as jfused_head
from pointnet_autoencoder_tpu.tf_import import export_reference_arrays
from pointnet_autoencoder_tpu_torch.convert import (from_flax_variables,
                                                    from_reference_arrays)
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.models.registry import (available_models,
                                                            get_model_spec,
                                                            reference_models)
from pointnet_autoencoder_tpu_torch.nn.layers import PointMLP, UpConv
from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
from torch_dp_workers import relu_through

torch.set_num_threads(2)

BATCH = 2
# The train step's batch. Training BN normalizes each channel over the
# batch: at B=2 a channel whose two values nearly agree divides their
# small difference by sqrt(var + eps), which magnifies the rounding of the
# layer's input, and two f32 evaluations of one function (the port's and
# JAX's) differ by more than the tolerances below. At B=8 they agree.
TRAIN_BATCH = 8
# family -> (num_point, input points per cloud)
SIZES = {
    "model_cpu": (64, 64),
    "model_hierachy": (128, 128),
    "model_upconv": (2048, 128),
    "model_fc_upconv": (2048, 128),
}
FAMILIES = sorted(SIZES)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
# The train forward's outputs by their relative error norm: training BN
# divides by the batch's spread, which magnifies the encoder's rounding at
# a few entries past the eval forward's elementwise tolerance.
TRAIN_FWD_REL = 1e-4
BN_MOMENTUM = 0.5


def _perturbed(variables, seed=0):
    """Variables as numpy with BN parameters, statistics and biases moved
    off their init values (a quarter of the gammas negative)."""
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


@pytest.fixture(scope="module")
def reference():
    """family -> (flax module, perturbed variables)."""
    out = {}
    for name in FAMILIES:
        module = jspec(name).make(SIZES[name][0])
        variables = jax.jit(lambda key, x: module.init(
            key, x, train=False, bn_momentum=0.9))(
                jax.random.PRNGKey(1), jnp.zeros((2, SIZES[name][0], 3)))
        out[name] = module, _perturbed(variables)
    return out


@pytest.fixture(scope="module")
def npz_paths(reference, tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    paths = {}
    for name, (_, variables) in reference.items():
        paths[name] = str(root / f"{name}.npz")
        np.savez(paths[name], **export_reference_arrays(variables))
    return paths


def _state_dict(reference, npz_paths, name, route):
    if route == "flax":
        return from_flax_variables(reference[name][1])
    return from_reference_arrays(npz_paths[name])


def _clouds(name, seed=0, batch=BATCH):
    return np.random.RandomState(seed).randn(
        batch, SIZES[name][1], 3).astype(np.float32)


def _port(name, sd):
    model = get_model_spec(name).make(SIZES[name][0])
    model.load_state_dict(sd)
    return model


def test_available_models_match_the_jax_registry():
    from pointnet_autoencoder_tpu.models.registry import \
        available_models as javailable

    # The port's registry holds the JAX package's families and pcn_emd.
    assert reference_models() == javailable()
    assert available_models() == sorted(reference_models() + ["pcn_emd"])
    for name in reference_models():
        assert get_model_spec(name).neck == jspec(name).neck, name
        assert get_model_spec(name).decoder == jspec(name).decoder, name


@pytest.mark.parametrize("name", FAMILIES)
def test_both_routes_give_the_same_state_dict(reference, npz_paths, name):
    a = _state_dict(reference, npz_paths, name, "flax")
    b = _state_dict(reference, npz_paths, name, "npz")
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    model = get_model_spec(name).make(SIZES[name][0])
    assert sorted(model.state_dict()) == sorted(a)


@pytest.mark.parametrize("route", ["flax", "npz"])
@pytest.mark.parametrize("name", FAMILIES)
def test_eval_forward_matches_jax(reference, npz_paths, name, route):
    module, variables = reference[name]
    model = _port(name, _state_dict(reference, npz_paths, name, route))
    pts = _clouds(name, seed=1)
    want_pred, want_ep = module.apply(variables, jnp.asarray(pts),
                                      train=False, bn_momentum=0.0)
    with torch.inference_mode():
        pred, end_points = model(torch.from_numpy(pts))
    assert pred.shape == (BATCH, SIZES[name][0], 3)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred),
                               **FWD_TOL)
    assert sorted(end_points) == sorted(want_ep)
    for key, value in end_points.items():
        assert value.shape == want_ep[key].shape, key
        np.testing.assert_allclose(value.numpy(), np.asarray(want_ep[key]),
                                   err_msg=key, **FWD_TOL)


@pytest.fixture(scope="module")
def jax_train(reference):
    """family -> one JAX train step's pred, end_points, loss, metrics,
    gradients and new BN statistics (as port state_dicts) and ReLU masks,
    on TRAIN_BATCH clouds, their own label. The JAX encoder runs its conv5
    head as on the TPU, through the Pallas kernel (interpreted on the
    CPU), whose statistics the port's head computes the same way (from
    moments); the CPU's default, direct XLA statistics, rounds them
    otherwise."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfused_head, "_auto_impl", lambda: "pallas")
        for name in FAMILIES:
            out[name] = _jax_train_step(*reference[name], name)
    return out


def _jax_train_step(module, variables, name):
    spec = jspec(name)
    pts = jnp.asarray(_clouds(name, seed=2, batch=TRAIN_BATCH))

    def loss_fn(params):
        (pred, ep), mutated = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            pts, train=True, bn_momentum=BN_MOMENTUM,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
        loss, metrics = spec.loss_fn(pred, pts, ep)
        return loss, (pred, ep, metrics, mutated)

    (loss, (pred, ep, metrics, mutated)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return dict(
        pred=np.asarray(pred), ep={k: np.asarray(v) for k, v in ep.items()},
        loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
        grads=from_flax_variables({"params": jax.device_get(grads)}),
        buffers=from_flax_variables(jax.device_get(
            {"params": variables["params"],
             "batch_stats": mutated["batch_stats"]})),
        masks=_relu_masks(mutated["intermediates"]))


def _relu_masks(intermediates) -> dict:
    """Port module name -> JAX's ReLU mask of that layer (its output > 0),
    for every layer that ends in a ReLU."""
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


@contextlib.contextmanager
def _shared_relu_masks(model, masks, counts):
    """Within the block, every ReLU of ``model``'s layers takes JAX's mask
    of the same layer (``counts``: masks made, and how many of the port's
    own entries differed). A ReLU input within rounding of zero falls
    either way in two f32 evaluations, and one flipped entry moves the
    gradient of every BN behind it, most of all the near-cancelling sums
    of the encoder's BN betas; shared masks leave rounding as the only
    difference."""
    current = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: current.append(name))
        for name, m in model.named_modules()
        if isinstance(m, (PointMLP, UpConv))]

    def relu(x):
        mask = masks[current[-1]]
        assert mask.shape == x.shape, (current[-1], mask.shape, x.shape)
        counts["made"] += mask.numel()
        counts["differed"] += int(((x > 0) != mask).sum())
        return x * mask.to(x.dtype)

    try:
        with relu_through(relu):
            yield
    finally:
        for h in hooks:
            h.remove()


def _hold_gradients(model, want_grads):
    total = np.sqrt(sum(float(np.sum(g.numpy().astype(np.float64) ** 2))
                        for g in want_grads.values()))
    for pname, p in model.named_parameters():
        got = p.grad.numpy().astype(np.float64)
        want = want_grads[pname].numpy().astype(np.float64)
        if np.linalg.norm(want) < 1e-5 * total:
            assert np.linalg.norm(got) < 1e-5 * total, pname
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-3, (pname, rel)


@pytest.mark.parametrize("route", ["flax", "npz"])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_forward_loss_gradients_and_bn_match_jax(
        reference, npz_paths, jax_train, name, route):
    want = jax_train[name]
    model = _port(name, _state_dict(reference, npz_paths, name, route))
    pts = torch.from_numpy(_clouds(name, seed=2, batch=TRAIN_BATCH))
    counts = {"made": 0, "differed": 0}
    with _shared_relu_masks(model, want["masks"], counts):
        pred, end_points = model(pts, train=True, bn_momentum=BN_MOMENTUM)
    loss, metrics = get_model_spec(name).loss_fn(pred, pts, end_points)
    loss.backward()
    # Every ReLU took JAX's mask of its layer; the port's own masks differ
    # only at a few inputs within rounding of zero.
    assert counts["differed"] <= 1e-4 * counts["made"], counts
    for key, value in [("pred", pred)] + list(end_points.items()):
        ref = want["pred"] if key == "pred" else want["ep"][key]
        rel = (np.linalg.norm(value.detach().numpy() - ref)
               / np.linalg.norm(ref))
        assert rel < TRAIN_FWD_REL, (key, rel)
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-4)
    assert sorted(metrics) == sorted(want["metrics"])
    for key, value in metrics.items():
        np.testing.assert_allclose(value.item(), want["metrics"][key],
                                   rtol=1e-4, err_msg=key)
    _hold_gradients(model, want["grads"])
    for bname, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want["buffers"][bname].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=bname)


def test_hierarchy_loss_terms(reference, npz_paths, jax_train):
    """pc1loss is the centers' two directional means against the label,
    and the loss is (pcloss + 0.1 * pc1loss) * 100."""
    model = _port("model_hierachy", from_flax_variables(
        reference["model_hierachy"][1]))
    pts = torch.from_numpy(_clouds("model_hierachy", seed=2))
    with torch.no_grad():
        pred, ep = model(pts)
        loss, metrics = get_model_spec("model_hierachy").loss_fn(pred, pts, ep)
        d1, _, d2, _ = ch.nn_distance_plain(ep["pc1_xyz"], pts)
    assert ep["pc1_xyz"].shape == (BATCH, 64, 3)
    torch.testing.assert_close(metrics["pc1loss"], d1.mean() + d2.mean())
    torch.testing.assert_close(
        loss, (metrics["pcloss"] + 0.1 * metrics["pc1loss"]) * 100.0)


def test_model_cpu_loss_is_dense_and_equals_model(monkeypatch):
    """model_cpu's loss runs the plain forward and gradient by name, never
    the kernel wrappers, and gives model's loss and gradient on the CPU."""
    calls = {"fwd": 0, "grad": 0}
    fwd, grad = ch.nn_distance_plain, ch.nn_distance_grad_plain

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper

    def kernel(*args):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(ch, "nn_distance_plain", counted("fwd", fwd))
    monkeypatch.setattr(ch, "nn_distance_grad_plain", counted("grad", grad))
    monkeypatch.setattr(ch, "nn_distance_cuda", kernel)
    monkeypatch.setattr(ch, "nn_distance_grad_cuda", kernel)
    rng = np.random.RandomState(3)
    label, pred = (torch.from_numpy(rng.randn(BATCH, 64, 3).astype(
        np.float32)) for _ in range(2))
    results = []
    for name in ("model_cpu", "model"):
        leaf = pred.clone().requires_grad_()
        loss, _ = get_model_spec(name).loss_fn(leaf, label, {})
        loss.backward()
        results.append((loss.detach(), leaf.grad))
    assert calls == {"fwd": 2, "grad": 2}
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])


@pytest.mark.parametrize("name,bad,good", [
    ("model_upconv", 1024, 2048), ("model_fc_upconv", 2047, 2048),
    ("model_hierachy", 100, 128)])
def test_point_constraints_raise_value_error(name, bad, good, npz_paths):
    spec = get_model_spec(name)
    with pytest.raises(ValueError, match=f"num_point={bad} invalid"):
        spec.make(bad)
    with pytest.raises(ValueError, match=f"num_point={bad} invalid"):
        jspec(name).make(bad)
    spec.check_num_point(good)
    with pytest.raises(ValueError, match=f"num_point={bad} invalid"):
        InferenceSession(name, npz_paths[name], bad, device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_session_serves_each_family(reference, npz_paths, name):
    """reconstruct and embed against JAX's eval forward (a ragged batch),
    decode(embed(x)) == reconstruct(x), and decode takes the neck's
    width."""
    num_point = SIZES[name][0]
    session = InferenceSession(name, npz_paths[name], num_point,
                               batch_size=BATCH, device="cpu")
    pts = np.random.RandomState(4).randn(BATCH + 1, num_point, 3).astype(
        np.float32)
    module, variables = reference[name]
    want_pred, want_ep = module.apply(variables, jnp.asarray(pts),
                                      train=False, bn_momentum=0.0)
    rec = session.reconstruct(pts)
    emb = session.embed(pts)
    width = jspec(name).neck[-1] if jspec(name).neck else 1024
    assert emb.shape == (BATCH + 1, width)
    np.testing.assert_allclose(rec, np.asarray(want_pred), **FWD_TOL)
    np.testing.assert_allclose(emb, np.asarray(want_ep["embedding"]),
                               **FWD_TOL)
    np.testing.assert_allclose(session.decode(emb), rec, rtol=1e-6, atol=0)
    assert session.decode(emb[0]).shape == (num_point, 3)
