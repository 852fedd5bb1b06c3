"""The port's serving slice as a whole (``--model model``), on the CPU:
weights moved from a JAX-initialized model (BN statistics perturbed) by
both routes, ``from_flax_variables`` and the reference-named ``.npz``
that ``tf_import.export_reference_arrays`` writes, then the forward and
``InferenceSession`` against JAX ``model.apply(train=False)`` and the
numpy oracles.

Forward tolerance f32: rtol 1e-4, atol 1e-5 (the port folds each BN into
one affine where the JAX eval path applies Dense, then BN, in f32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.ops import oracles
from pointnet_autoencoder_tpu.tf_import import export_reference_arrays
from pointnet_autoencoder_tpu_torch.convert import (from_flax_variables,
                                                    from_reference_arrays)
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 4


@pytest.fixture(scope="module")
def reference():
    """(flax module, perturbed variables as numpy) for --model model."""
    module, variables = jspec("model").init_variables(
        jax.random.PRNGKey(0), NUM_POINT)
    rng = np.random.RandomState(0)

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

    return module, jax.tree_util.tree_map_with_path(
        perturb, jax.device_get(variables))


@pytest.fixture(scope="module")
def npz_path(reference, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weights") / "model.npz")
    np.savez(path, **export_reference_arrays(reference[1]))
    return path


def _clouds(n, seed=0):
    return np.random.RandomState(seed).randn(n, NUM_POINT, 3).astype(
        np.float32)


def _jax_forward(reference, pts):
    module, variables = reference
    pred, end_points = module.apply(variables, jnp.asarray(pts), train=False,
                                    bn_momentum=0.0)
    return np.asarray(pred), np.asarray(end_points["embedding"])


@pytest.mark.parametrize("route", ["flax", "npz"])
def test_forward_matches_jax(reference, npz_path, route):
    sd = (from_flax_variables(reference[1]) if route == "flax"
          else from_reference_arrays(npz_path))
    model = get_model_spec("model").make(NUM_POINT)
    model.load_state_dict(sd)
    pts = _clouds(3)
    with torch.inference_mode():
        pred, end_points = model(torch.from_numpy(pts))
    want_pred, want_emb = _jax_forward(reference, pts)
    assert pred.shape == (3, NUM_POINT, 3)
    np.testing.assert_allclose(pred.numpy(), want_pred, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(end_points["embedding"].numpy(), want_emb,
                               rtol=1e-4, atol=1e-5)


def test_both_routes_give_the_same_state_dict(reference, npz_path):
    a = from_flax_variables(reference[1])
    b = from_reference_arrays(npz_path)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["encoder.conv1.dense.weight"].shape == (64, 3)
    assert a["decoder.fc3.dense.weight"].shape == (NUM_POINT * 3, 1024)


def test_npz_accepts_double_underscore_and_skips_optimizer_state(
        reference, tmp_path):
    arrays = {k.replace("/", "__"): v
              for k, v in export_reference_arrays(reference[1]).items()}
    # contrib's default 'BatchNorm' sub-scope, which tf_import also reads.
    arrays["conv1__bn__BatchNorm__gamma"] = arrays.pop("conv1__bn__gamma")
    arrays["fc1__BatchNorm__beta"] = arrays.pop("fc1__bn__beta")
    arrays["fc1__weights__Adam"] = np.zeros(1, np.float32)
    arrays["beta1_power"] = np.zeros((), np.float32)
    sd = from_reference_arrays(arrays)
    assert sorted(sd) == sorted(from_flax_variables(reference[1]))
    arrays["mystery/kernel"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="mystery"):
        from_reference_arrays(arrays)


@pytest.fixture(scope="module")
def session(npz_path):
    return InferenceSession("model", npz_path, NUM_POINT, batch_size=BATCH,
                            device="cpu")


def test_session_reconstruct_and_embed_match_jax(session, reference):
    pts = _clouds(BATCH + 2, seed=1)  # ragged: one full chunk + 2
    want_pred, want_emb = _jax_forward(reference, pts)
    rec = session.reconstruct(pts)
    emb = session.embed(pts)
    assert rec.shape == (BATCH + 2, NUM_POINT, 3) and rec.dtype == np.float32
    np.testing.assert_allclose(rec, want_pred, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(emb, want_emb, rtol=1e-4, atol=1e-5)
    one = session.reconstruct(pts[2])
    assert one.shape == (NUM_POINT, 3)
    np.testing.assert_allclose(one, rec[2], rtol=1e-6, atol=1e-7)


def test_session_decode_of_embed_is_reconstruct(session):
    pts = _clouds(BATCH + 1, seed=2)
    np.testing.assert_allclose(session.decode(session.embed(pts)),
                               session.reconstruct(pts), rtol=1e-6, atol=0)
    single = session.decode(session.embed(pts[0]))
    assert single.shape == (NUM_POINT, 3)


def test_session_chamfer_fscore_evaluate_match_oracles(session):
    pts = _clouds(BATCH + 3, seed=3)
    rec = session.reconstruct(pts)
    d1, _, d2, _ = oracles.nn_distance_np(rec, pts)
    want = d1.mean(axis=1) + d2.mean(axis=1)
    np.testing.assert_allclose(session.chamfer(rec, pts), want, rtol=1e-6)
    noisy = pts + 0.05 * np.random.RandomState(4).randn(*pts.shape).astype(
        np.float32)
    np.testing.assert_allclose(session.fscore(pts, noisy, 0.1),
                               oracles.fscore_np(pts, noisy, 0.1), rtol=1e-6)
    dataset = [(c,) for c in pts]
    mean_cd, per_shape = session.evaluate(dataset, seed=5)
    order = np.random.default_rng(5).permutation(len(dataset))
    np.testing.assert_allclose(per_shape, want[order], rtol=1e-5)
    assert mean_cd == pytest.approx(float(per_shape.mean()))
    _, part = session.evaluate(dataset, num_shapes=2, seed=5)
    np.testing.assert_allclose(part, want[order[:2]], rtol=1e-5)


def test_session_bf16_stays_near_f32(session, npz_path):
    """bf16 parameters and matmul inputs: within bf16 accuracy of f32
    (a few bf16 roundings through five encoder and three decoder layers);
    BN statistics stay f32."""
    bf = InferenceSession("model", npz_path, NUM_POINT, batch_size=BATCH,
                          bf16=True, device="cpu")
    assert bf.model.encoder.conv1.bn.mean.dtype == torch.float32
    assert bf.model.decoder.fc1.dense.weight.dtype == torch.bfloat16
    pts = _clouds(BATCH, seed=6)
    ref = session.reconstruct(pts)
    got = bf.reconstruct(pts)
    assert got.dtype == np.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * scale)


def test_model_emd_session_reads_the_model_weights(session, npz_path):
    """model_emd is model's network trained on another loss: its session
    reads the same reference-named weights and serves the same outputs."""
    emd_session = InferenceSession("model_emd", npz_path, NUM_POINT,
                                   batch_size=BATCH, device="cpu")
    pts = _clouds(3, seed=8)
    np.testing.assert_array_equal(emd_session.reconstruct(pts),
                                  session.reconstruct(pts))
    np.testing.assert_array_equal(emd_session.embed(pts), session.embed(pts))


def test_session_rejects_bad_inputs_and_weights(session, npz_path, tmp_path):
    with pytest.raises(ValueError, match="expected"):
        session.reconstruct(np.zeros((2, NUM_POINT + 1, 3), np.float32))
    with pytest.raises(ValueError, match="0 input shapes"):
        session.embed(np.zeros((0, NUM_POINT, 3), np.float32))
    with pytest.raises(ValueError, match="num_point"):
        InferenceSession("model", npz_path, NUM_POINT * 2, device="cpu")
    with pytest.raises(KeyError, match="model_nonexistent"):
        InferenceSession("model_nonexistent", npz_path, NUM_POINT,
                         device="cpu")
    pt = str(tmp_path / "w.pt")
    torch.save(session.model.state_dict(), pt)
    again = InferenceSession("model", pt, NUM_POINT, batch_size=BATCH,
                             device="cpu")
    pts = _clouds(2, seed=7)
    np.testing.assert_array_equal(again.reconstruct(pts),
                                  session.reconstruct(pts))
    with pytest.raises(ValueError, match=".npz"):
        InferenceSession("model", os.path.dirname(pt), NUM_POINT,
                         device="cpu")
