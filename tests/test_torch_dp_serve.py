"""Data-parallel serving of the port on the CPU: InferenceSession with
data_parallel=2 and 4 replicas on the CPU (``devices=["cpu"] * k``)
against the one-device session and against the JAX package's
data-parallel session on conftest's virtual CPU devices
(tests/test_inference.py:70-100), on ragged batches; chamfer and fscore
split among the replicas when the batch divides and whole when it does
not; the indivisible batch_size error; from_bundle; a PointServer round
trip; cli/serve.py's --data_parallel.

Tolerance, the JAX package's for the same comparison: rtol and atol
1e-5 (Chamfer and F-score atol 1e-6 against the one-device session).
"""

import numpy as np
import pytest
import jax
import torch

from pointnet_autoencoder_tpu.inference import InferenceSession as JSession
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.tf_import import export_reference_arrays
from pointnet_autoencoder_tpu.train import checkpoint as jcheckpoint
from pointnet_autoencoder_tpu.train.state import TrainState as JTrainState
from pointnet_autoencoder_tpu.train.state import make_optimizer as jopt
from pointnet_autoencoder_tpu_torch.cli import serve as cli_serve
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.serve import PointClient, PointServer

torch.set_num_threads(2)

NUM_POINT = 64
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX `model` variables with BN statistics moved off init, as the
    port's reference-named .npz and as a JAX training checkpoint."""
    root = tmp_path_factory.mktemp("weights")
    _, variables = jspec("model").init_variables(jax.random.PRNGKey(2),
                                                 NUM_POINT)
    rng = np.random.RandomState(3)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return (a + 0.5 * rng.rand(*a.shape)).astype(np.float32)
        if path[-1].key == "mean":
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a

    variables = jax.tree_util.tree_map_with_path(
        perturb, jax.device_get(variables))
    npz = str(root / "model.npz")
    np.savez(npz, **export_reference_arrays(variables))
    tx = jopt("adam", lambda s: 1e-3, 0.9)
    ckpt = jcheckpoint.CheckpointManager(str(root / "jax")).save_periodic(
        {"state": JTrainState.create(variables, tx), "epoch": 1,
         "best_loss": 0.0})
    return npz, ckpt


def _clouds(n, seed):
    return np.random.RandomState(seed).randn(n, NUM_POINT, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def one(weights):
    return InferenceSession("model", weights[0], NUM_POINT, batch_size=4,
                            device="cpu")


@pytest.mark.parametrize("k", [2, 4])
def test_dp_session_matches_one_device_and_jax(weights, one, k):
    dp = InferenceSession("model", weights[0], NUM_POINT, batch_size=8,
                          data_parallel=k, devices=["cpu"] * k)
    assert dp.devices == [torch.device("cpu")] * k
    jdp = JSession("model", weights[1], NUM_POINT, batch_size=8,
                   data_parallel=k)
    batch = _clouds(6, seed=k)  # ragged for both batch sizes
    for ref in (one, jdp):
        np.testing.assert_allclose(dp.reconstruct(batch),
                                   ref.reconstruct(batch), **TOL)
        emb = dp.embed(batch)
        np.testing.assert_allclose(emb, ref.embed(batch), **TOL)
        np.testing.assert_allclose(dp.decode(emb), ref.decode(emb), **TOL)
        np.testing.assert_allclose(dp.reconstruct(batch[0]),
                                   ref.reconstruct(batch[0]), **TOL)
    # Chamfer and F-score: split among the replicas when the batch
    # divides (8), whole on the first device when it does not (6, 1).
    pred = dp.reconstruct(_clouds(8, seed=9))
    target = _clouds(8, seed=10)
    for rows in (8, 6, 1):
        p, t = pred[:rows], target[:rows]
        np.testing.assert_allclose(dp.chamfer(p, t), one.chamfer(p, t),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dp.chamfer(p, t), jdp.chamfer(p, t),
                                   **TOL)
        np.testing.assert_allclose(dp.fscore(p, t, 0.5),
                                   one.fscore(p, t, 0.5), atol=1e-6)
    np.testing.assert_allclose(dp.chamfer(target, target), np.zeros(8),
                               atol=1e-6)


def test_dp_session_refuses_an_indivisible_batch(weights):
    with pytest.raises(ValueError, match="divisible"):
        InferenceSession("model", weights[0], NUM_POINT, batch_size=6,
                         data_parallel=4, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            InferenceSession("model", weights[0], NUM_POINT, batch_size=8,
                             data_parallel=2)


def test_dp_session_from_bundle(one, tmp_path):
    bundle = one.export_bundle(str(tmp_path / "bundle"))
    dp = InferenceSession.from_bundle(bundle, batch_size=4, data_parallel=2,
                                      devices=["cpu", "cpu"])
    assert len(dp.devices) == 2
    batch = _clouds(5, seed=11)
    np.testing.assert_allclose(dp.reconstruct(batch), one.reconstruct(batch),
                               **TOL)


def test_point_server_serves_a_dp_session(weights, one):
    dp = InferenceSession("model", weights[0], NUM_POINT, batch_size=4,
                          data_parallel=2, devices=["cpu", "cpu"])
    server = PointServer(dp, port=0, max_delay_ms=1.0)
    server.start()
    try:
        with PointClient("127.0.0.1", server.port) as c:
            for n, seed in ((3, 12), (1, 13), (7, 14)):
                pts = _clouds(n, seed)
                np.testing.assert_allclose(c.reconstruct(pts),
                                           one.reconstruct(pts), **TOL)
            emb = c.embed(_clouds(2, 15))
            np.testing.assert_allclose(c.decode(emb), one.decode(emb), **TOL)
    finally:
        server.stop()


def test_cli_serve_data_parallel_flag(weights):
    parse = cli_serve.build_parser().parse_args
    assert parse(["--model_path", weights[0]]).data_parallel is None
    args = parse(["--model_path", weights[0], "--num_point", str(NUM_POINT),
                  "--batch_size", "4", "--data_parallel", "2", "--device",
                  "cpu"])
    session, _ = cli_serve.build_server(args)
    assert session.devices == [torch.device("cpu")] * 2
