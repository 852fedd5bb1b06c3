"""Port's whole-encoder eval op (pointnet_autoencoder_tpu_torch/ops/
fused_encoder.py, plain version on the CPU) against the JAX package's
fused_encoder_eval run in Pallas interpret mode, and against the JAX
layer-by-layer eval encoder where N has no tile divisor.

Tolerances are the JAX test's own (tests/test_fused_encoder.py): f32
rtol/atol 1e-5, bf16 3e-2. BN statistics are random with some negative
gammas, so the min branch of the last fold runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.nn.encoder import PointNetEncoder as JEncoder
from pointnet_autoencoder_tpu.ops import fused_encoder as jfe
from pointnet_autoencoder_tpu_torch.csrc import build
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.nn.encoder import PointNetEncoder
from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe

torch.set_num_threads(2)

EPS = 1e-3
WIDTHS = (64, 64, 64, 128, 1024)
TOL = {"f32": 1e-5, "bf16": 3e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _layers(widths=WIDTHS, seed=0):
    rng = np.random.RandomState(seed)
    layers, c = [], 3
    for f in widths:
        sign = np.where(rng.rand(f) < 0.3, -1.0, 1.0)
        layers.append(tuple(np.asarray(x, np.float32) for x in (
            rng.randn(c, f) * np.sqrt(2.0 / c), 0.1 * rng.randn(f),
            sign * (1.0 + 0.2 * rng.randn(f)), 0.1 * rng.randn(f),
            0.05 * rng.randn(f), 1.0 + 0.1 * rng.rand(f))))
        c = f
    return layers


def _port_eval(pts, layers, dtype):
    chain = fe.fold_layers([tuple(map(torch.from_numpy, lay))
                            for lay in layers], eps=EPS, dtype=dtype)
    return fe.fused_encoder_eval(torch.from_numpy(pts), chain).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("widths", [WIDTHS, (32, 128)])
def test_matches_jax_kernel_interpret(dtype, widths):
    layers = _layers(widths, seed=1)
    pts = np.random.RandomState(2).randn(2, 64, 3).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = jfe.fused_encoder_eval(
        jnp.asarray(pts), [tuple(map(jnp.asarray, lay)) for lay in layers],
        eps=EPS, dtype=jdt, interpret=True)
    got = _port_eval(pts, layers, tdt)
    assert got.dtype == np.float32 and got.shape == (2, widths[-1])
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    # The negative gammas took the min branch for some channels.
    assert (np.asarray(layers[-1][2]) < 0).any()


def _jax_encoder_variables(n, seed):
    pts = jnp.zeros((2, n, 3), jnp.float32)
    variables = JEncoder(head_impl="xla").init(
        jax.random.PRNGKey(seed), pts, train=False, bn_momentum=0.9)
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "gamma":
            return (a * np.where(rng.rand(*a.shape) < 0.3, -1, 1)
                    * (1 + 0.2 * rng.rand(*a.shape))).astype(np.float32)
        if name == "var":
            return (a + 0.5 * rng.rand(*a.shape)).astype(np.float32)
        if a.ndim == 1:
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb,
                                            jax.device_get(variables))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [37, 64])
def test_encoder_module_matches_jax_layered_eval(dtype, n):
    """N=37 has no 8-multiple tile, so the JAX package itself can only run
    it layer by layer; the port's fused op takes every N."""
    variables = _jax_encoder_variables(n, seed=3)
    jdt, tdt = DTYPES[dtype]
    pts = np.random.RandomState(4).randn(3, n, 3).astype(np.float32)
    want = JEncoder(dtype=jdt, head_impl="xla").apply(
        variables, jnp.asarray(pts), train=False, bn_momentum=0.9)
    enc = PointNetEncoder(dtype=tdt)
    sd = from_flax_variables(variables)
    enc.load_state_dict(sd)
    with torch.inference_mode():
        got = enc(torch.from_numpy(pts))
    assert got.dtype == tdt and got.shape == (3, 1024)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_fused_equals_layered_port_modules():
    """The fused op against the port's own PointMLP layers + max (f32)."""
    variables = _jax_encoder_variables(40, seed=5)
    enc = PointNetEncoder()
    enc.load_state_dict(from_flax_variables(variables))
    x = torch.from_numpy(
        np.random.RandomState(6).randn(2, 40, 3).astype(np.float32))
    with torch.inference_mode():
        layered = x
        for layer in enc.layers():
            layered = layer(layered)
        np.testing.assert_allclose(enc(x).numpy(),
                                   layered.amax(dim=1).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_plain_extrema_and_fold():
    layers = _layers(seed=7)
    chain = fe.fold_layers([tuple(map(torch.from_numpy, lay))
                            for lay in layers], eps=EPS)
    assert chain.widths == fe.KERNEL_WIDTHS
    assert chain.affine.shape == (2 * (64 + 64 + 64 + 128),)
    for i, lay in enumerate(layers[:-1]):
        want = fe.fold_affine(*map(torch.from_numpy, lay[1:]), eps=EPS)
        for got, w in zip(chain.inner_rows(i), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
    pts = torch.from_numpy(
        np.random.RandomState(8).randn(2, 19, 3).astype(np.float32))
    ymax, ymin = fe.encoder_extrema_plain(pts, chain)
    assert torch.all(ymax >= ymin)
    s, h = chain.last_scale, chain.last_shift
    want = torch.clamp_min(torch.maximum(ymax * s + h, ymin * s + h), 0.0)
    torch.testing.assert_close(fe.fused_encoder_eval(pts, chain), want,
                               rtol=0, atol=0)


def test_train_mode_and_cuda_paths_raise_here(monkeypatch, tmp_path):
    """Train mode now runs (on the CPU through the plain versions; its
    values are held to JAX in test_torch_train.py); the CUDA paths still
    raise here."""
    enc = PointNetEncoder()
    out = enc(torch.randn(1, 8, 3), train=True, bn_momentum=0.5)
    assert out.shape == (1, 1024) and torch.isfinite(out).all()
    chain = enc.fold()
    with pytest.raises(ValueError, match="CUDA"):
        fe.encoder_extrema_cuda(torch.zeros(1, 8, 3), chain)
    # Without nvcc the build raises; nothing falls back to the plain path.
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("fused_encoder", fe._SIGNATURES)
