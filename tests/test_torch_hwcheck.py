"""The port's on-card parity harness (ops/hwcheck.py) and its numpy oracle
copy (ops/oracles.py), on the CPU.

The oracle copy is held bit-equal to the JAX package's ops/oracles.py on
the same numpy inputs. The harness runs its contracts, a scaled-down
large-N check, one fuzz draw and its CLI with --device cpu, where every
kernel's plain PyTorch version stands in for the kernel, as the JAX
package's tests/test_hwcheck.py smokes its harness on the CPU backend.
"""

import numpy as np
import pytest
import torch

import pointnet_autoencoder_tpu_torch.ops.hwcheck as hw
from pointnet_autoencoder_tpu.ops import oracles as joracles
from pointnet_autoencoder_tpu_torch.ops import fused_encoder, oracles

torch.set_num_threads(2)


def _clouds(seed, b=2, n=23, m=17, quantize=False):
    rng = np.random.RandomState(seed)
    x1 = rng.randn(b, n, 3).astype(np.float32)
    x2 = rng.randn(b, m, 3).astype(np.float32)
    if quantize:  # exact ties: the first minimum must win in both copies
        x1, x2 = np.round(x1 * 2.0) / 4.0, np.round(x2 * 2.0) / 4.0
    return x1, x2


def _oracle_args(name):
    x1, x2 = _clouds(7, quantize=name == "nn_distance_np")
    if name in ("nn_distance_np", "approx_match_np"):
        return (x1, x2)
    if name == "nn_distance_grad_np":
        _, i1, _, i2 = joracles.nn_distance_np(x1, x2)
        rng = np.random.RandomState(8)
        return (x1, x2, i1, i2, rng.randn(*i1.shape).astype(np.float32),
                rng.randn(*i2.shape).astype(np.float32))
    if name in ("match_cost_np", "match_cost_grad_np"):
        return (x1, x2, joracles.approx_match_np(x1, x2))
    if name == "fused_head_np":
        return hw._head_inputs(np.random.RandomState(9), 2, 11, 6, 8)
    if name == "fscore_np":
        return (x1, x2, 0.5)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "nn_distance_np", "nn_distance_grad_np", "approx_match_np",
    "match_cost_np", "match_cost_grad_np", "fused_head_np", "fscore_np"])
def test_oracle_copy_is_bit_equal_to_the_jax_package(name):
    args = _oracle_args(name)
    ours = getattr(oracles, name)(*args)
    theirs = getattr(joracles, name)(*args)
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _run_clean(fn, *args, **kwargs):
    before = len(hw._FAILURES)
    fn(*args, **kwargs)
    assert hw._FAILURES[before:] == [], hw._FAILURES[before:]


@pytest.mark.parametrize("contract", [
    "chamfer", "emd", "fused_head", "fused_encoder", "sp_point_sharded",
    "emd_route_boundary"])
def test_hwcheck_contracts_pass_on_the_cpu(contract):
    if contract == "chamfer":
        _run_clean(hw.check_chamfer, b=1, n=33, m=17, device="cpu")
    elif contract == "emd":
        _run_clean(hw.check_emd, b=1, n=24, m=16, device="cpu")
    elif contract == "fused_head":
        _run_clean(hw.check_fused_head, b=1, n=16, c=8, f=32, device="cpu")
    elif contract == "fused_encoder":
        _run_clean(hw.check_fused_encoder, b=1, n=16, device="cpu")
    elif contract == "sp_point_sharded":
        _run_clean(hw.check_sp_point_sharded, b=1, n=24, m=16, device="cpu")
        assert not torch.distributed.is_initialized()
    else:
        _run_clean(hw.check_emd_route_boundary, device="cpu")


def test_hwcheck_large_n_scaled_down():
    # The real run is N=M=16384 and the prime 12289 on the card; here the
    # same code paths (kernel-only Chamfer with tagged names, the EMD's
    # route and its streaming form) at CPU-sized shapes.
    _run_clean(hw.check_chamfer_large_n, b=1, n=40, m=28, device="cpu")
    _run_clean(hw.check_emd_large_n, b=1, n=40, m=28, device="cpu")
    _run_clean(hw.check_emd_large_prime_n, b=1, n=41, m=29, device="cpu")


def test_hwcheck_fuzz_one_draw(monkeypatch):
    # Small shapes: the real pool is sized for the card's kernels.
    monkeypatch.setattr(hw, "_FUZZ_POOL", [(1, 33, 17)])
    _run_clean(hw.fuzz, draws=1, device="cpu")


def test_fuzz_pool_keeps_the_jax_shapes_and_crosses_the_cuda_tiles():
    from pointnet_autoencoder_tpu.ops import hwcheck as jhw

    assert hw._FUZZ_POOL[:len(jhw._FUZZ_POOL)] == jhw._FUZZ_POOL
    ns = {n for _, n, _ in hw._FUZZ_POOL}
    ms = {m for _, _, m in hw._FUZZ_POOL}
    sizes = ns | ms
    assert {255, 257} <= ns  # K1's 256 queries per block
    assert {127, 129} <= ms  # K1's 128 candidates per warp step
    assert {255, 257} <= ns and 257 in ms  # K2's 256 rows of either cloud
    assert {127, 129, 1023, 1025} <= sizes  # K6's 128 owned, 1024 streamed
    # K5 is not fuzzed: the default sweep takes +-1 around its tiles.
    assert {63, 65, 255, 257} <= set(hw._ENCODER_POINTS)


@pytest.mark.parametrize("n", [16, 63, 257])
def test_encoder_bf16_tolerance_holds_the_plain_route(n):
    """The bf16 route's plain version (the kernel's arithmetic in another
    f32 order) lands within the derived tolerance over several seeds, so
    the check does not fail on rounding alone; the tolerance is a few
    percent of each output, not a blanket one."""
    for seed in range(3, 8):
        rng = np.random.RandomState(seed)
        pts = rng.randn(2, n, 3).astype(np.float32)
        layers = hw._encoder_layers(rng)
        ref, tol = hw.encoder_bf16_walk(pts, layers)
        chain = fused_encoder.fold_layers(
            [tuple(map(torch.from_numpy, layer)) for layer in layers],
            eps=1e-3, dtype=torch.bfloat16)
        out = fused_encoder.fused_encoder_eval(torch.from_numpy(pts),
                                               chain).numpy()
        assert np.all(np.abs(out - ref) <= tol)
        live = ref > 1.0
        assert np.median(tol[live] / ref[live]) < 0.2


def test_hwcheck_main_cli(capsys):
    rc = hw.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.splitlines()[0] == "device: cpu"
    assert "all hardware parity checks passed" in out


def test_hwcheck_main_needs_a_card_by_default_and_refuses_the_xla_cache():
    with pytest.raises(NotImplementedError, match="compilation_cache_dir"):
        hw.main(["--device", "cpu", "--compilation_cache_dir", "/nowhere"])
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        hw.main([])
