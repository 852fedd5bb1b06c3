"""The port's ``ops/benchmarks.py`` on the CPU path (the kernels' plain
versions, eager) against a JAX gradient-descent loop written here: the
same numpy clouds, JAX ``chamfer.nn_distance(impl="xla")`` and
``emd.emd_cost``, the same learning rate and step count (one step before
the clock, then ``steps``; the final loss is the last step's), at the
``--quick`` sizes. Final loss within rtol 1e-5 for Chamfer (f32 sums of
the same distances in another order) and 1e-3 for the EMD (the
reference's tolerance for the approximate matching).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.ops import chamfer as jchamfer
from pointnet_autoencoder_tpu.ops import emd as jemd
from pointnet_autoencoder_tpu_torch.ops import benchmarks

torch.set_num_threads(2)


def _jax_gd(loss, p, tgt, steps, lr):
    @jax.jit
    def step(p, tgt):
        value, grad = jax.value_and_grad(lambda q: loss(q, tgt))(p)
        return p - lr * grad, value

    p, value = step(jnp.asarray(p), jnp.asarray(tgt))
    for _ in range(steps):
        p, value = step(p, jnp.asarray(tgt))
    return float(value)


def _chamfer_sum(q, tgt):
    d1, _, d2, _ = jchamfer.nn_distance(q, tgt, impl="xla")
    return jnp.sum(d1) + jnp.sum(d2)


def test_chamfer_gd_matches_a_jax_loop():
    b, n, m, steps, lr = 4, 2048, 512, 20, 0.05
    got = benchmarks.bench_chamfer_gd(b=b, n=n, m=m, steps=steps, lr=lr,
                                      device="cpu")
    xyz1 = np.random.RandomState(0).randn(b, n, 3).astype(np.float32)
    xyz2 = np.random.RandomState(1).randn(b, m, 3).astype(np.float32)
    want = _jax_gd(_chamfer_sum, xyz1, xyz2, steps, lr)
    np.testing.assert_allclose(got["final_loss"], want, rtol=1e-5)
    assert got["config"] == f"chamfer GD b{b} n{n} m{m}"
    assert got["ms_per_step"] > 0


def test_emd_gd_matches_a_jax_loop():
    b, n, m, steps, lr = 2, 256, 256, 5, 0.01
    got = benchmarks.bench_emd_gd(b=b, n=n, m=m, steps=steps, lr=lr,
                                  device="cpu")
    xyz1 = np.random.RandomState(0).rand(b, n, 3).astype(np.float32)
    xyz2 = np.random.RandomState(1).rand(b, m, 3).astype(np.float32)
    want = _jax_gd(lambda q, t: jnp.sum(jemd.emd_cost(q, t)), xyz1, xyz2,
                   steps, lr)
    np.testing.assert_allclose(got["final_loss"], want, rtol=1e-3)
    assert got["config"] == f"emd GD b{b} n{n} m{m}"


def test_main_quick_on_the_cpu_prints_the_device_and_both_runs(capsys):
    assert benchmarks.main(["--quick", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    assert lines[1].startswith("chamfer GD b4 n2048 m512: ")
    assert lines[2].startswith("emd GD b2 n256 m256: ")
    assert len(lines) == 3


def test_the_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        benchmarks.main(["--quick"])
