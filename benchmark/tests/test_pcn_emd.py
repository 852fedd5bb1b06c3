"""PCN's files in the benchmark on the CPU: its frozen counts
(``counts_pcn_emd.py``) equal the port's ``utils/roofline.py`` at the
cell's shapes, its reference imports nothing of the program, and its
driver's program matches the reference at the small preset in f32."""

import pytest

from benchmark import counts_pcn_emd, harness
from benchmark.tests import small, test_no_jax
from pointnet_autoencoder_tpu_torch.utils import roofline

CELL = "train.pcn_emd.b32"


@pytest.mark.parametrize("batch", [2, 32, 128])
def test_step_flops_equal_the_port_s(batch):
    assert counts_pcn_emd.step_matmul_flops(batch, 2048, 1024, 4) == \
        roofline.pcn_step_matmul_flops(batch, 2048, 1024, 4)


def test_counts_at_the_cell_s_shapes():
    # 2.81 TFLOP a step, 88% of it in the folding; K1 and K2 at
    # (32, 16384, 16384) bound by K1's 10 operations a pair, K6 at
    # (32, 1024, 1024).
    flops = counts_pcn_emd.step_matmul_flops(32, 2048, 1024, 4)
    assert flops["network"] == pytest.approx(2.810e12, rel=1e-3)
    assert flops["folding"] / flops["network"] == pytest.approx(0.885,
                                                               abs=0.005)
    k1 = harness.load_module(harness.ROOT / "counts.py").kernel_bound(
        "nn_distance", b=32, n=16384, m=16384)
    assert k1["ops"] == 10.0 * 32 * 16384 * 16384
    assert counts_pcn_emd.chamfer_bound_ms(32, 16384, 16384) > k1["bound_ms"]
    assert counts_pcn_emd.emd_bound_ms(32, 1024) > 0


def test_reference_imports_nothing_of_the_program():
    imports = "import benchmark.reference.pcn_emd"
    assert test_no_jax._loaded(imports, harness.FORBIDDEN
                               + ("pointnet_autoencoder_tpu_torch",)) == ""


def test_program_matches_the_reference_in_f32():
    run = small.cpu_run(CELL, 2 ** 33 + 13, compute_dtype="float32")
    driver = small.driver(CELL)
    prog = driver.PCNProgram(run)
    ref = driver.reference_readings(run.config, prog.variables, prog.first,
                                    prog.start, prog.resumed)
    found = driver.compared(prog.readings, ref)
    # The same f32 functions on both sides, summed in other orders.
    assert found["loss_gap"][0] < 1e-5
    assert found["loss3_gap"][0] < 1e-5
    assert found["grad_diff"][0] < 1e-4
    assert found["grad3_diff"][0] < 1e-4
    assert found["change_gap"][0] < 1e-3
