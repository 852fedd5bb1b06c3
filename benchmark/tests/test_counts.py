"""The frozen counts equal the port's ``utils/roofline.py`` at the cells'
shapes, as it stood when the benchmark was defined."""

import pytest

from benchmark import counts
from pointnet_autoencoder_tpu_torch.utils import roofline

SHAPES = [dict(b=32, n=2048), dict(b=128, n=2048), dict(b=512, n=2048)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"b{s['b']}")
@pytest.mark.parametrize("kernel", ["nn_distance", "nn_distance_grad",
                                    "emd_forward", "fused_head_fwd",
                                    "fused_head_bwd", "fused_encoder_eval"])
def test_kernel_bound(kernel, shape):
    kw = dict(shape)
    if kernel in ("nn_distance", "nn_distance_grad", "emd_forward"):
        kw["m"] = kw["n"]
    if kernel.startswith(("fused_head", "fused_encoder")):
        kw["dtype"] = "bf16"
    if kernel == "fused_head_bwd":
        kw["rows"] = 20000
    assert counts.kernel_bound(kernel, **kw) == roofline.kernel_bound(
        kernel, **kw)


@pytest.mark.parametrize("config", ["model", "model_emd", "model_cpu",
                                    "model_upconv", "model_fc_upconv",
                                    "model_hierachy"])
@pytest.mark.parametrize("batch", [32, 128])
def test_step_flops(config, batch):
    assert counts.step_matmul_flops(config, batch, 2048) == \
        roofline.step_matmul_flops(config, batch, 2048)
    assert counts.network_matmul_flops(batch, 2048, config) == \
        roofline.network_matmul_flops(batch, 2048, config)


def test_forward_flops_and_peaks():
    budget = roofline._forward_budget("model", 512, 2048, "bf16")
    flops = counts.forward_matmul_flops("model", 512, 2048)
    conv1 = 2.0 * 512 * 2048 * 3 * 64
    assert budget["matmul_ms"] == pytest.approx(
        (conv1 / counts.PEAK_F32_FLOPS
         + (flops - conv1) / counts.PEAK_BF16_FLOPS) * 1e3, rel=1e-12)
    assert (counts.PEAK_BF16_FLOPS, counts.PEAK_F32_FLOPS,
            counts.PEAK_BYTES_PER_S, counts.PEAK_SFU_PER_S) == (
        roofline.PEAK_BF16_FLOPS, roofline.PEAK_F32_FLOPS,
        roofline.PEAK_BYTES_PER_S, roofline.PEAK_SFU_PER_S)
    # The step's matmul flops at B=32: 25.3 GFLOP.
    assert counts.step_matmul_flops("model", 32, 2048)["network"] == \
        pytest.approx(25.3e9, rel=0.01)
