"""The port's roofline (utils/roofline.py), the twin of JAX
tests/test_roofline.py, on the CPU:

- the hardware-independent counts equal the JAX module's exactly, for
  every registry config at (32, 2048), (8, 1024) and (1, 2048): forward,
  decoder and deconv flops, the stage geometry, the encoder's MACs per
  point and the loss kernels' pair counts;
- the executed step's matmul flops differ from JAX's 3 x forward by
  exactly conv5's dense backward less K4's, conv1's input gradient and
  ``head_stats``' f32 matmuls (and conv1-4's under moment_stats);
- ``kernel_bound`` reproduces each bound of PERF.md's kernel table to
  the digits printed there, at the shapes chip_smoke.py passes (K4 at
  the distinct argmax rows the chip run printed);
- ``roofline_report``'s composition with hand-made costs (the composed
  bound of a kernel-dominated step, none for an empty cost, JSON output);
- ``StepCost``: a bare ``nn_distance`` and ``emd_cost`` count exactly
  their kernel's bound (no plain-version op), the dense Chamfer op by op,
  and a ``model`` f32 step at B=4, N=256 counts the same twice with its
  matmul flops equal to ``step_matmul_flops``.
"""

import json

import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.utils import roofline as jr
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.ops import chamfer, emd
from pointnet_autoencoder_tpu_torch.train import schedules
from pointnet_autoencoder_tpu_torch.train.state import (TrainState,
                                                        make_optimizer)
from pointnet_autoencoder_tpu_torch.utils import roofline

torch.set_num_threads(2)

CONFIGS = ("model", "model_cpu", "model_emd", "model_upconv",
           "model_fc_upconv", "model_hierachy")
SHAPES = ((32, 2048), (8, 1024), (1, 2048))


# -- hardware-independent counts ----------------------------------------------


@pytest.mark.parametrize("config", CONFIGS)
def test_counts_equal_jax(config):
    assert roofline._ENCODER_CHANNELS == jr._ENCODER_CHANNELS
    assert roofline._UPCONV_STAGES == jr._UPCONV_STAGES
    assert roofline._FC_UPCONV_STAGES == jr._FC_UPCONV_STAGES
    assert 2 * roofline.ENCODER_MACS_PER_POINT == sum(
        2 * a * b for a, b in zip(jr._ENCODER_CHANNELS[:-1],
                                  jr._ENCODER_CHANNELS[1:]))
    for batch, n in SHAPES:
        assert (roofline._decoder_flops(config, n)
                == jr._decoder_flops(config, n))
        assert (roofline.network_matmul_flops(batch, n, config)
                == jr.network_matmul_flops(batch, n, config))
    assert roofline._deconv_flops(
        roofline._UPCONV_STAGES, 1, 2, 512) == 546_308_096.0
    for stages, hw in ((roofline._UPCONV_STAGES, (1, 2)),
                       (roofline._FC_UPCONV_STAGES, (1, 1))):
        assert (roofline._deconv_flops(stages, *hw, 512)
                == jr._deconv_flops(stages, *hw, 512))


# JAX's cost per pair of each loss kernel call: its chamfer_vpu_ops charge
# both directions, its emd_vpu_ops every level.
JAX_PAIR_COST = {"nn_distance": 2 * jr._CHAMFER_FWD_OPS_PER_PAIR,
                 "nn_distance_grad": 2 * jr._CHAMFER_BWD_OPS_PER_PAIR,
                 "emd_forward": jr._EMD_LEVELS * jr._EMD_OPS_PER_PAIR_LEVEL}


@pytest.mark.parametrize("config", [c for c in CONFIGS if c != "model_cpu"])
def test_loss_pair_counts_equal_jax(config):
    """The loss kernels each step runs, by their pairs, cost JAX's loss
    budget exactly at JAX's per-pair costs (model_cpu's dense Chamfer has
    no kernel in the port; JAX charged it as model)."""
    for batch, n in SHAPES:
        calls = roofline.loss_kernel_calls(config, batch, n)
        ops = sum(JAX_PAIR_COST[k] * s["b"] * s["n"] * s["m"]
                  for k, s in calls)
        want = jr.step_floor_ms(config, batch, n)["loss_vpu_ms"] \
            * jr.VPU_OPS / 1e3
        assert ops == pytest.approx(want, rel=1e-12)
    assert roofline.loss_kernel_calls("model_cpu", 32, 2048) == []


@pytest.mark.parametrize("config", CONFIGS)
def test_step_flops_are_jax_less_what_the_step_skips(config):
    for batch, n in SHAPES:
        p = batch * n
        step = roofline.step_matmul_flops(config, batch, n)
        head = roofline.head_stats_flops(p, 128, 1024)
        want = (jr.network_matmul_flops(batch, n, config)
                - 4.0 * p * 128 * 1024 + 4.0 * batch * 1024 * 128
                - 2.0 * p * 3 * 64 + head)
        assert step["network"] + step["stats"] == pytest.approx(
            want, rel=1e-15)
        assert step["stats"] == head
        moment = roofline.step_matmul_flops(config, batch, n,
                                            moment_stats=True)
        extra = (roofline.head_stats_flops(p, 3, 64, input_grad=False)
                 + roofline.head_stats_flops(p, 64, 64)
                 + roofline.head_stats_flops(p, 64, 64)
                 + roofline.head_stats_flops(p, 64, 128))
        assert moment["stats"] == head + extra
        assert moment["network"] == step["network"]


def test_head_stats_flops_hand_count():
    # P = 65,536 and C = 128: x^T x is 2.1 GFLOP forward, 4.3 backward.
    p, c, f = 65536, 128, 1024
    assert roofline.head_stats_flops(p, c, f) == (
        6 * p * c * c + 6 * c * f + 6 * c * c * f)
    assert 2 * p * c * c == pytest.approx(2.147e9, rel=1e-3)
    assert roofline.head_stats_flops(p, c, f, input_grad=False) == (
        2 * p * c * c + 4 * c * f + 4 * c * c * f)


def test_unbudgeted_config_raises():
    with pytest.raises(ValueError, match="no analytic budget"):
        roofline.step_floor_ms("nonexistent", 32, 2048)
    with pytest.raises(ValueError, match="no kernel"):
        roofline.kernel_bound("nonexistent", b=1, n=1)
    with pytest.raises(ValueError, match="needs rows"):
        roofline.kernel_bound("fused_head_bwd", b=1, n=8, dtype="f32")
    with pytest.raises(ValueError, match="no peak"):
        roofline.peak_flops(torch.float16)


# -- kernel bounds ------------------------------------------------------------

# K4's distinct argmax rows of chip_smoke.py's seeded head inputs, as its
# timings (B=32, N=2048) and point_parallel (shard, N=1024) lines print
# them on the card.
K4_ROWS = {"bf16": 21366, "f32": 21542, "shard": 17201}

# (kernel, shape, PERF.md's bound in ms as printed, bound by)
BOUNDS = [
    ("nn_distance", dict(b=32, n=2048, m=2048), "0.0200", "operations"),
    ("nn_distance", dict(b=1, n=2048, m=2048), "0.00063", "operations"),
    ("nn_distance", dict(b=32, n=64, m=2048), "0.00063", "operations"),
    ("nn_distance", dict(b=32, n=1024, m=2048), "0.01002", "operations"),
    ("nn_distance_grad", dict(b=32, n=2048, m=2048), "0.0013", "bytes"),
    ("fused_head_fwd", dict(b=32, n=2048, dtype="bf16"), "0.0174",
     "operations"),
    ("fused_head_fwd", dict(b=32, n=2048, dtype="f32"), "0.2564",
     "operations"),
    ("fused_head_fwd", dict(b=32, n=1024, dtype="bf16"), "0.00869",
     "operations"),
    ("fused_head_bwd", dict(b=32, n=2048, dtype="bf16",
                            rows=K4_ROWS["bf16"]), "0.0070", "bytes"),
    ("fused_head_bwd", dict(b=32, n=2048, dtype="f32", rows=K4_ROWS["f32"]),
     "0.0137", "bytes"),
    ("fused_head_bwd", dict(b=32, n=1024, dtype="bf16",
                            rows=K4_ROWS["shard"]), "0.00413", "bytes"),
    ("fused_encoder_eval", dict(b=32, n=2048, dtype="f32"), "0.2888",
     "operations"),
    ("fused_encoder_eval", dict(b=32, n=2048, dtype="bf16"), "0.0196",
     "operations"),
    ("fused_encoder_eval", dict(b=1, n=2048, dtype="f32"), "0.00903",
     "operations"),
    ("fused_encoder_eval", dict(b=32, n=1024, dtype="bf16"), "0.00978",
     "operations"),
    ("emd_forward", dict(b=32, n=2048, m=2048), "0.3966", "operations"),
    ("batch_norm_fwd", dict(rows=65536, c=64, dtype="bf16"), "0.00501",
     "bytes"),
    ("batch_norm_bwd", dict(rows=65536, c=64, dtype="bf16"), "0.00751",
     "bytes"),
    ("batch_norm_fwd", dict(rows=262144, c=128, dtype="bf16"), "0.04007",
     "bytes"),
    ("batch_norm_bwd", dict(rows=262144, c=128, dtype="bf16"), "0.06010",
     "bytes"),
]


@pytest.mark.parametrize("kernel,shape,want,by", BOUNDS)
def test_kernel_bound_reproduces_the_table(kernel, shape, want, by):
    kb = roofline.kernel_bound(kernel, **shape)
    assert f"{kb['bound_ms']:.{len(want) - 2}f}" == want
    assert kb["bound_by"] == by
    assert kb["bound_ms"] == max(
        kb["ops"] / (roofline.PEAK_BF16_FLOPS if shape.get("dtype") == "bf16"
                     else roofline.PEAK_F32_FLOPS),
        kb["bytes"] / roofline.PEAK_BYTES_PER_S,
        roofline.EMD_SFU_PER_PAIR * shape["b"] * shape["n"] * shape["m"]
        / roofline.PEAK_SFU_PER_S if kernel == "emd_forward" else 0.0) * 1e3


def test_kernel_bound_takes_torch_dtypes():
    assert (roofline.kernel_bound("fused_head_fwd", b=2, n=64,
                                  dtype=torch.bfloat16)
            == roofline.kernel_bound("fused_head_fwd", b=2, n=64,
                                     dtype="bf16"))


def test_distinct_rows():
    argmax = torch.tensor([[0, 0, 3], [1, 2, 1]], dtype=torch.int32)
    assert roofline.distinct_rows(argmax, 4) == 4  # rows 0, 3, 5, 6


# -- floors -------------------------------------------------------------------


def test_model_step_floor_terms():
    """bf16 B=32, N=2048: about 25 GFLOP of network matmuls (0.026 ms on
    the tensor cores), 6.5 GFLOP of f32 statistics (0.1 ms) and K1 + K2
    (0.021 ms)."""
    f = roofline.step_floor_ms("model", 32, 2048)
    flops = roofline.step_matmul_flops("model", 32, 2048)
    assert flops["network"] == pytest.approx(25.3e9, rel=0.01)
    assert f["matmul_ms"] == pytest.approx(0.0256, rel=0.01)
    assert f["stats_ms"] == pytest.approx(0.0972, rel=0.01)
    assert f["loss_ms"] == pytest.approx(
        roofline.kernel_bound("nn_distance", b=32, n=2048, m=2048)["bound_ms"]
        + roofline.kernel_bound("nn_distance_grad", b=32, n=2048,
                                m=2048)["bound_ms"])
    assert f["floor_ms"] == f["matmul_ms"] + f["stats_ms"] + f["loss_ms"]
    f32 = roofline.step_floor_ms("model", 32, 2048, dtype="f32")
    assert f32["matmul_ms"] == pytest.approx(
        f["matmul_ms"] * roofline.PEAK_BF16_FLOPS / roofline.PEAK_F32_FLOPS)
    assert f32["stats_ms"] == f["stats_ms"]


def test_all_registry_configs_have_floors():
    floors = {c: roofline.step_floor_ms(c, 32, 2048) for c in CONFIGS}
    for c, f in floors.items():
        assert f["floor_ms"] > 0, c
    assert floors["model_upconv"]["matmul_ms"] > floors["model"]["matmul_ms"]
    assert (floors["model_fc_upconv"]["matmul_ms"]
            > floors["model"]["matmul_ms"])
    assert floors["model_hierachy"]["loss_ms"] > floors["model"]["loss_ms"]
    assert floors["model_upconv"]["loss_ms"] == floors["model"]["loss_ms"]
    # K6 dominates model_emd's; model_cpu's dense matrix is written and
    # read: 2 * 4 * B * N * M bytes.
    assert floors["model_emd"]["loss_ms"] > 10 * floors["model"]["loss_ms"]
    assert floors["model_cpu"]["loss_ms"] == pytest.approx(
        8.0 * 32 * 2048 * 2048 / roofline.PEAK_BYTES_PER_S * 1e3)


def test_forward_floor_follows_the_kernel_routes():
    p = 32 * 2048
    conv1 = 2.0 * p * 3 * 64
    enc = 2.0 * p * roofline.ENCODER_MACS_PER_POINT
    dec = 32 * roofline._decoder_flops("model", 2048)
    epilogue = 3.0 * p * (64 + 64 + 64 + 128) + 2.0 * p * 1024
    bf16 = roofline.forward_floor_ms("model", 32, 2048, dtype="bf16")
    assert bf16 == pytest.approx(
        (conv1 / roofline.PEAK_F32_FLOPS
         + (enc - conv1 + dec) / roofline.PEAK_BF16_FLOPS
         + epilogue / roofline.PEAK_F32_FLOPS) * 1e3)
    f32 = roofline.forward_floor_ms("model", 32, 2048)
    assert f32 == pytest.approx((enc + dec + epilogue)
                                / roofline.PEAK_F32_FLOPS * 1e3)
    # Linear in the batch.
    assert roofline.forward_floor_ms("model", 512, 2048) == pytest.approx(
        16 * f32)


def test_emd_streaming_floor():
    b1 = roofline.emd_streaming_floor_ms(1, 16384, 16384)
    assert roofline.emd_streaming_floor_ms(2, 16384, 16384) == \
        pytest.approx(2 * b1)
    # Both passes pay d2, so it sits above K6's own bound.
    assert (roofline.emd_streaming_floor_ms(1, 2048, 2048)
            > roofline.kernel_bound("emd_forward", b=1, n=2048,
                                    m=2048)["bound_ms"])


# -- the report ---------------------------------------------------------------


def _cost(nbytes, flops=0.0):
    cost = roofline.StepCost()
    cost.ops[("model", "aten.fake")] = [1, nbytes, flops]
    return cost


def test_report_without_a_cost_is_json():
    r = roofline.roofline_report("model", 32, 2048, 3.27)
    parsed = json.loads(json.dumps(r))
    assert set(parsed) == {"measured_ms", "analytic_floor_ms", "matmul_ms",
                           "stats_ms", "loss_ms", "pct_of_roofline", "mfu"}
    assert r["mfu"] == r["matmul_ms"] / 3.27
    assert r["pct_of_roofline"] == 100.0 * r["analytic_floor_ms"] / 3.27
    served = roofline.roofline_report("model", 32, 2048, 0.2, dtype="bf16",
                                      serving=True)
    assert set(served) == {"measured_ms", "analytic_floor_ms", "matmul_ms",
                           "epilogue_ms", "pct_of_roofline", "mfu"}
    assert served["analytic_floor_ms"] == roofline.forward_floor_ms(
        "model", 32, 2048, "bf16")


def test_whole_program_bound_from_a_cost():
    cost = _cost(2.412e9, 15.37e9)
    r = roofline.roofline_report("model", 32, 2048, 3.27, cost=cost)
    assert r["hbm_bytes_GB"] == pytest.approx(2.412)
    assert r["program_flops_G"] == pytest.approx(15.37)
    assert r["mem_bound_ms"] == pytest.approx(
        2.412e9 / roofline.PEAK_BYTES_PER_S * 1e3)
    # The memory bound binds (it exceeds the floor): no composition.
    assert "composed_bound_ms" not in r
    assert r["bound_ms"] == r["mem_bound_ms"]
    assert r["pct_of_bound"] == r["pct_of_mem_bound"]
    json.dumps(r)
    # An empty cost gives no memory bound.
    assert roofline.whole_program_bound(roofline.StepCost()) is None
    r2 = roofline.roofline_report("model", 32, 2048, 3.0,
                                  cost=roofline.StepCost())
    assert "mem_bound_ms" not in r2 and "bound_ms" not in r2


def test_binding_bound_for_kernel_dominated_step():
    """A floor above the memory bound composes serially with it."""
    cost = _cost(0.2e9)
    r = roofline.roofline_report("model_emd", 32, 2048, 5.5, cost=cost)
    assert r["analytic_floor_ms"] > r["mem_bound_ms"]
    assert r["composed_bound_ms"] == pytest.approx(
        r["analytic_floor_ms"] + r["mem_bound_ms"])
    assert r["bound_ms"] == r["composed_bound_ms"]
    assert r["pct_of_bound"] == pytest.approx(100 * r["bound_ms"] / 5.5)
    json.dumps(r)


# -- StepCost -----------------------------------------------------------------


def _clouds(b, n, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(b, n, 3).astype(np.float32))


def test_charge_outside_a_counter_is_free():
    assert roofline.charge("nn_distance", b=1, n=2, m=2) is \
        roofline.region("optimizer")


@pytest.mark.parametrize("kernel", ["nn_distance", "emd_forward"])
def test_a_bare_kernel_call_counts_its_bound(kernel):
    x1, x2 = _clouds(2, 40, 0), _clouds(2, 56, 1)
    with roofline.StepCost() as cost:
        if kernel == "nn_distance":
            chamfer.nn_distance(x1, x2)
        else:
            emd.emd_cost(x1, x2)
    kb = roofline.kernel_bound(kernel, b=2, n=40, m=56)
    assert cost.ops == {}
    assert cost.kernels == {kernel: {"calls": 1, "ops": kb["ops"],
                                     "bytes": kb["bytes"]}}
    assert cost.bytes == kb["bytes"] and cost.flops == kb["ops"]


def test_the_dense_chamfer_counts_op_by_op():
    x1, x2 = _clouds(2, 40, 0), _clouds(2, 56, 1)
    with roofline.StepCost() as cost:
        chamfer.nn_distance_dense(x1, x2)
    assert cost.kernels == {}
    # The (B, N, M) matrix is written and read at least once.
    assert cost.bytes > 2 * 4 * 2 * 40 * 56


def _model_step_cost(config, batch, num_point):
    spec = get_model_spec(config)
    model = spec.make(num_point,
                      generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer("adam", model.parameters()),
                       schedules.learning_rate_schedule(1e-3, 0.7, 32,
                                                        200000))
    x = _clouds(batch, num_point, 3)
    with roofline.StepCost() as cost:
        state.train_step(x, spec.loss_fn,
                         schedules.bn_momentum_schedule(32, 200000))
    return cost


def test_model_step_counts_the_same_twice_and_its_matmuls():
    first = _model_step_cost("model", 4, 256)
    again = _model_step_cost("model", 4, 256)
    assert first.summary() == again.summary()
    assert first.ops == again.ops
    want = roofline.step_matmul_flops("model", 4, 256)
    assert sum(first.matmul_flops.values()) == want["network"] + want["stats"]
    assert set(first.kernels) == {"nn_distance", "nn_distance_grad",
                                  "fused_head_fwd", "fused_head_bwd",
                                  "batch_norm_fwd", "batch_norm_bwd"}
    # Adam's update is its own part; no copy between devices.
    parts = first.summary()["parts"]
    assert set(parts) == {"model", "optimizer"}
    assert parts["optimizer"]["bytes"] > 0
    assert first.bytes == pytest.approx(
        parts["model"]["bytes"] + parts["optimizer"]["bytes"]
        + sum(k["bytes"] for k in first.kernels.values()))
