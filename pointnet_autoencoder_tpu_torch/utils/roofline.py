"""Analytic budgets of one NVIDIA H100, and the cost of one eager step.

Counterpart of ``pointnet_autoencoder_tpu/utils/roofline.py``. The flop,
pair and byte accounting carries over unchanged; the peaks and the costs
per pair are the card's and its kernels':

- Peaks: the published dense peaks of one H100 SXM at its 700 W power
  limit (a card set lower runs slower under load; ``nvidia-smi
  --query-gpu=name,power.limit`` says which). bf16 on the tensor cores
  989 TFLOP/s; TF32 495 TFLOP/s, named and not used, since the port turns
  TF32 off (full f32 products, the reference's HIGHEST precision); f32
  outside the tensor cores 67 TFLOP/s; HBM 3.35 TB/s; the special-function
  units 16 results per SM per clock, 132 SMs at 1980 MHz. An f32
  operation that is not a fused multiply-add is charged as one flop.
- ``kernel_bound(name, ...)``: each hand-written kernel (K1-K7), the least
  time the card could take for its function: the larger of its operations
  over its type's peak and its bytes (each input read once, each output
  written once) over the HBM rate. Where the work depends on the data
  (K4's distinct argmax rows), the caller passes what these inputs need.
- ``pcn_step_matmul_flops``: the matmul flops of a ``pcn_emd`` step
  (PCN), by part.
- ``step_floor_ms``: what one train step executes, not the JAX module's
  uniform 3 x forward: conv1 has no input gradient, conv5's backward is
  K4's sparse product (4·B·F·C operations), and ``head_stats``' moment
  matmuls run in f32 whatever the step's type (conv1-4's too under
  ``moment_stats``). A bf16 step's network matmuls are charged at the
  tensor-core peak, an f32 step's at the f32 peak. The loss kernels are
  charged their ``kernel_bound``; ``model_cpu``'s dense Chamfer its (B, N,
  M) matrix written once and read once. The terms add: the step runs its
  network and its loss kernels one after the other.
- ``forward_floor_ms``: a served forward (K5 and the decoder). In bf16 K5
  runs conv1 (K=3) on the CUDA cores and conv2-5 on the tensor cores (k16
  steps; K = 64 and 128 fill them), ``csrc/fused_encoder.cu``; in f32 all
  on the CUDA cores. Its epilogue (conv1-4's affine and ReLU, 3 operations
  an element, and conv5's running max and min, 2) runs on the CUDA cores.
- ``StepCost``: the counterpart of XLA's ``cost_analysis()``. A
  ``TorchDispatchMode`` over one eager call (a train step, a served
  forward): the flops of every matmul and convolution by
  ``torch.utils.flop_counter``'s formulas, and the bytes of every aten op
  (its tensor operands read once, its outputs written once; views 0). The
  seven kernels are opaque to it: inside each (``charge``) it adds the
  kernel's ``kernel_bound`` operations and bytes and counts none of the
  ops inside, so a step counts the same on the CPU, where the plain
  versions run, and on the card. The bytes are those of the op sequence
  the port runs, unfused, computed from tensor sizes: not the least the
  step could move.
- ``roofline_report``: a measured time against the analytic floor and,
  given a ``StepCost``, against the memory bound of its bytes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_SFU_PER_S = 16 * 132 * 1.98e9

# PointNet encoder per-point channel chain (nn/encoder.py; reference
# models/model.py:30-50). The FC decoder widths (nn/decoders.py) end at
# num_point*3, so they are derived per call, not hardcoded.
_ENCODER_CHANNELS = (3, 64, 64, 64, 128, 1024)
ENCODER_MACS_PER_POINT = sum(
    cin * cout for cin, cout in zip(_ENCODER_CHANNELS[:-1],
                                    _ENCODER_CHANNELS[1:]))

# K1, both directions: each pair's d2 once (3 sub, 3 mul, 2 add) and one
# compare per direction.
_CHAMFER_OPS_PER_PAIR = 10.0
# K2: per point of either cloud, about 13 operations, and its xyz (12 B),
# index (4 B) and cotangent (4 B) read and its gradient (12 B) written.
_CHAMFER_GRAD_OPS_PER_POINT = 13.0
_CHAMFER_GRAD_BYTES_PER_POINT = 32.0
# K7, per element of the (rows, C) activation: forward the column sum (1)
# and sum of squares (2), the affine (2) and the ReLU (1); backward the
# affine and the mask again (3), xhat (2), the two sums (3) and dx (4).
_BN_FWD_OPS = 6.0
_BN_BWD_OPS = 12.0
# K6 counts the function's work once: per pair d2 (8), sqrt, max and
# rsqrt; per pair and annealed level one exp2 on the SFUs and 19 f32
# operations (level * d2; the two products of pass A and their sums, 4;
# w = (K * ratioL) * ratioR reusing pass A's product, 1; its row sum; wr;
# the cost term, 2; three gradient terms of 3 each). The last level has
# K = 1: no exp2, no level * d2 and no K products, 16.
EMD_LEVELS = 10
_EMD_PAIR_OPS = 11.0
_EMD_LEVEL_OPS = 19.0
_EMD_LAST_LEVEL_OPS = 16.0
_EMD_OPS_PER_PAIR = (_EMD_PAIR_OPS + (EMD_LEVELS - 1) * _EMD_LEVEL_OPS
                     + _EMD_LAST_LEVEL_OPS)
# exp2 per annealed level, sqrt and rsqrt.
EMD_SFU_PER_PAIR = EMD_LEVELS - 1 + 2.0
# ops/emd.py emd_forward_chunked, per pair and level, every level: pass A
# d2 (8), level * d2, the row normalizer's product and sum (2), the column
# sum's (2), 13, and one exp; pass B d2 (8), level * d2, the two ratio
# products (2), the row sum, the clamp, wr, the cost's product and sum
# (2), and per axis a difference, a product and two sums (12), 28, an exp
# and an rsqrt. Both passes recompute d2: the form never stores (B, N, M).
_EMD_STREAM_OPS_PER_PAIR_LEVEL = 41.0
_EMD_STREAM_SFU_PER_PAIR_LEVEL = 3.0


def _fc_chain_flops(widths) -> float:
    """fwd flops of a dense chain (2 flops per MAC)."""
    return sum(2.0 * cin * cout for cin, cout in zip(widths[:-1], widths[1:]))


def _deconv_flops(stages, h, w, cin) -> float:
    """fwd flops of a VALID transposed-conv stack (nn/layers.py:UpConv).

    Each input position contributes kh*kw*cin*cout MACs; the spatial dims
    grow as (in-1)*stride + kernel per stage."""
    flops = 0.0
    for cout, (kh, kw), (sh, sw) in stages:
        flops += 2.0 * h * w * kh * kw * cin * cout
        h = (h - 1) * sh + kh
        w = (w - 1) * sw + kw
        cin = cout
    return flops


# Decoder stacks per registry config (nn/decoders.py geometry; the final
# (3, (1,1), (1,1)) entry is each upconv stack's linear xyz head).
_UPCONV_STAGES = (
    (512, (2, 2), (2, 2)), (256, (3, 3), (1, 1)), (256, (4, 5), (2, 3)),
    (128, (5, 7), (3, 3)), (3, (1, 1), (1, 1)),
)
_FC_UPCONV_STAGES = (
    (512, (2, 2), (1, 1)), (256, (3, 3), (1, 1)), (256, (4, 4), (2, 2)),
    (128, (5, 5), (3, 3)), (3, (1, 1), (1, 1)),
)


def _decoder_flops(config: str, num_point: int) -> float:
    """fwd flops per shape for a config's neck + decoder
    (models/autoencoder.py necks; nn/decoders.py stacks)."""
    if config in ("model", "model_cpu", "model_emd"):
        return _fc_chain_flops((1024, 1024, 1024, num_point * 3))
    if config == "model_upconv":
        return (_fc_chain_flops((1024, 1024))               # neck fc00
                + _deconv_flops(_UPCONV_STAGES, 1, 2, 512))
    if config == "model_fc_upconv":
        return (_fc_chain_flops((1024, 512))                # neck fc00
                + _fc_chain_flops((512, 512, 512, 1024 * 3))
                + _deconv_flops(_FC_UPCONV_STAGES, 1, 1, 512))
    if config == "model_hierachy":
        per_group = num_point // 64
        return (_fc_chain_flops((1024, 512, 512))           # necks fc00/fc01
                + _fc_chain_flops((512, 64 * 256))          # fc1
                + _fc_chain_flops((512, 64 * 3))            # fc1_xyz
                + 64 * _fc_chain_flops((256, 256))          # fc_conv1
                + 64 * _fc_chain_flops((256, per_group * 3)))  # fc_conv3
    raise ValueError(f"no analytic budget for config {config!r}")


def network_matmul_flops(batch: int, num_point: int,
                         config: str = "model") -> float:
    """fwd+bwd matmul flops for encoder + neck + decoder with the JAX
    module's convention, bwd = 2 x fwd everywhere (``step_matmul_flops``
    is what the port's step executes)."""
    fwd = batch * (num_point * 2.0 * ENCODER_MACS_PER_POINT
                   + _decoder_flops(config, num_point))
    return 3.0 * fwd


# PCN's per-point and per-row dense chains (models/pcn_emd.py).
_PCN_ENCODER = ((3, 128), (128, 256), (512, 512), (512, 1024))
_PCN_CODE = 1024


def pcn_step_matmul_flops(batch: int, num_point: int, num_coarse: int,
                          grid_size: int) -> Dict[str, float]:
    """Matmul flops one ``pcn_emd`` train step executes, forward and
    backward, by part: {"encoder", "coarse", "folding", "network" (their
    sum)}. Forward 2 a multiply-add; backward the gradient to each weight
    and to each layer's input, but the encoder's first layer's input (the
    points) takes none. The folding's rows are the num_coarse *
    grid_size**2 fine points of every shape, each 2 + 3 + 1024 wide."""
    points = batch * num_point
    fine = batch * num_coarse * grid_size ** 2
    encoder = sum((2.0 if i == 0 else 3.0) * 2.0 * points * cin * cout
                  for i, (cin, cout) in enumerate(_PCN_ENCODER))
    coarse = 3.0 * batch * _fc_chain_flops(
        (_PCN_CODE, 1024, 1024, 3 * num_coarse))
    folding = 3.0 * fine * _fc_chain_flops((2 + 3 + _PCN_CODE, 512, 512, 3))
    return {"encoder": encoder, "coarse": coarse, "folding": folding,
            "network": encoder + coarse + folding}


def head_stats_flops(points: int, c: int, f: int,
                     input_grad: bool = True) -> float:
    """Matmul flops of ``ops/fused_head.head_stats`` over ``points`` rows
    of c channels into f, forward and backward: x^T x (2PC^2), E[x] @ w
    (2CF) and S @ w (2C^2F) forward; backward each product's gradient to
    w, and with ``input_grad`` to its other operand too (x^T x's two
    operands, 4PC^2)."""
    fwd = 2.0 * points * c * c + 2.0 * c * f + 2.0 * c * c * f
    to_w = 2.0 * c * f + 2.0 * c * c * f
    to_x = (4.0 * points * c * c + 2.0 * c * f + 2.0 * c * c * f
            if input_grad else 0.0)
    return fwd + to_w + to_x


def step_matmul_flops(config: str, batch: int, num_point: int,
                      moment_stats: bool = False) -> Dict[str, float]:
    """Matmul flops one train step executes: {"network": the encoder
    (conv5's forward is K3, its backward K4), neck and decoder, forward and
    backward; "stats": ``head_stats``' f32 moment matmuls}.

    It differs from ``network_matmul_flops`` by exactly three terms:
    conv1 has no input gradient (-2·P·3·64), conv5's dense backward
    (4·P·128·1024) is K4's 4·B·1024·128, and the statistics are added."""
    p = batch * num_point
    layers = list(zip(_ENCODER_CHANNELS[:-1], _ENCODER_CHANNELS[1:]))
    fwd = sum(2.0 * p * cin * cout for cin, cout in layers)
    (c1, f1), (c5, f5) = layers[0], layers[-1]
    bwd = (2.0 * p * c1 * f1                        # conv1: weight only
           + sum(4.0 * p * cin * cout for cin, cout in layers[1:-1])
           + 4.0 * batch * f5 * c5)                 # conv5: K4
    stats = head_stats_flops(p, c5, f5)
    if moment_stats:
        stats += sum(head_stats_flops(p, cin, cout, input_grad=i > 0)
                     for i, (cin, cout) in enumerate(layers[:-1]))
    return {"network": fwd + bwd + 3.0 * batch * _decoder_flops(config,
                                                               num_point),
            "stats": stats}


def _dtype_name(dtype) -> str:
    if dtype in (torch.bfloat16, "bf16"):
        return "bf16"
    if dtype in (torch.float32, "f32"):
        return "f32"
    raise ValueError(f"no peak for dtype {dtype!r} (bf16 or f32)")


def peak_flops(dtype) -> float:
    """The matmul peak of ``dtype``: bf16 on the tensor cores, f32 on the
    CUDA cores (TF32 is off)."""
    return PEAK_BF16_FLOPS if _dtype_name(dtype) == "bf16" else PEAK_F32_FLOPS


def _bytes_of(dtype) -> int:
    return 2 if _dtype_name(dtype) == "bf16" else 4


def chamfer_ops(batch: int, n: int, m: int, backward: bool = True) -> float:
    """K1's operations (both directions), plus K2's with ``backward``."""
    ops = _CHAMFER_OPS_PER_PAIR * batch * n * m
    if backward:
        ops += _CHAMFER_GRAD_OPS_PER_POINT * batch * (n + m)
    return ops


def emd_ops(batch: int, n: int, m: int) -> float:
    """K6's f32 operations (its SFU results are ``kernel_bound``'s)."""
    return _EMD_OPS_PER_PAIR * batch * n * m


def _counts(kernel: str, b: int = 0, n: int = 0, m: Optional[int] = None,
            c: int = 128, f: int = 1024, dtype="f32",
            rows: Optional[int] = None) -> Tuple[float, float, float, float]:
    """(operations, bytes, their peak, SFU results) of one kernel call."""
    es = _bytes_of(dtype)
    if kernel in ("batch_norm_fwd", "batch_norm_bwd"):
        if rows is None:
            raise ValueError(f"{kernel} needs rows, the activation's rows")
        elements = rows * c
        if kernel == "batch_norm_fwd":
            # y read once, the output written once; gamma, beta and the
            # moving statistics (read and written) per channel.
            return (_BN_FWD_OPS * elements, 2.0 * elements * es + 6 * c * 4,
                    PEAK_F32_FLOPS, 0.0)
        # g and y read once, dx written once; the moments, gamma and beta
        # read and dgamma and dbeta written per channel.
        return (_BN_BWD_OPS * elements, 3.0 * elements * es + 6 * c * 4,
                PEAK_F32_FLOPS, 0.0)
    if kernel == "nn_distance":
        return (chamfer_ops(b, n, m, backward=False), 20.0 * b * (n + m),
                PEAK_F32_FLOPS, 0.0)
    if kernel == "nn_distance_grad":
        return (_CHAMFER_GRAD_OPS_PER_POINT * b * (n + m),
                _CHAMFER_GRAD_BYTES_PER_POINT * b * (n + m), PEAK_F32_FLOPS,
                0.0)
    if kernel == "fused_head_fwd":
        # x, w, scale and shift read once; (max, argmax) written once.
        return (2.0 * b * n * c * f,
                b * n * c * es + c * f * es + 2 * f * 4 + b * f * 8,
                peak_flops(dtype), 0.0)
    if kernel == "fused_head_bwd":
        if rows is None:
            raise ValueError("fused_head_bwd needs rows, the distinct "
                             "argmax rows of x")
        # B·F·C products, 4 operations each with the sum; dx written once,
        # x's argmax rows, w, gvals and argmax read once, dw written once.
        return (4.0 * b * f * c,
                b * n * c * es + rows * c * es + c * f * es + b * f * 8
                + c * f * 4, peak_flops(dtype), 0.0)
    if kernel == "fused_encoder_eval":
        # points, weights and the inner layers' folded rows read once, the
        # (B, 1024) max and min written once.
        widths = _ENCODER_CHANNELS
        return (2.0 * b * n * ENCODER_MACS_PER_POINT,
                b * n * widths[0] * es + ENCODER_MACS_PER_POINT * es
                + 2 * sum(widths[1:-1]) * 4 + 2 * b * widths[-1] * 4,
                peak_flops(dtype), 0.0)
    if kernel == "emd_forward":
        # both clouds read once, cost and both gradients written once.
        return (emd_ops(b, n, m), b * (4 + 2 * (n + m) * 3 * 4),
                PEAK_F32_FLOPS, EMD_SFU_PER_PAIR * b * n * m)
    raise ValueError(f"no kernel {kernel!r}")


# The kernels whose operations are matmul flops (the encoder's layers).
MATMUL_KERNELS = ("fused_head_fwd", "fused_head_bwd", "fused_encoder_eval")


def kernel_bound(kernel: str, **shape) -> Dict:
    """{"ops", "bytes", "bound_ms", "bound_by"} of one call of ``kernel``
    (K1-K7 by their launch counters' names: nn_distance, nn_distance_grad,
    fused_head_fwd, fused_head_bwd, fused_encoder_eval, emd_forward,
    batch_norm_fwd, batch_norm_bwd) at ``shape``: b, n (and m for the
    Chamfer and EMD kernels; c, f and dtype for the head; dtype for K5,
    which takes only the encoder's widths; rows, the distinct argmax rows
    of x, for K4); for K7 rows, c and dtype of its (rows, C) activation.
    The bound is the
    larger of the operations over their peak (K6: or its SFU results over
    the SFU rate) and the bytes over the HBM rate."""
    ops, nbytes, peak, sfu = _counts(kernel, **shape)
    t_ops = max(ops / peak, sfu / PEAK_SFU_PER_S) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def distinct_rows(argmax: torch.Tensor, n: int) -> int:
    """The distinct rows of x (B, N, C) that argmax (B, F) names: the rows
    K4 reads."""
    b = argmax.shape[0]
    rows = argmax.long() + n * torch.arange(b, device=argmax.device)[:, None]
    return int(torch.unique(rows).numel())


def loss_kernel_calls(config: str, batch: int,
                      num_point: int) -> List[Tuple[str, Dict]]:
    """(kernel, shape) of each loss-kernel call of one train step: the
    Chamfer of the prediction with its gradient; ``model_emd`` K6 and a
    forward-only K1 for its pcloss metric; ``model_hierachy`` also the 64
    centres against the label; ``model_cpu`` none (its Chamfer is the
    dense form)."""
    full = dict(b=batch, n=num_point, m=num_point)
    chamfer = [("nn_distance", full), ("nn_distance_grad", full)]
    if config in ("model", "model_upconv", "model_fc_upconv"):
        return chamfer
    if config == "model_cpu":
        return []
    if config == "model_emd":
        return [("emd_forward", full), ("nn_distance", full)]
    if config == "model_hierachy":
        centres = dict(b=batch, n=64, m=num_point)
        return chamfer + [("nn_distance", centres),
                          ("nn_distance_grad", centres)]
    raise ValueError(f"no analytic budget for config {config!r}")


def _loss_ms(config: str, batch: int, num_point: int) -> float:
    ms = sum(kernel_bound(k, **shape)["bound_ms"]
             for k, shape in loss_kernel_calls(config, batch, num_point))
    if config == "model_cpu":
        # The dense (B, N, M) f32 distance matrix written once, read once.
        ms += 2 * 4.0 * batch * num_point * num_point / PEAK_BYTES_PER_S * 1e3
    return ms


def step_floor_ms(config: str, batch: int, num_point: int, dtype="bf16",
                  moment_stats: bool = False) -> Dict[str, float]:
    """Analytic floor of one train step of a registry config, in the
    step's matmul ``dtype``: {"matmul_ms": the network's matmuls at the
    type's peak, "stats_ms": the f32 moment matmuls at the f32 peak,
    "loss_ms": the loss kernels' bounds, "floor_ms": their sum}."""
    flops = step_matmul_flops(config, batch, num_point, moment_stats)
    out = {"matmul_ms": flops["network"] / peak_flops(dtype) * 1e3,
           "stats_ms": flops["stats"] / PEAK_F32_FLOPS * 1e3,
           "loss_ms": _loss_ms(config, batch, num_point)}
    out["floor_ms"] = out["matmul_ms"] + out["stats_ms"] + out["loss_ms"]
    return out


def _forward_budget(config: str, batch: int, num_point: int,
                    dtype) -> Dict[str, float]:
    p = batch * num_point
    conv1 = 2.0 * p * _ENCODER_CHANNELS[0] * _ENCODER_CHANNELS[1]
    encoder = 2.0 * p * ENCODER_MACS_PER_POINT
    decoder = batch * _decoder_flops(config, num_point)
    if _dtype_name(dtype) == "bf16":
        matmul_s = (conv1 / PEAK_F32_FLOPS
                    + (encoder - conv1 + decoder) / PEAK_BF16_FLOPS)
    else:
        matmul_s = (encoder + decoder) / PEAK_F32_FLOPS
    epilogue = (3.0 * p * sum(_ENCODER_CHANNELS[1:-1])
                + 2.0 * p * _ENCODER_CHANNELS[-1])
    out = {"matmul_ms": matmul_s * 1e3,
           "epilogue_ms": epilogue / PEAK_F32_FLOPS * 1e3}
    out["floor_ms"] = out["matmul_ms"] + out["epilogue_ms"]
    return out


def forward_floor_ms(config: str, batch: int, num_point: int,
                     dtype="f32") -> float:
    """Analytic floor of the eval (served) forward in ``dtype``: K5's
    matmuls where ``csrc/fused_encoder.cu`` runs them (bf16: conv1 on the
    CUDA cores, conv2-5 on the tensor cores; f32: all on the CUDA cores),
    the decoder's at the type's peak, and K5's epilogue on the CUDA
    cores."""
    return _forward_budget(config, batch, num_point, dtype)["floor_ms"]


def emd_streaming_floor_ms(batch: int, n: int, m: int) -> float:
    """Analytic floor of ``ops/emd.py`` ``emd_forward_chunked`` on the
    card: per pair and level 41 f32 operations and 3 SFU results (both
    passes recompute d2, so each level pays it twice); its input and
    output bytes are negligible. The larger of the two times."""
    pair_levels = EMD_LEVELS * batch * n * m
    return max(_EMD_STREAM_OPS_PER_PAIR_LEVEL * pair_levels / PEAK_F32_FLOPS,
               _EMD_STREAM_SFU_PER_PAIR_LEVEL * pair_levels
               / PEAK_SFU_PER_S) * 1e3


# ---------------------------------------------------------------------------
# StepCost: what one eager call runs
# ---------------------------------------------------------------------------

# Ops that write their mutable operand without reading it.
_WRITE_ONLY = {"copy_", "fill_", "zero_", "uniform_", "normal_", "random_",
               "bernoulli_", "exponential_", "index_fill_", "masked_fill_"}
# Ops that move no data: allocations and metadata.
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "set_", "resize_"}


def _base(func) -> str:
    """aten._foreach_add_.Scalar -> add_."""
    name = func._schema.name.split("::")[-1]
    return name[len("_foreach_"):] if name.startswith("_foreach_") else name


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of the elements a tensor view touches (a broadcast axis,
    stride 0, once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride or size == 0:
            n *= size
    return n * t.element_size()


def _tensors(value) -> List[torch.Tensor]:
    return [t for t in tree_flatten(value)[0] if isinstance(t, torch.Tensor)]


class _Opaque:
    """The context of one kernel call inside a StepCost: the ops inside are
    not counted; on exit the kernel's bound is."""

    def __init__(self, cost: "StepCost", kernel: str, shape: Dict):
        self.cost, self.kernel, self.shape = cost, kernel, shape

    def __enter__(self):
        self.cost._opaque += 1

    def __exit__(self, *exc):
        try:
            if exc[0] is None:
                self.cost._add_kernel(self.kernel, self.shape)
        finally:
            self.cost._opaque -= 1


class StepCost(TorchDispatchMode):
    """The flops and bytes of what runs inside ``with StepCost() as cost``:
    one eager call, never a capture (entering under CUDA graph capture
    raises).

    - ``ops``: {(part, op): [calls, bytes, flops]}; ``part`` is "model",
      "optimizer" (inside ``region("optimizer")``: the update) or
      "transfer" (a copy between the host and the card).
    - ``kernels``: {kernel: {"calls", "ops", "bytes"}}, each call charged
      its ``kernel_bound`` (K4 by the distinct argmax rows it was given).
    - ``matmul_flops``: {dtype name: flops} of the matmuls and
      convolutions (``torch.utils.flop_counter``'s formulas) and of the
      matmul kernels K3, K4 and K5.

    The update and the transfers are the parts the card and the CPU run
    differently by design: capturable Adam's foreach update with its device
    step count and bias corrections against the CPU's per-tensor update
    with host ones (``MasterOptimizer``: one Philox draw at an offset
    against a seeded draw per stream), and a served call's copies in and
    out, which the CPU does not make."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[Tuple[str, str], List[float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.matmul_flops: Dict[str, float] = {}
        self._part = "model"
        self._opaque = 0

    def __enter__(self):
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("StepCost counts an eager call, not a "
                               "capture")
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func._overloadpacket not in flop_registry
                and func is not torch.ops.prim.device.default):
            # An op that arrives whole (under inference mode, linear and
            # matmul do) is counted by its decomposition, as autograd
            # would have run it.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self._opaque:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        base = _base(func)
        flops = 0.0
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            key = str(_tensors(args)[0].dtype).split(".")[-1]
            self.matmul_flops[key] = self.matmul_flops.get(key, 0.0) + flops
        part = self._part
        if func.is_view or base in _FREE:
            nbytes = 0
        else:
            nbytes = 0
            written = []
            for i, arg in enumerate(func._schema.arguments):
                value = (args[i] if i < len(args)
                         else kwargs.get(arg.name))
                tensors = _tensors(value)
                write = arg.alias_info is not None and arg.alias_info.is_write
                if write:
                    written += tensors
                if not (write and (arg.kwarg_only or base in _WRITE_ONLY)):
                    nbytes += sum(_nbytes(t) for t in tensors)
            outs = written or _tensors(out)
            nbytes += sum(_nbytes(t) for t in outs)
            if base in ("_to_copy", "copy_") and len(
                    {t.device.type for t in _tensors(args) + outs}) > 1:
                part = "transfer"
        entry = self.ops.setdefault((part, str(func)), [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += nbytes
        entry[2] += flops

    def _add_kernel(self, kernel: str, shape: Dict) -> None:
        shape = dict(shape)
        argmax = shape.pop("argmax", None)
        if argmax is not None:
            shape["rows"] = distinct_rows(argmax, shape["n"])
        kb = kernel_bound(kernel, **shape)
        entry = self.kernels.setdefault(
            kernel, {"calls": 0, "ops": 0.0, "bytes": 0.0})
        entry["calls"] += 1
        entry["ops"] += kb["ops"]
        entry["bytes"] += kb["bytes"]
        if kernel in MATMUL_KERNELS:
            key = "bfloat16" if _dtype_name(
                shape.get("dtype", "f32")) == "bf16" else "float32"
            self.matmul_flops[key] = self.matmul_flops.get(key, 0.0) \
                + kb["ops"]

    def part(self, name: str) -> Dict[str, float]:
        """{"calls", "bytes", "flops"} of the ops of one part."""
        calls = nbytes = flops = 0.0
        for (part, _), (c, b, f) in self.ops.items():
            if part == name:
                calls, nbytes, flops = calls + c, nbytes + b, flops + f
        return {"calls": calls, "bytes": nbytes, "flops": flops}

    @property
    def bytes(self) -> float:
        """Every op's bytes and every kernel's."""
        return (sum(b for _, b, _ in self.ops.values())
                + sum(k["bytes"] for k in self.kernels.values()))

    @property
    def flops(self) -> float:
        """Every matmul's flops and every kernel's operations."""
        return (sum(f for _, _, f in self.ops.values())
                + sum(k["ops"] for k in self.kernels.values()))

    def summary(self) -> Dict:
        """A JSON-ready view: totals, each part's, each kernel's, and the
        matmul flops by type."""
        return {"bytes": self.bytes, "flops": self.flops,
                "parts": {p: self.part(p) for p in sorted(
                    {part for part, _ in self.ops})},
                "kernels": {k: dict(v) for k, v in sorted(
                    self.kernels.items())},
                "matmul_flops": dict(sorted(self.matmul_flops.items()))}


def _active() -> Optional[StepCost]:
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, StepCost):
            return mode
    return None


_NULL = contextlib.nullcontext()


def charge(kernel: str, **shape):
    """The context of one call of ``kernel`` (its wrapper, or its plain
    version on the CPU): inside a ``StepCost`` the ops within are not
    counted and the kernel's ``kernel_bound`` at ``shape`` is (K4 may be
    given ``argmax`` in place of ``rows``); with no counter active, a
    shared null context."""
    cost = _active()
    return _NULL if cost is None else _Opaque(cost, kernel, shape)


def region(name: str):
    """Within it, a ``StepCost``'s ops count under part ``name``; a shared
    null context when no counter is active."""
    cost = _active()
    return _NULL if cost is None else _Region(cost, name)


class _Region:
    def __init__(self, cost: StepCost, name: str):
        self.cost, self.name, self.prev = cost, name, None

    def __enter__(self):
        self.prev, self.cost._part = self.cost._part, self.name

    def __exit__(self, *exc):
        self.cost._part = self.prev


def whole_program_bound(cost: StepCost) -> Optional[Dict[str, float]]:
    """{'hbm_bytes_GB', 'program_flops_G', 'mem_bound_ms'} from a
    ``StepCost`` (None if it counted no bytes). The bytes are the unfused
    op sequence's, from tensor sizes."""
    nbytes = float(cost.bytes)
    if nbytes <= 0:
        return None
    return {"hbm_bytes_GB": nbytes / 1e9,
            "program_flops_G": float(cost.flops) / 1e9,
            "mem_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}


def roofline_report(config: str, batch: int, num_point: int,
                    measured_ms: float, cost: Optional[StepCost] = None,
                    dtype="bf16", serving: bool = False) -> Dict:
    """A measured time against the analytic floor: of one train step, or
    with ``serving`` of one served forward. pct_of_roofline =
    floor / measured; mfu = matmul_ms / measured (the network's matmuls at
    their peak over the time taken). Values are not rounded.

    ``cost``: a ``StepCost`` of the same call, whose bytes give the memory
    bound (bytes / 3.35 TB/s). The analytic floor counts no program
    traffic and the memory bound counts the kernels only by their own
    bytes, so the report also gives the binding bound: where the floor
    exceeds the memory bound (a kernel-dominated step) the two compose
    serially, ``composed_bound_ms = floor + mem_bound``, else the memory
    bound binds; ``pct_of_bound`` = bound / measured."""
    budget = (_forward_budget(config, batch, num_point, dtype) if serving
              else step_floor_ms(config, batch, num_point, dtype))
    floor = budget["floor_ms"]
    out = {"measured_ms": measured_ms, "analytic_floor_ms": floor}
    out.update((k, v) for k, v in budget.items() if k != "floor_ms")
    out["pct_of_roofline"] = 100.0 * floor / measured_ms
    out["mfu"] = budget["matmul_ms"] / measured_ms
    if cost is not None:
        whole = whole_program_bound(cost)
        if whole is not None:
            out.update(whole)
            out["pct_of_mem_bound"] = 100.0 * whole["mem_bound_ms"] \
                / measured_ms
            if floor > whole["mem_bound_ms"]:
                bound_ms = floor + whole["mem_bound_ms"]
                out["composed_bound_ms"] = bound_ms
            else:
                bound_ms = whole["mem_bound_ms"]
            out["bound_ms"] = bound_ms
            out["pct_of_bound"] = 100.0 * bound_ms / measured_ms
    return out
