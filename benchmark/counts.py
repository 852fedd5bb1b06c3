"""Frozen work counts: the operations and bytes of each hand-written kernel
(K1-K6) and the matmul flops of a train step and of a served forward, with
the published peaks of one NVIDIA H100 SXM.

This is the benchmark's yardstick, so it lives here and not in the
program: a change to the program cannot lower its own bound. The counts
are a copy of the port's ``utils/roofline.py`` as it stood when the
benchmark was defined (``benchmark/tests/test_counts.py`` pins them equal
at the cells' shapes). They are hardware-independent except for the
peaks, and depend only on shapes, never on the op sequence a program
happens to run.

Peaks (NVIDIA's data sheet, dense, at the 700 W power limit): bf16 on the
tensor cores 989 TFLOP/s, f32 outside them 67 TFLOP/s, HBM 3.35 TB/s, the
special-function units 16 results per SM per clock on 132 SMs at 1980 MHz.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_SFU_PER_S = 16 * 132 * 1.98e9

# PointNet encoder per-point channel chain (reference models/model.py).
ENCODER_CHANNELS = (3, 64, 64, 64, 128, 1024)
ENCODER_MACS_PER_POINT = sum(
    cin * cout for cin, cout in zip(ENCODER_CHANNELS[:-1],
                                    ENCODER_CHANNELS[1:]))

# K1, both directions: each pair's d2 once (3 sub, 3 mul, 2 add) and one
# compare per direction.
CHAMFER_OPS_PER_PAIR = 10.0
# K2: per point of either cloud about 13 operations; its xyz (12 B), index
# (4 B) and cotangent (4 B) read and its gradient (12 B) written.
CHAMFER_GRAD_OPS_PER_POINT = 13.0
CHAMFER_GRAD_BYTES_PER_POINT = 32.0
# K6 counts the annealed matching once: per pair d2 (8), sqrt, max and
# rsqrt; per pair and annealed level one exp2 on the SFUs and 19 f32
# operations; the last level (K = 1) 16 and no exp2.
EMD_LEVELS = 10
EMD_OPS_PER_PAIR = 11.0 + (EMD_LEVELS - 1) * 19.0 + 16.0
EMD_SFU_PER_PAIR = EMD_LEVELS - 1 + 2.0

_UPCONV_STAGES = (
    (512, (2, 2), (2, 2)), (256, (3, 3), (1, 1)), (256, (4, 5), (2, 3)),
    (128, (5, 7), (3, 3)), (3, (1, 1), (1, 1)),
)
_FC_UPCONV_STAGES = (
    (512, (2, 2), (1, 1)), (256, (3, 3), (1, 1)), (256, (4, 4), (2, 2)),
    (128, (5, 5), (3, 3)), (3, (1, 1), (1, 1)),
)


def _fc_chain_flops(widths) -> float:
    """Forward flops of a dense chain, 2 a multiply-add."""
    return sum(2.0 * cin * cout for cin, cout in zip(widths[:-1], widths[1:]))


def _deconv_flops(stages, h, w, cin) -> float:
    """Forward flops of a VALID transposed-convolution stack."""
    flops = 0.0
    for cout, (kh, kw), (sh, sw) in stages:
        flops += 2.0 * h * w * kh * kw * cin * cout
        h = (h - 1) * sh + kh
        w = (w - 1) * sw + kw
        cin = cout
    return flops


def decoder_flops(config: str, num_point: int) -> float:
    """Forward flops per shape of a configuration's neck and decoder."""
    if config in ("model", "model_cpu", "model_emd"):
        return _fc_chain_flops((1024, 1024, 1024, num_point * 3))
    if config == "model_upconv":
        return (_fc_chain_flops((1024, 1024))
                + _deconv_flops(_UPCONV_STAGES, 1, 2, 512))
    if config == "model_fc_upconv":
        return (_fc_chain_flops((1024, 512))
                + _fc_chain_flops((512, 512, 512, 1024 * 3))
                + _deconv_flops(_FC_UPCONV_STAGES, 1, 1, 512))
    if config == "model_hierachy":
        per_group = num_point // 64
        return (_fc_chain_flops((1024, 512, 512))
                + _fc_chain_flops((512, 64 * 256))
                + _fc_chain_flops((512, 64 * 3))
                + 64 * _fc_chain_flops((256, 256))
                + 64 * _fc_chain_flops((256, per_group * 3)))
    raise ValueError(f"no count for config {config!r}")


def network_matmul_flops(batch: int, num_point: int,
                         config: str = "model") -> float:
    """Forward and backward matmul flops of encoder, neck and decoder with
    the convention backward = 2 x forward everywhere."""
    fwd = batch * (num_point * 2.0 * ENCODER_MACS_PER_POINT
                   + decoder_flops(config, num_point))
    return 3.0 * fwd


def head_stats_flops(points: int, c: int, f: int,
                     input_grad: bool = True) -> float:
    """Matmul flops of the head's batch statistics from input moments over
    ``points`` rows of c channels into f, forward and backward."""
    fwd = 2.0 * points * c * c + 2.0 * c * f + 2.0 * c * c * f
    to_w = 2.0 * c * f + 2.0 * c * c * f
    to_x = (4.0 * points * c * c + 2.0 * c * f + 2.0 * c * c * f
            if input_grad else 0.0)
    return fwd + to_w + to_x


def step_matmul_flops(config: str, batch: int, num_point: int,
                      moment_stats: bool = False) -> Dict[str, float]:
    """Matmul flops one train step needs: {"network": encoder (conv1 has no
    input gradient; conv5's backward is the one-hot product, 4·B·F·C),
    neck and decoder, forward and backward; "stats": the head's f32
    moment matmuls}."""
    p = batch * num_point
    layers = list(zip(ENCODER_CHANNELS[:-1], ENCODER_CHANNELS[1:]))
    fwd = sum(2.0 * p * cin * cout for cin, cout in layers)
    (c1, f1), (c5, f5) = layers[0], layers[-1]
    bwd = (2.0 * p * c1 * f1
           + sum(4.0 * p * cin * cout for cin, cout in layers[1:-1])
           + 4.0 * batch * f5 * c5)
    stats = head_stats_flops(p, c5, f5)
    if moment_stats:
        stats += sum(head_stats_flops(p, cin, cout, input_grad=i > 0)
                     for i, (cin, cout) in enumerate(layers[:-1]))
    return {"network": fwd + bwd + 3.0 * batch * decoder_flops(config,
                                                              num_point),
            "stats": stats}


def forward_matmul_flops(config: str, batch: int, num_point: int) -> float:
    """Matmul flops of one eval (served) forward: encoder and decoder."""
    return batch * (2.0 * num_point * ENCODER_MACS_PER_POINT
                    + decoder_flops(config, num_point))


def _bytes_of(dtype: str) -> int:
    if dtype == "bf16":
        return 2
    if dtype == "f32":
        return 4
    raise ValueError(f"no element size for dtype {dtype!r} (bf16 or f32)")


def peak_flops(dtype: str) -> float:
    """The matmul peak of ``dtype``: bf16 on the tensor cores, f32 on the
    CUDA cores (TF32 stays off)."""
    _bytes_of(dtype)
    return PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS


def _counts(kernel: str, b: int, n: int, m: Optional[int] = None,
            c: int = 128, f: int = 1024, dtype: str = "f32",
            rows: Optional[int] = None) -> Tuple[float, float, float, float]:
    """(operations, bytes, their peak, SFU results) of one kernel call."""
    es = _bytes_of(dtype)
    if kernel == "nn_distance":
        return (CHAMFER_OPS_PER_PAIR * b * n * m, 20.0 * b * (n + m),
                PEAK_F32_FLOPS, 0.0)
    if kernel == "nn_distance_grad":
        return (CHAMFER_GRAD_OPS_PER_POINT * b * (n + m),
                CHAMFER_GRAD_BYTES_PER_POINT * b * (n + m), PEAK_F32_FLOPS,
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
        w = ENCODER_CHANNELS
        return (2.0 * b * n * ENCODER_MACS_PER_POINT,
                b * n * w[0] * es + ENCODER_MACS_PER_POINT * es
                + 2 * sum(w[1:-1]) * 4 + 2 * b * w[-1] * 4,
                peak_flops(dtype), 0.0)
    if kernel == "emd_forward":
        # both clouds read once, cost and both gradients written once.
        return (EMD_OPS_PER_PAIR * b * n * m, b * (4 + 2 * (n + m) * 3 * 4),
                PEAK_F32_FLOPS, EMD_SFU_PER_PAIR * b * n * m)
    raise ValueError(f"no kernel {kernel!r}")


def kernel_bound(kernel: str, **shape) -> Dict:
    """{"ops", "bytes", "bound_ms", "bound_by"} of one call of ``kernel``
    (nn_distance, nn_distance_grad, fused_head_fwd, fused_head_bwd,
    fused_encoder_eval, emd_forward) at ``shape``: the larger of its
    operations over their peak (K6: or its SFU results over the SFU rate)
    and its bytes over the HBM rate."""
    ops, nbytes, peak, sfu = _counts(kernel, **shape)
    t_ops = max(ops / peak, sfu / PEAK_SFU_PER_S) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
