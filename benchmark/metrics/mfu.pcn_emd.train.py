"""PCN's train step's share of the card's bf16 peak: the step's matmul
flops (``benchmark/counts_pcn_emd.step_matmul_flops``: the encoder, the
coarse decoder and the folding over every fine point, forward and
backward, at the cell's shapes) over 989 TFLOP/s times the traced
stretch's time a step. It bounds the matmuls' share of the step, and
should move ``train_shapes_per_s``."""

from benchmark import counts, counts_pcn_emd

KERNELS = {}


def read(trace):
    f = trace.facts
    if f.get("config") != "pcn_emd":
        return None
    flops = counts_pcn_emd.step_matmul_flops(
        f["batch"], f["num_point"], f["num_coarse"],
        f["grid_size"])["network"]
    return 100.0 * flops * trace.rounds / (counts.PEAK_BF16_FLOPS
                                           * trace.window_s)
