"""The train step's share of the card's bf16 peak: the step's matmul flops
(``benchmark/counts.step_matmul_flops``, the network's forward and
backward at the cell's shapes) over 989 TFLOP/s times the traced
stretch's time a step. It bounds every kernel roofline of the step, and
should move ``train_shapes_per_s``."""

from benchmark import counts

KERNELS = {}


def read(trace):
    f = trace.facts
    flops = counts.step_matmul_flops(f["config"], f["batch"],
                                     f["num_point"])["network"]
    return 100.0 * flops * trace.rounds / (counts.PEAK_BF16_FLOPS
                                           * trace.window_s)
