"""The approximate-EMD kernel's share of its roofline in the step: K6 (24
launches a call: the initialization, a row and a column pass for each of
11 level steps, the cost sum), its frozen bound over its device time a
call in the traced stretch. It should move ``train_shapes_per_s``."""

from benchmark import counts

KERNELS = {"emd_init": ("emd_forward_cuda", 1),
           "emd_step": ("emd_forward_cuda", 22),
           "emd_cost_sum": ("emd_forward_cuda", 1)}


def read(trace):
    ms = trace.ms_per_call(KERNELS)
    if ms is None:
        return None
    f = trace.facts
    bound = counts.kernel_bound("emd_forward", b=f["batch"],
                                n=f["num_point"], m=f["num_point"])
    return 100.0 * bound["bound_ms"] / ms
