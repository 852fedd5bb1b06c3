"""The Chamfer kernels' share of their roofline in the step: K1 (both
directions, two launches a call) and K2 (the gradient), their frozen
bounds (``benchmark/counts.kernel_bound``) over their device time a call
in the traced stretch. It should move ``train_shapes_per_s``."""

from benchmark import counts

KERNELS = {"nn_distance_kernel": ("nn_distance_cuda", 1),
           "nn_distance_cols_kernel": ("nn_distance_cuda", 1),
           "nn_distance_grad_kernel": ("nn_distance_grad_cuda", 1)}


def read(trace):
    ms = trace.ms_per_call(KERNELS)
    if ms is None:
        return None
    f = trace.facts
    shape = dict(b=f["batch"], n=f["num_point"], m=f["num_point"])
    bound = (counts.kernel_bound("nn_distance", **shape)["bound_ms"]
             + counts.kernel_bound("nn_distance_grad", **shape)["bound_ms"])
    return 100.0 * bound / ms
