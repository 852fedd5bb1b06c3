"""The Chamfer kernels' share of their roofline in PCN's step: K1 (both
directions, two launches a call) and K2 (the gradient) on the fine cloud
against the target, (B, num_fine, num_gt_point), their frozen bounds
(``benchmark/counts_pcn_emd.chamfer_bound_ms``) over their device time a
call in the traced stretch. It should move ``train_shapes_per_s``."""

from benchmark import counts_pcn_emd

KERNELS = {"nn_distance_kernel": ("nn_distance_cuda", 1),
           "nn_distance_cols_kernel": ("nn_distance_cuda", 1),
           "nn_distance_grad_kernel": ("nn_distance_grad_cuda", 1)}


def read(trace):
    f = trace.facts
    ms = trace.ms_per_call(KERNELS)
    if ms is None or f.get("config") != "pcn_emd":
        return None
    fine = f["num_coarse"] * f["grid_size"] ** 2
    return 100.0 * counts_pcn_emd.chamfer_bound_ms(
        f["batch"], fine, f["num_gt_point"]) / ms
