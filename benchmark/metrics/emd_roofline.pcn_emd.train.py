"""The approximate-EMD kernel's share of its roofline in PCN's step: K6
(24 launches a call: the initialization, a row and a column pass for each
of 11 level steps, the cost sum) on the coarse cloud against the target's
first num_coarse points, (B, num_coarse, num_coarse), its frozen bound
(``benchmark/counts_pcn_emd.emd_bound_ms``) over its device time a call in
the traced stretch. It should move ``train_shapes_per_s``."""

from benchmark import counts_pcn_emd

KERNELS = {"emd_init": ("emd_forward_cuda", 1),
           "emd_step": ("emd_forward_cuda", 22),
           "emd_cost_sum": ("emd_forward_cuda", 1)}


def read(trace):
    f = trace.facts
    ms = trace.ms_per_call(KERNELS)
    if ms is None or f.get("config") != "pcn_emd":
        return None
    return 100.0 * counts_pcn_emd.emd_bound_ms(f["batch"],
                                               f["num_coarse"]) / ms
