"""The fused conv5 head's share of its roofline in the step: K3 (bf16, one
launch) and K4 (three launches: w transposed, dx, dw), their frozen
bounds over their device time a call in the traced stretch. K4's bound
reads the distinct argmax rows of the batch, which the reference counts
from its own forward of the stretch's batches. It should move
``train_shapes_per_s``."""

from benchmark import counts

KERNELS = {"head_fwd_mma_kernel": ("head_max_cuda", 1),
           "head_w_transpose_kernel": ("head_bwd_cuda", 1),
           "head_bwd_dx_kernel": ("head_bwd_cuda", 1),
           "head_bwd_dw_kernel": ("head_bwd_cuda", 1)}


def read(trace):
    ms = trace.ms_per_call(KERNELS)
    if ms is None:
        return None
    f = trace.facts
    shape = dict(b=f["batch"], n=f["num_point"], c=128, f=1024, dtype="bf16")
    bound = (counts.kernel_bound("fused_head_fwd", **shape)["bound_ms"]
             + counts.kernel_bound("fused_head_bwd", rows=f["head_rows"],
                                   **shape)["bound_ms"])
    return 100.0 * bound / ms
