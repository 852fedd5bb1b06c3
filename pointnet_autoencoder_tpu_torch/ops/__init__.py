"""The port's loss and encoder ops: Chamfer (nn_distance) and approximate
EMD (approx_match), and the fused conv5 head, with the CUDA kernels of
``csrc/`` on the card and their plain PyTorch versions on the CPU; the
same names as the JAX package's ``ops``. Each kernel call (on the CPU its
plain version) runs inside ``utils/roofline.charge``: a ``StepCost``
counts it as the kernel's bound, not op by op.
"""

from pointnet_autoencoder_tpu_torch.ops.chamfer import (
    chamfer_loss,
    nn_distance,
)
from pointnet_autoencoder_tpu_torch.ops.emd import (
    approx_match,
    emd_cost,
    emd_loss,
    match_cost,
)
from pointnet_autoencoder_tpu_torch.ops.fused_head import (
    fused_dense_bn_relu_max,
    head_stats,
)

__all__ = [
    "nn_distance",
    "chamfer_loss",
    "approx_match",
    "match_cost",
    "emd_cost",
    "emd_loss",
    "fused_dense_bn_relu_max",
    "head_stats",
]
