"""Model registry: ``--model`` names -> ModelSpec.

Counterpart of ``pointnet_autoencoder_tpu/models/registry.py``, with the
same names (the reference's ``model_hierachy`` spelling included), so
command lines carry over:

- ``model``: fc decoder, no neck, Chamfer x100 loss on the kernels;
- ``model_cpu``: the same network on the dense Chamfer (the reference's
  pure-TF twin of ``model``), on every device;
- ``model_emd``: the same network on the EMD loss (its weights tree is
  ``model``'s);
- ``model_upconv``: a (1024,) neck and the upconv decoder, 2048 points;
- ``model_fc_upconv``: a (512,) neck and the fc_upconv decoder, 2048
  points;
- ``model_hierachy``: a (512, 512) neck, the hierarchical decoder and its
  two-level Chamfer loss, num_point a multiple of 64.

One family more than the reference, which the JAX package does not have
(``reference_models`` lists the six it shares):

- ``pcn_emd``: PCN (Yuan et al., 3DV 2018; github.com/wentaoyuan/pcn
  ``models/pcn_emd.py``): the two-stage encoder, the coarse decoder to
  1024 points and the folding decoder to 16,384, trained on the EMD of
  the coarse cloud plus alpha times the sqrt-Chamfer of the fine one.
  Its widths are the published ones whatever the data. Its input
  (``--num_point``) and its target (``--num_gt_point``, 16,384 by
  default, the fine cloud's size, and at least the 1024 coarse points)
  differ: the target is the loaded cloud, the input its first
  ``num_point`` points. Its learning-rate
  staircase counts steps (``--decay_step`` is PCN's ``lr_decay_steps``).
  It trains and checkpoints on one card; serving (and so pipeline
  parallelism, which serves a session) and tensor and point parallelism
  refuse it.
"""

from __future__ import annotations

from typing import Dict, List

from pointnet_autoencoder_tpu_torch.models.autoencoder import (
    ModelSpec,
    chamfer_x100_dense_loss,
    chamfer_x100_loss,
    emd_loss_fn,
    hierarchy_loss_fn,
    PCN_GRID_SIZE,
    PCN_NUM_COARSE,
    PCNLoss,
)
from pointnet_autoencoder_tpu_torch.train.schedules import pcn_alpha_schedule

_REGISTRY: Dict[str, ModelSpec] = {
    spec.name: spec for spec in (
        ModelSpec(name="model", decoder="fc", loss_fn=chamfer_x100_loss),
        ModelSpec(name="model_cpu", decoder="fc",
                  loss_fn=chamfer_x100_dense_loss),
        ModelSpec(name="model_emd", decoder="fc", loss_fn=emd_loss_fn),
        ModelSpec(name="model_upconv", decoder="upconv", neck=(1024,),
                  loss_fn=chamfer_x100_loss,
                  point_constraint=lambda n: n == 2048,
                  constraint_msg="upconv decoder emits exactly 2048 points"),
        ModelSpec(name="model_fc_upconv", decoder="fc_upconv", neck=(512,),
                  loss_fn=chamfer_x100_loss,
                  point_constraint=lambda n: n == 2048,
                  constraint_msg="fc_upconv decoder emits exactly 2048 "
                                 "points"),
        ModelSpec(name="model_hierachy", decoder="hierarchy",
                  neck=(512, 512), loss_fn=hierarchy_loss_fn,
                  point_constraint=lambda n: n % 64 == 0,
                  constraint_msg="hierarchical decoder needs num_point "
                                 "divisible by 64"),
        ModelSpec(name="pcn_emd", decoder="folding",
                  loss_fn=PCNLoss(pcn_alpha_schedule()),
                  fold=(PCN_NUM_COARSE, PCN_GRID_SIZE), decay_per_step=True,
                  unsupported=("serving", "tensor parallelism",
                               "point parallelism"),
                  log_keys=("emd_coarse", "cd_fine")),
    )
}
# The families of the published reference, which the JAX package has too.
_REFERENCE = ("model", "model_cpu", "model_emd", "model_fc_upconv",
              "model_hierachy", "model_upconv")


def get_model_spec(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{available_models()}") from None


def available_models() -> List[str]:
    return sorted(_REGISTRY)


def reference_models() -> List[str]:
    """The published reference's families, the JAX package's registry."""
    return sorted(_REFERENCE)
