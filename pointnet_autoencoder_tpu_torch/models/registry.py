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
"""

from __future__ import annotations

from typing import Dict, List

from pointnet_autoencoder_tpu_torch.models.autoencoder import (
    ModelSpec,
    chamfer_x100_dense_loss,
    chamfer_x100_loss,
    emd_loss_fn,
    hierarchy_loss_fn,
)

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
    )
}


def get_model_spec(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{available_models()}") from None


def available_models() -> List[str]:
    return sorted(_REGISTRY)
