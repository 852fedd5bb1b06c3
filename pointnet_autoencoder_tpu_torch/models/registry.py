"""Model registry: ``--model`` names -> ModelSpec.

Counterpart of ``pointnet_autoencoder_tpu/models/registry.py``. Ported so
far: ``model`` (fc decoder, no neck, Chamfer x100 loss). ``model_cpu``
and the other families follow with later slices.
"""

from __future__ import annotations

from typing import Dict

from pointnet_autoencoder_tpu_torch.models.autoencoder import (
    ModelSpec,
    chamfer_x100_loss,
)

_REGISTRY: Dict[str, ModelSpec] = {
    spec.name: spec for spec in (
        ModelSpec(name="model", decoder="fc", loss_fn=chamfer_x100_loss),
    )
}


def get_model_spec(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown or not yet ported model {name!r}; available: "
            f"{sorted(_REGISTRY)}") from None
