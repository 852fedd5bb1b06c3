"""The model's variables made from a seed on the device, in f32, named as
``benchmark/reference/model.py`` names them (the published model's
scopes, which the program's state dict keeps too): the published
initialization, what a training job starts from. Glorot-uniform dense
weights, zero biases, BatchNorm gamma 1, beta 0, moving mean 0 and
variance 1. The dense weights come from one uniform draw.

The leaf shapes are the caller's: by default PointNet's
(``benchmark/reference/model.py`` ``leaf_shapes``); a configuration with
a reference of its own passes that reference's shapes and gets the same
draw over them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from benchmark.reference.model import leaf_shapes

Tensor = torch.Tensor


@torch.no_grad()
def initial(config: Dict, g: torch.Generator, device: torch.device,
            shapes: Optional[Dict[str, Sequence[int]]] = None
            ) -> Dict[str, Tensor]:
    if shapes is None:
        shapes = leaf_shapes(config)
    dense = [k for k in shapes if k.endswith(".dense.weight")]
    sizes = [math.prod(shapes[k]) for k in dense]
    u = torch.rand(sum(sizes), generator=g, device=device)
    out = {}
    for k, part in zip(dense, u.split(sizes)):
        fan_out, fan_in = shapes[k]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out[k] = ((part * 2 - 1) * limit).reshape(shapes[k])
    for k, shape in shapes.items():
        if k not in out:
            fill = 1.0 if k.endswith((".bn.gamma", ".bn.var")) else 0.0
            out[k] = torch.full(shape, fill, device=device)
    return out

