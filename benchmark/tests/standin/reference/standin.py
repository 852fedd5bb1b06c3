"""The plain reference of the stand-in configuration (``configs/standin.json``),
a model that ``benchmark/reference/model.py`` does not describe: a
per-point Dense layer and ReLU, a max over points, and a Dense layer to
the cloud, no BatchNorm, trained on the Chamfer distance with Adam. Plain
PyTorch f32 (TF32 off); it imports nothing of the program.

``precision``: "f32" is the reference; "fp8" rounds both operands of each
matmul to float8 e4m3 under one scale a tensor, gradient passed straight
through: the control.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch.nn import functional as F

Tensor = torch.Tensor
E4M3_MAX = 448.0


def leaf_shapes(config: Dict) -> Dict[str, Sequence[int]]:
    """Each variable's shape, named as the program's state dict names it."""
    n, w = int(config["num_point"]), int(config["code_width"])
    return {"encoder.fc1.dense.weight": (w, 3),
            "encoder.fc1.dense.bias": (w,),
            "decoder.fc2.dense.weight": (3 * n, w),
            "decoder.fc2.dense.bias": (3 * n,)}


def _fp8(x: Tensor) -> Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def forward(params: Dict[str, Tensor], points: Tensor,
            precision: str = "f32") -> Tensor:
    def dense(name: str, x: Tensor) -> Tensor:
        w = params[f"{name}.dense.weight"]
        if precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return F.linear(x, w, params[f"{name}.dense.bias"])

    code = F.relu(dense("encoder.fc1", points.float())).amax(dim=1)
    return dense("decoder.fc2", code).reshape(points.shape)


def chamfer(pred: Tensor, label: Tensor) -> Tensor:
    """Mean squared distance to the nearest point of the other cloud, both
    ways, averaged over the batch."""
    d2 = (pred[:, :, None, :] - label[:, None, :, :]).square().sum(-1)
    return d2.amin(dim=2).mean() + d2.amin(dim=1).mean()


class Reference:
    """The variables (f32, by name) and the train step."""

    def __init__(self, config: Dict, variables: Dict[str, Tensor],
                 precision: str = "f32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.precision = precision
        self.params = {k: v.detach().float().clone()
                       for k, v in variables.items()}
        self.slots = {k: (torch.zeros_like(v), torch.zeros_like(v))
                      for k, v in self.params.items()}
        self.step = 0

    def train_step(self, batch: Tensor) -> float:
        opt = self.config["optimizer"]
        p = {k: v.detach().requires_grad_(True)
             for k, v in self.params.items()}
        with torch.enable_grad():
            loss = chamfer(forward(p, batch, self.precision), batch.float())
            grads = torch.autograd.grad(loss, list(p.values()))
        b1, b2, eps = opt["beta1"], opt["beta2"], opt["epsilon"]
        t = self.step + 1
        with torch.no_grad():
            for k, g in zip(p, grads):
                m, v = self.slots[k]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
                self.params[k].addcdiv_(
                    m, denom, value=-opt["learning_rate"] / (1.0 - b1 ** t))
        self.step += 1
        return float(loss.detach())
