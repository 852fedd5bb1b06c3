"""The published PointNet autoencoder (charlesq34/pointnet-autoencoder,
``models/model.py`` and ``models/model_emd.py``) in plain PyTorch f32: the
encoder's five per-point Dense+BN+ReLU layers and a max over points, the
FC decoder (Dense+BN+ReLU, Dense+BN+ReLU, Dense), BatchNorm with the
momentum of the bn_decay schedule, the loss, its gradients by autograd
(the losses' own gradients in closed form, ``losses.py``), and Adam.

Variables are named as the published model's scopes nest them
(``encoder.conv1.dense.weight``, ``encoder.conv1.bn.gamma``, ...,
``decoder.fc3.dense.bias``); a dense weight is (out, in). BatchNorm
(the reference's ``tf_util.batch_norm_template``): training normalizes by
the biased batch moments over every axis but the channel, eps 1e-3, and
moves ``mean`` and ``var`` as m * moving + (1 - m) * batch.

``precision``: "f32" is the reference (TF32 off). "fp8" rounds both
operands of every matmul to float8 e4m3 with one scale per tensor (amax /
448), forward and backward, accumulating in f32: the benchmark's
control, the step below the bf16 that the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from benchmark.reference import losses

Tensor = torch.Tensor

ENCODER = ("conv1", "conv2", "conv3", "conv4", "conv5")
DECODER_BN = ("fc1", "fc2")
E4M3_MAX = 448.0


def exact_matmuls() -> None:
    """Full f32 products on a card: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, gradient passed
    straight through."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class _Fp8Linear(torch.autograd.Function):
    """x @ w.T with both operands in fp8 forward, and the output gradient
    rounded to fp8 in both backward products."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return gx, gw


class ReferenceModel:
    """The model's variables (f32 tensors on one device, by name) and its
    train step."""

    def __init__(self, config: Dict, variables: Dict[str, Tensor],
                 precision: str = "f32",
                 slots: Optional[Dict[str, Tuple[Tensor, Tensor]]] = None,
                 step: int = 0):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got "
                             f"{precision!r}")
        self.config = config
        self.precision = precision
        self.eps = float(config["bn_epsilon"])
        self.num_point = int(config["num_point"])
        self.loss = losses.LOSSES[config["loss"]]
        self.params = {k: v.detach().float().clone()
                       for k, v in variables.items()
                       if not k.endswith((".bn.mean", ".bn.var"))}
        self.buffers = {k: v.detach().float().clone()
                        for k, v in variables.items()
                        if k.endswith((".bn.mean", ".bn.var"))}
        self.slots = {k: (torch.zeros_like(v), torch.zeros_like(v))
                      for k, v in self.params.items()}
        if slots is not None:
            # Adam's moments after ``step`` steps taken elsewhere.
            self.slots = {k: tuple(x.detach().float().to(v.device, copy=True)
                                   for x in slots[k])
                          for k, v in self.params.items()}
        self.step = step
        exact_matmuls()

    # -- layers ---------------------------------------------------------------

    def _dense(self, p: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
        w, b = p[f"{name}.dense.weight"], p[f"{name}.dense.bias"]
        if self.precision == "fp8":
            return _Fp8Linear.apply(x, w) + b
        return F.linear(x, w, b)

    def _bn(self, p: Dict[str, Tensor], name: str, y: Tensor,
            momentum: float) -> Tensor:
        """Training BatchNorm of ``y``; the moving statistics move."""
        axes = tuple(range(y.dim() - 1))
        mean = y.mean(dim=axes)
        var = torch.clamp_min(y.square().mean(dim=axes) - mean.square(), 0.0)
        with torch.no_grad():
            for key, batch in (("mean", mean), ("var", var)):
                buf = self.buffers[f"{name}.bn.{key}"]
                buf.mul_(momentum).add_((1.0 - momentum) * batch.detach())
        return ((y - mean) * torch.rsqrt(var + self.eps)
                * p[f"{name}.bn.gamma"] + p[f"{name}.bn.beta"])

    def _forward(self, p: Dict[str, Tensor], points: Tensor,
                 momentum: float) -> Tensor:
        x = points.float()
        for name in ENCODER:
            key = f"encoder.{name}"
            x = F.relu(self._bn(p, key, self._dense(p, key, x), momentum))
        feat = x.amax(dim=1)
        for name in DECODER_BN:
            key = f"decoder.{name}"
            feat = F.relu(self._bn(p, key, self._dense(p, key, feat),
                                   momentum))
        out = self._dense(p, "decoder.fc3", feat)
        return out.reshape(points.shape[0], self.num_point, 3)

    # -- schedules ------------------------------------------------------------

    def _exponent(self, batch: int) -> int:
        return math.floor(self.step * batch / self.config["decay_step"])

    def learning_rate(self, batch: int) -> float:
        opt = self.config["optimizer"]
        return (opt["learning_rate"]
                * opt["decay_rate"] ** self._exponent(batch))

    def bn_momentum(self, batch: int) -> float:
        bn = self.config["bn_decay"]
        return min(bn["clip"], 1.0 - bn["init"] * bn["rate"]
                   ** self._exponent(batch))

    # -- the train step -------------------------------------------------------

    def train_step(self, batch: Tensor) -> Dict:
        """One step on ``batch`` (its own label): the loss, and each
        parameter's gradient as Adam receives it; the variables move."""
        b = batch.shape[0]
        lr, momentum = self.learning_rate(b), self.bn_momentum(b)
        p = {k: v.detach().requires_grad_(True)
             for k, v in self.params.items()}
        with torch.enable_grad():
            pred = self._forward(p, batch, momentum)
            loss, g_pred = self.loss(pred.detach(), batch)
            grads = torch.autograd.grad(pred, list(p.values()),
                                        grad_outputs=g_pred,
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), grads)}
        self._adam(grads, lr)
        self.step += 1
        return {"loss": float(loss), "grads": grads}

    @torch.no_grad()
    def _adam(self, grads: Dict[str, Tensor], lr: float) -> None:
        opt = self.config["optimizer"]
        b1, b2, eps = opt["beta1"], opt["beta2"], opt["epsilon"]
        t = self.step + 1
        for k, g in grads.items():
            m, v = self.slots[k]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
            self.params[k].addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))

    @torch.no_grad()
    def head_argmax_rows(self, points: Tensor) -> int:
        """The distinct rows (shape, point) at which conv5's training
        output, relu(bn(x @ w + b)) with the batch's statistics, takes its
        maximum over points, counted over every shape and channel: the rows
        of x that the head's backward reads."""
        x = points.float()
        for name in ENCODER[:-1]:
            key = f"encoder.{name}"
            x = F.relu(self._bn_stats(key, self._dense(self.params, key, x)))
        key = "encoder.conv5"
        y = F.relu(self._bn_stats(key, self._dense(self.params, key, x)))
        arg = y.argmax(dim=1)                                 # (B, F)
        rows = arg + y.shape[1] * torch.arange(y.shape[0],
                                               device=y.device)[:, None]
        return int(torch.unique(rows).numel())

    def _bn_stats(self, name: str, y: Tensor) -> Tensor:
        """Training BatchNorm of ``y`` without moving the statistics."""
        axes = tuple(range(y.dim() - 1))
        mean = y.mean(dim=axes)
        var = torch.clamp_min(y.square().mean(dim=axes) - mean.square(), 0.0)
        return ((y - mean) * torch.rsqrt(var + self.eps)
                * self.params[f"{name}.bn.gamma"]
                + self.params[f"{name}.bn.beta"])

    def variables(self) -> Dict[str, Tensor]:
        return {**self.params, **self.buffers}


def leaf_names(config: Dict) -> List[str]:
    """Every variable of the model, by name."""
    names = []
    for scope, layers in (("encoder", ENCODER),
                          ("decoder", DECODER_BN + ("fc3",))):
        for layer in layers:
            names += [f"{scope}.{layer}.dense.weight",
                      f"{scope}.{layer}.dense.bias"]
            if layer != "fc3":
                names += [f"{scope}.{layer}.bn.{k}"
                          for k in ("gamma", "beta", "mean", "var")]
    return names


def leaf_shapes(config: Dict) -> Dict[str, Sequence[int]]:
    """Each variable's shape at the configuration's widths."""
    enc = [3] + list(config["encoder_widths"])
    dec = ([enc[-1]] + list(config["decoder_widths"])
           + [3 * int(config["num_point"])])
    shapes = {}
    for scope, layers, widths in (("encoder", ENCODER, enc),
                                  ("decoder", DECODER_BN + ("fc3",), dec)):
        for layer, cin, cout in zip(layers, widths[:-1], widths[1:]):
            shapes[f"{scope}.{layer}.dense.weight"] = (cout, cin)
            shapes[f"{scope}.{layer}.dense.bias"] = (cout,)
            if layer != "fc3":
                for k in ("gamma", "beta", "mean", "var"):
                    shapes[f"{scope}.{layer}.bn.{k}"] = (cout,)
    return shapes
