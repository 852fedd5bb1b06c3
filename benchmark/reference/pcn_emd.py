"""PCN with its EMD loss (Yuan, Khot, Held, Mertz and Hebert, "PCN: Point
Completion Network", 3DV 2018; github.com/wentaoyuan/pcn,
``models/pcn_emd.py``, ``tf_util.py`` and ``train.py``) in plain PyTorch
float32 with TF32 off: the forward, the loss, its gradients and Adam.

It imports nothing of the program under test and nothing of JAX. The
CPU tests (``tests/test_torch_pcn.py``) hold the program to this file
too.

It follows PCN line by line:

- ``create_encoder``: two ``mlp_conv`` stages (per-point dense layers
  with biases, ReLU between them, the last linear): 3 -> 128 -> 256, the
  max over points tiled back onto every point and concatenated after the
  point's features (512), then 512 -> 512 -> 1024 and the max over
  points, the code.
- ``create_decoder``: ``mlp`` 1024 -> 1024 -> 1024 -> num_coarse * 3 (ReLU
  between), the coarse cloud; the folding: TF's ``meshgrid`` of
  ``linspace(-grid_scale, grid_scale, grid_size)`` twice, stacked and
  flattened, tiled onto every coarse point; each fine row is [grid (2),
  its coarse point (3), the code (1024)] through ``mlp_conv`` 512 -> 512
  -> 3, plus its coarse point, the centre. Fine row c * grid_size**2 + g
  belongs to coarse point c and grid row g.
- ``create_loss``: ``earth_mover(coarse, gt[:, :num_coarse])`` plus
  alpha times ``chamfer(fine, gt)``. ``earth_mover(pcd1, pcd2)`` is the
  mean over the batch of ``match_cost(pcd1, pcd2, approx_match(pcd1,
  pcd2)) / N``; ``chamfer`` is (mean sqrt(dist1) + mean sqrt(dist2)) / 2
  over ``nn_distance``'s squared distances.
- ``train.py``: alpha ``piecewise_constant(global_step, [10000, 20000,
  50000], [0.01, 0.1, 0.5, 1.0])`` (``values[i]`` while ``step <=
  boundaries[i]``); the learning rate ``exponential_decay(1e-4,
  global_step, 50000, 0.7, staircase=True)``, at least 1e-6; Adam.

Departures, each for a reason:

- Fixed-size inputs: every cloud of a batch has its N points, where PCN
  concatenates partial scans of different sizes and pools each by its
  ``npts``.
- No epsilon under the square roots, as PCN has none: a point that lands
  exactly on its nearest neighbour gives an infinite gradient there.
- The published ops' gradients in closed form, with the transport plan
  and the nearest neighbours held constant, as their registered
  gradients hold them (``tf_approxmatch``, ``tf_nndistance``); the plan
  is the published matching's arithmetic in the dense (B, N, M) form:
  10 levels j = 7..-2 at -4^j, the last at 0; capacities by integer
  division.
- Adam's epsilon is added to the bias-corrected root of the second
  moment, as the program's Adam does; TF's adds its epsilon before the
  correction.
- The fine Chamfer is computed in blocks of one shape and a slice of its
  points, so that it fits at (32, 16384, 16384); the EMD in blocks of
  batch rows.

Variables are named as the program's state dict names them
(``encoder.conv1.dense.weight``, ..., ``coarse.fc3.dense.bias``,
``folding.conv3.dense.bias``); a dense weight is (out, in).

``precision``: "f32" is the reference. "fp8" rounds both operands of every
matmul to float8 e4m3 with one scale per tensor (amax / 448), forward and
backward, accumulating in f32: a control, the step below the bf16 that
the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

Tensor = torch.Tensor

ENCODER = ("conv1", "conv2", "conv3", "conv4")
COARSE = ("fc1", "fc2", "fc3")
FOLDING = ("conv1", "conv2", "conv3")
EMD_LEVELS = tuple(0.0 if j == -2 else -(4.0 ** j) for j in range(7, -3, -1))
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


# -- the losses, with their gradients in closed form --------------------------


def sqdist(xyz1: Tensor, xyz2: Tensor) -> Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N, M) squared distances, summed
    ((dx*dx + dy*dy) + dz*dz) as the published ops do."""
    d2 = None
    for c in range(3):
        diff = xyz1[:, :, None, c] - xyz2[:, None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _batch_blocks(b: int, n: int, m: int, budget: int = 1 << 27):
    """Slices of batch rows whose (rows, N, M) f32 matrix fits ``budget``
    bytes."""
    rows = max(1, budget // (4 * n * m))
    return [slice(s, min(b, s + rows)) for s in range(0, b, rows)]


@torch.no_grad()
def approx_match(xyz1: Tensor, xyz2: Tensor) -> Tensor:
    """The annealed transport plan (B, N, M) of xyz1 (B, N, 3) against
    xyz2 (B, M, 3) (``tf_approxmatch`` ``approx_match``): the mass moved
    between xyz1 point k and xyz2 point l."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = (1.0, float(n // m)) if n >= m else (float(m // n),
                                                            1.0)
    d2 = sqdist(xyz1, xyz2)
    remain_l = xyz1.new_full((b, n), multi_l)
    remain_r = xyz1.new_full((b, m), multi_r)
    plan = torch.zeros_like(d2)
    for level in EMD_LEVELS:
        k = torch.exp(level * d2)
        ratio_l = remain_l / (1e-9 + torch.einsum("bnm,bm->bn", k, remain_r))
        sumr = torch.einsum("bnm,bn->bm", k, ratio_l) * remain_r
        ratio_r = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0) * remain_r
        remain_r = torch.clamp_min(remain_r - sumr, 0.0)
        w = k * ratio_l[:, :, None] * ratio_r[:, None, :]
        plan += w
        remain_l = torch.clamp_min(remain_l - w.sum(dim=2), 0.0)
    return plan


@torch.no_grad()
def earth_mover(pcd1: Tensor, pcd2: Tensor) -> Tuple[Tensor, Tensor]:
    """(PCN's ``earth_mover(pcd1, pcd2)``, its gradient with respect to
    pcd1 with the plan held constant), both f32."""
    pcd1, pcd2 = pcd1.float(), pcd2.float()
    b, n, _ = pcd1.shape
    if pcd2.shape[1] != n:
        raise ValueError("earth_mover takes clouds of one size")
    total = pcd1.new_zeros(())
    grad = torch.zeros_like(pcd1)
    for s in _batch_blocks(b, n, n):
        p, q = pcd1[s], pcd2[s]
        plan = approx_match(p, q)                     # (rows, N, N)
        d2 = sqdist(p, q)
        total += (plan * torch.sqrt(d2)).sum() / (n * b)
        w = plan * torch.rsqrt(torch.clamp_min(d2, 1e-20))
        # d/dp_k of sum_l w_kl ||p_k - q_l|| = sum_l w_kl (p_k - q_l) / d_kl
        grad[s] = (w.sum(dim=2)[:, :, None] * p
                   - torch.einsum("bnm,bmc->bnc", w, q)) / (n * b)
    return total, grad


@torch.no_grad()
def nearest(pcd1: Tensor, pcd2: Tensor, budget: int = 1 << 28
            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``nn_distance``: (dist1 (B, N), idx1, dist2 (B, M), idx2), the
    squared distance from each point to its nearest point of the other
    cloud and that point's index, the first minimum winning ties; one
    shape and a slice of pcd1's points at a time, each (rows, M) block
    within ``budget`` bytes."""
    b, n, _ = pcd1.shape
    m = pcd2.shape[1]
    rows = max(1, budget // (4 * m))
    dist1 = pcd1.new_empty((b, n))
    idx1 = torch.empty((b, n), dtype=torch.int64, device=pcd1.device)
    dist2 = pcd1.new_full((b, m), math.inf)
    idx2 = torch.zeros((b, m), dtype=torch.int64, device=pcd1.device)
    for i in range(b):
        q = pcd2[i:i + 1]
        for s in range(0, n, rows):
            d2 = sqdist(pcd1[i:i + 1, s:s + rows], q)[0]   # (rows, M)
            dist1[i, s:s + rows], idx1[i, s:s + rows] = d2.min(dim=1)
            col, at = d2.min(dim=0)
            better = col < dist2[i]
            dist2[i] = torch.where(better, col, dist2[i])
            idx2[i] = torch.where(better, at + s, idx2[i])
    return dist1, idx1, dist2, idx2


@torch.no_grad()
def chamfer(pcd1: Tensor, pcd2: Tensor) -> Tuple[Tensor, Tensor]:
    """(PCN's ``chamfer(pcd1, pcd2)``, (mean sqrt(dist1) + mean
    sqrt(dist2)) / 2, its gradient with respect to pcd1 with the nearest
    neighbours held constant), both f32."""
    pcd1, pcd2 = pcd1.float(), pcd2.float()
    b, n, _ = pcd1.shape
    m = pcd2.shape[1]
    dist1, idx1, dist2, idx2 = nearest(pcd1, pcd2)
    r1, r2 = torch.sqrt(dist1), torch.sqrt(dist2)
    total = (r1.mean() + r2.mean()) / 2.0
    near = torch.gather(pcd2, 1, idx1[:, :, None].expand(-1, -1, 3))
    grad = (pcd1 - near) / (r1[:, :, None] * (2.0 * b * n))
    back = ((torch.gather(pcd1, 1, idx2[:, :, None].expand(-1, -1, 3))
             - pcd2) / (r2[:, :, None] * (2.0 * b * m)))
    grad.scatter_add_(1, idx2[:, :, None].expand(-1, -1, 3), back)
    return total, grad


# -- the model ----------------------------------------------------------------


def folding_grid(grid_size: int, grid_scale: float,
                 device: torch.device) -> Tensor:
    """(grid_size**2, 2): ``tf.meshgrid(lin, lin)`` ("xy" indexing),
    stacked on the last axis and flattened: row i * grid_size + j is
    (lin[j], lin[i])."""
    lin = torch.linspace(-grid_scale, grid_scale, grid_size,
                         dtype=torch.float32, device=device)
    x = lin[None, :].expand(grid_size, grid_size)
    y = lin[:, None].expand(grid_size, grid_size)
    return torch.stack([x, y], dim=2).reshape(-1, 2)


class PCNReference:
    """The model's variables (f32 tensors on one device, by name), its
    schedules at the global step ``step`` and Adam's moments after ``t``
    of its own steps (``slots``, by name, or zeros)."""

    def __init__(self, config: Dict, variables: Dict[str, Tensor],
                 precision: str = "f32", step: int = 0,
                 slots: Optional[Dict[str, Tuple[Tensor, Tensor]]] = None,
                 t: int = 0):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got "
                             f"{precision!r}")
        self.config = config
        self.precision = precision
        self.num_coarse = int(config["num_coarse"])
        self.grid_size = int(config["grid_size"])
        if int(config["num_gt_point"]) != self.num_coarse * self.grid_size ** 2:
            raise ValueError("num_gt_point must be num_coarse * grid_size**2")
        self.params = {k: v.detach().float().clone()
                       for k, v in variables.items()}
        device = next(iter(self.params.values())).device
        self.grid = folding_grid(self.grid_size, float(config["grid_scale"]),
                                 device)
        self.slots = {k: (torch.zeros_like(v), torch.zeros_like(v))
                      for k, v in self.params.items()}
        if slots is not None:
            self.slots = {k: tuple(x.detach().float().to(v.device, copy=True)
                                   for x in slots[k])
                          for k, v in self.params.items()}
        self.step = step
        self.t = t
        exact_matmuls()

    def _dense(self, p: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
        w, b = p[f"{name}.dense.weight"], p[f"{name}.dense.bias"]
        if self.precision == "fp8":
            return _Fp8Linear.apply(x, w) + b
        return F.linear(x, w, b)

    def _mlp(self, p: Dict[str, Tensor], scope: str, layers: Sequence[str],
             x: Tensor) -> Tensor:
        """PCN's ``mlp`` / ``mlp_conv``: ReLU after every layer but the
        last."""
        for i, layer in enumerate(layers):
            x = self._dense(p, f"{scope}.{layer}", x)
            if i < len(layers) - 1:
                x = F.relu(x)
        return x

    def forward(self, p: Dict[str, Tensor], points: Tensor
                ) -> Tuple[Tensor, Tensor]:
        """(coarse (B, num_coarse, 3), fine (B, num_fine, 3))."""
        b = points.shape[0]
        x = self._mlp(p, "encoder", ENCODER[:2], points.float())
        pooled = x.amax(dim=1, keepdim=True).expand_as(x)
        x = self._mlp(p, "encoder", ENCODER[2:], torch.cat([x, pooled], 2))
        code = x.amax(dim=1)                                  # (B, 1024)
        coarse = self._mlp(p, "coarse", COARSE, code).reshape(
            b, self.num_coarse, 3)
        g = self.grid.shape[0]
        fine_n = self.num_coarse * g
        grid_feat = self.grid[None].expand(b * self.num_coarse, g, 2
                                           ).reshape(b, fine_n, 2)
        centre = coarse[:, :, None, :].expand(b, self.num_coarse, g, 3
                                              ).reshape(b, fine_n, 3)
        global_feat = code[:, None, :].expand(b, fine_n, code.shape[1])
        feat = torch.cat([grid_feat, centre, global_feat], dim=2)
        fine = self._mlp(p, "folding", FOLDING, feat) + centre
        return coarse, fine

    # -- schedules ------------------------------------------------------------

    def learning_rate(self) -> float:
        opt = self.config["optimizer"]
        lr = (opt["learning_rate"] * opt["decay_rate"]
              ** math.floor(self.step / opt["decay_steps"]))
        return max(lr, opt["lr_floor"])

    def alpha(self) -> float:
        a = self.config["alpha"]
        passed = sum(self.step > b for b in a["boundaries"])
        return float(a["values"][passed])

    # -- the train step -------------------------------------------------------

    def train_step(self, inputs: Tensor, target: Tensor) -> Dict:
        """One step on (inputs, target): the loss and its two terms, and
        each parameter's gradient as Adam receives it; the variables
        move."""
        lr, alpha = self.learning_rate(), self.alpha()
        p = {k: v.detach().requires_grad_(True)
             for k, v in self.params.items()}
        with torch.enable_grad():
            coarse, fine = self.forward(p, inputs)
            emd, g_coarse = earth_mover(coarse.detach(),
                                        target[:, :self.num_coarse])
            cd, g_fine = chamfer(fine.detach(), target)
            grads = torch.autograd.grad(
                [coarse, fine], list(p.values()),
                grad_outputs=[g_coarse, alpha * g_fine], allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), grads)}
        self._adam(grads, lr)
        self.step += 1
        return {"loss": float(emd + alpha * cd), "emd": float(emd),
                "cd": float(cd), "grads": grads}

    @torch.no_grad()
    def _adam(self, grads: Dict[str, Tensor], lr: float) -> None:
        opt = self.config["optimizer"]
        b1, b2, eps = opt["beta1"], opt["beta2"], opt["epsilon"]
        self.t += 1
        for k, g in grads.items():
            m, v = self.slots[k]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / math.sqrt(1.0 - b2 ** self.t)).add_(eps)
            self.params[k].addcdiv_(m, denom,
                                    value=-lr / (1.0 - b1 ** self.t))


def leaf_shapes(config: Dict) -> Dict[str, Sequence[int]]:
    """Each variable's shape at the configuration's widths
    (``encoder_widths``: the two stages', ``coarse_widths``,
    ``folding_widths``: the hidden layers')."""
    (a, b), (c, d) = config["encoder_widths"]
    code = d
    coarse = [code] + list(config["coarse_widths"]) + [
        3 * int(config["num_coarse"])]
    folding = [2 + 3 + code] + list(config["folding_widths"]) + [3]
    layers = [("encoder.conv1", 3, a), ("encoder.conv2", a, b),
              ("encoder.conv3", 2 * b, c), ("encoder.conv4", c, d)]
    layers += [(f"coarse.{n}", i, o)
               for n, i, o in zip(COARSE, coarse[:-1], coarse[1:])]
    layers += [(f"folding.{n}", i, o)
               for n, i, o in zip(FOLDING, folding[:-1], folding[1:])]
    shapes = {}
    for name, cin, cout in layers:
        shapes[f"{name}.dense.weight"] = (cout, cin)
        shapes[f"{name}.dense.bias"] = (cout,)
    return shapes
