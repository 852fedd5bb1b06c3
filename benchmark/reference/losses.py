"""The two losses of the reference model, in plain PyTorch f32, with their
gradients in closed form (the nearest neighbour, and the transport plan,
held constant, as the published ops' registered gradients do):

- Chamfer: pcloss = mean_i d(pred_i, label) + mean_j d(label_j, pred),
  d the squared distance to the nearest point of the other cloud
  (reference ``models/model.py``: ``tf_nndistance``).
- Approximate EMD (reference ``models/model_emd.py``, ``tf_approxmatch``):
  the annealed matching of the label against the prediction, 10 levels
  j = 7..-2 with level -4^j and the last 0, then mean over the batch of
  sum_kl plan_lk ||label_k - pred_l||. A copy of the matching's published
  arithmetic, in the dense (B, N, M) form.

Every function works in blocks of batch rows, so a (B, N, M) matrix never
exists whole.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

EMD_LEVELS = tuple(0.0 if j == -2 else -(4.0 ** j) for j in range(7, -3, -1))


def sqdist(xyz1: Tensor, xyz2: Tensor) -> Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N, M) squared distances, summed
    ((dx*dx + dy*dy) + dz*dz) as the published op does."""
    d2 = None
    for c in range(3):
        diff = xyz1[:, :, None, c] - xyz2[:, None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _blocks(b: int, n: int, m: int, budget: int = 1 << 28):
    """Slices of batch rows whose (rows, N, M) f32 matrix fits ``budget``
    bytes."""
    rows = max(1, budget // (4 * n * m))
    return [slice(s, min(b, s + rows)) for s in range(0, b, rows)]


@torch.no_grad()
def chamfer(pred: Tensor, label: Tensor) -> Tuple[Tensor, Tensor]:
    """(pcloss, its gradient with respect to pred), both f32."""
    pred, label = pred.float(), label.float()
    b, n, _ = pred.shape
    m = label.shape[1]
    total = pred.new_zeros(())
    grad = torch.zeros_like(pred)
    for s in _blocks(b, n, m):
        p, q = pred[s], label[s]
        d2 = sqdist(p, q)
        d1, i1 = d2.min(dim=2)            # pred point -> nearest label
        d2m, i2 = d2.min(dim=1)           # label point -> nearest pred
        total += d1.sum() / (b * n) + d2m.sum() / (b * m)
        near = torch.gather(q, 1, i1[:, :, None].expand(-1, -1, 3))
        grad[s] += 2.0 * (p - near) / (b * n)
        back = 2.0 * (torch.gather(p, 1, i2[:, :, None].expand(-1, -1, 3))
                      - q) / (b * m)
        grad[s].scatter_add_(1, i2[:, :, None].expand(-1, -1, 3), back)
    return total, grad


@torch.no_grad()
def approx_match(xyz1: Tensor, xyz2: Tensor) -> Tensor:
    """The annealed transport plan (B, N, M) of xyz1 (B, N, 3) against
    xyz2 (B, M, 3): the mass moved between xyz1 point k and xyz2 point l.
    Capacities by integer division, as the published op."""
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
def emd(pred: Tensor, label: Tensor) -> Tuple[Tensor, Tensor]:
    """(mean over the batch of EMD(label -> pred), its gradient with
    respect to pred with the plan held constant), both f32."""
    pred, label = pred.float(), label.float()
    b, n, _ = label.shape
    m = pred.shape[1]
    total = pred.new_zeros(())
    grad = torch.zeros_like(pred)
    for s in _blocks(b, n, m, budget=1 << 27):
        q, p = label[s], pred[s]
        plan = approx_match(q, p)                     # (rows, N, M)
        d2 = sqdist(q, p)
        total += (plan * torch.sqrt(d2)).sum() / b
        w = plan * torch.rsqrt(torch.clamp_min(d2, 1e-20))
        # d/dp_l of sum_k w_kl ||q_k - p_l|| = sum_k w_kl (p_l - q_k) / d_kl
        grad[s] = (w.sum(dim=1)[:, :, None] * p
                   - torch.einsum("bnm,bnc->bmc", w, q)) / b
    return total, grad


LOSSES = {"chamfer_x100": lambda pred, label: _scaled(chamfer(pred, label),
                                                      100.0),
          "emd": emd}


def _scaled(loss_grad, scale: float):
    loss, grad = loss_grad
    return loss * scale, grad * scale
