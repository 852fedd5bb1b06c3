"""Fused encoder head for training: Dense -> BatchNorm -> ReLU -> max over
points, with the (B*N, F) activation never stored.

Counterpart of ``pointnet_autoencoder_tpu/ops/fused_head.py``:

- ``head_stats``: the exact biased batch (mean, var) of y = x @ w + b from
  the moments of x (mean = E[x] @ w + b, E[y^2] = diag(w^T S w) +
  2 b (E[x] @ w) + b^2 with S = x^T x / P), in plain PyTorch under autograd,
  so the BatchNorm gradient's through-the-statistics terms come from
  autograd, as they come from XLA in the reference.
- ``fused_dense_bn_relu_max``: an autograd Function. Forward is the
  kernel K3 (``csrc/fused_head.cu``, via ``head_max_cuda``) on CUDA
  tensors and ``head_max_plain`` on CPU tensors; backward is the closed
  form of the reference's ``_head_max_bwd`` (fused_head.py:287-329) for
  b, gamma, beta, mean and var, and the kernel K4 (``head_bwd_cuda``) or
  ``head_bwd_plain`` for dx and dw. The plain versions are the
  reference's ``impl == "xla"`` branches.

A CUDA tensor goes to the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointnet_autoencoder_tpu_torch.csrc import build as _build
from pointnet_autoencoder_tpu_torch.ops.fused_encoder import fold_affine

Tensor = torch.Tensor

# C entry points of csrc/fused_head.cu: (argtypes, restype).
_SIGNATURES = {
    "pcae_head_tile_n": ([], ctypes.c_int),
    "pcae_head_channels": ([], ctypes.c_int),
    "pcae_head_feature_multiple": ([], ctypes.c_int),
    "pcae_fused_head_fwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
        ctypes.c_int),
    "pcae_fused_head_bwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
        ctypes.c_int),
}


def head_stats(x: Tensor, w: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Biased batch (mean, var), both f32 (F,), of y = x @ w + b over all
    leading axes of x, from the first and second moments of x.

    x: (..., C) and w: (C, F) in the matmul dtype (bf16 values multiply
    exactly in f32, so the products run in f32 on them)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    p = xf.shape[0]
    w32 = w.float()
    b32 = b.float()
    mm = xf.mean(dim=0) @ w32  # E[x @ w], (F,)
    s = (xf.t() @ xf) / p  # (C, C) second moment
    ey2 = ((s @ w32) * w32).sum(dim=0) + 2.0 * b32 * mm + b32 * b32
    mean = mm + b32
    var = torch.clamp_min(ey2 - mean * mean, 0.0)
    return mean, var


def _check_head(x: Tensor, w: Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or x.shape[2] != w.shape[0]:
        raise ValueError(f"expected x (B, N, C) and w (C, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if 0 in x.shape or 0 in w.shape:
        raise ValueError(f"empty input: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")


def _load_for(x: Tensor, w: Tensor, tensors, what: str):
    """The kernel library, after checking devices, types and widths."""
    _check_head(x, w)
    if not all(t.is_cuda and t.device == x.device for t in (x, w, *tensors)):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"{what} takes x and w both float32 or both "
                         f"bfloat16, got {x.dtype} and {w.dtype}")
    lib = _build.load("fused_head", _SIGNATURES)
    c, f = w.shape
    if c != lib.pcae_head_channels() or f % lib.pcae_head_feature_multiple():
        raise ValueError(
            f"{what} takes C == {lib.pcae_head_channels()} input channels "
            f"and F a multiple of {lib.pcae_head_feature_multiple()}, got "
            f"C={c}, F={f}")
    return lib


def head_max_plain(x: Tensor, w: Tensor, scale: Tensor,
                   shift: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K3: (max (B, F) f32, argmax (B, F) int32)
    over points of relu((x @ w) * scale + shift); the first point wins
    ties. Products of the matmul type are exact in f32, so the product
    runs in f32 (f32 accumulation, as the kernel)."""
    y = torch.matmul(x.float(), w.float())
    o = torch.clamp_min(y * scale + shift, 0.0)
    val, arg = o.max(dim=1)  # first maximum wins, like argmax
    return val, arg.int()


def head_max_cuda(x: Tensor, w: Tensor, scale: Tensor,
                  shift: Tensor) -> Tuple[Tensor, Tensor]:
    """K3 on CUDA tensors: x (B, N, 128) and w (128, F) both f32 or both
    bf16, F a multiple of 256, scale/shift (F,) f32; same outputs as
    ``head_max_plain``. Adds one to ``head_max_cuda.launches`` per launch
    (the tile kernel and its reduction over tiles)."""
    lib = _load_for(x, w, (scale, shift), "head_max_cuda")
    if scale.shape != (w.shape[1],) or shift.shape != (w.shape[1],):
        raise ValueError(f"head_max_cuda: expected scale and shift of shape "
                         f"{(w.shape[1],)}, got {tuple(scale.shape)} and "
                         f"{tuple(shift.shape)}")
    x, w = x.contiguous(), w.contiguous()
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    b, n, _ = x.shape
    f = w.shape[1]
    dev = x.device
    tiles = -(-n // lib.pcae_head_tile_n())
    part_max = torch.empty((b, tiles, f), dtype=torch.float32, device=dev)
    part_arg = torch.empty((b, tiles, f), dtype=torch.int32, device=dev)
    out_max = torch.empty((b, f), dtype=torch.float32, device=dev)
    out_arg = torch.empty((b, f), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pcae_fused_head_fwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), w.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), part_max.data_ptr(),
            part_arg.data_ptr(), out_max.data_ptr(), out_arg.data_ptr(), b,
            n, f, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused head forward kernel")
    head_max_cuda.launches += 1
    return out_max, out_arg


head_max_cuda.launches = 0


def head_bwd_plain(x: Tensor, w: Tensor, gvals: Tensor,
                   argmax: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K4: (dx (B, N, C) in x's dtype, dw (C, F)
    f32) from the one-hot cotangent, gvals (B, F) f32 at rows argmax
    (B, F). The dense scatter and two products of the reference's xla
    branch; gvals is rounded to the activation type first, as the TPU
    kernel does (fused_head.py:190)."""
    b, n, _ = x.shape
    gy = torch.zeros((b, n, w.shape[1]), dtype=torch.float32,
                     device=x.device)
    gy.scatter_(1, argmax.long()[:, None, :], gvals.float()[:, None, :])
    gy = gy.to(x.dtype).float()
    dx = torch.einsum("bnf,cf->bnc", gy, w.float()).to(x.dtype)
    dw = torch.einsum("bnc,bnf->cf", x.float(), gy)
    return dx, dw


def head_bwd_cuda(x: Tensor, w: Tensor, gvals: Tensor,
                  argmax: Tensor) -> Tuple[Tensor, Tensor]:
    """K4 on CUDA tensors (shapes and types as ``head_max_cuda``; gvals
    (B, F) f32, argmax (B, F) int32 from K3); same outputs as
    ``head_bwd_plain``, dx up to the order of its atomic sums. Adds one to
    ``head_bwd_cuda.launches`` per launch."""
    lib = _load_for(x, w, (gvals, argmax), "head_bwd_cuda")
    b, n, _ = x.shape
    c, f = w.shape
    if (gvals.shape != (b, f) or argmax.shape != (b, f)
            or argmax.dtype != torch.int32):
        raise ValueError(f"head_bwd_cuda: expected gvals and int32 argmax of "
                         f"shape {(b, f)}, got {tuple(gvals.shape)} and "
                         f"{argmax.dtype} {tuple(argmax.shape)}")
    x, w = x.contiguous(), w.contiguous()
    gvals = gvals.float().contiguous()
    argmax = argmax.contiguous()
    dev = x.device
    dx = torch.empty((b, n, c), dtype=x.dtype, device=dev)
    dx32 = dx if x.dtype == torch.float32 else torch.empty(
        (b, n, c), dtype=torch.float32, device=dev)
    dw = torch.empty((c, f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pcae_fused_head_bwd(
            int(x.dtype == torch.bfloat16), x.data_ptr(), w.data_ptr(),
            gvals.data_ptr(), argmax.data_ptr(), dx32.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), b, n, f,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused head backward kernel")
    head_bwd_cuda.launches += 1
    return dx, dw


head_bwd_cuda.launches = 0


class _HeadMax(torch.autograd.Function):
    """max over points of relu(batchnorm(x @ w + b)) with the given
    statistics; backward from the one-hot cotangent the max leaves."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, mean, var, eps):
        scale, shift = fold_affine(b, gamma, beta, mean, var, eps)
        fwd = head_max_cuda if x.is_cuda else head_max_plain
        maxout, argmax = fwd(x, w, scale, shift)
        ctx.save_for_backward(x, w, b, gamma, beta, var, maxout, argmax)
        ctx.eps = eps
        return maxout

    @staticmethod
    def backward(ctx, g):
        x, w, b, gamma, beta, var, maxout, argmax = ctx.saved_tensors
        g = g.float()
        gamma32 = gamma.float()
        inv = torch.rsqrt(var.float() + ctx.eps)
        scale = gamma32 * inv
        alive = (maxout > 0.0).float()
        dy_sel = g * alive  # (B, F): cotangent of o at the argmax point
        # xhat at the argmax, reconstructed from the max value; a zero
        # gamma contributes nothing (the derivative has a kink there).
        safe_gamma = torch.where(gamma32 == 0.0, 1.0, gamma32)
        xhat_star = torch.where(gamma32 == 0.0, 0.0,
                                (maxout - beta.float()) / safe_gamma)
        sum_dy = dy_sel.sum(dim=0)
        sum_dyx = (dy_sel * xhat_star).sum(dim=0)
        dgamma = sum_dyx
        dbeta = sum_dy
        dmean = -scale * sum_dy
        dvar = -0.5 * inv * inv * gamma32 * sum_dyx
        db = scale * sum_dy
        gvals = dy_sel * scale  # (B, F): dL/dy at the argmax rows
        bwd = head_bwd_cuda if x.is_cuda else head_bwd_plain
        dx, dw = bwd(x, w, gvals, argmax)
        return (dx, dw.to(w.dtype), db.to(b.dtype), dgamma, dbeta, dmean,
                dvar, None)


def fused_dense_bn_relu_max(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor,
                            beta: Tensor, mean: Tensor, var: Tensor,
                            eps: float = 1e-3) -> Tensor:
    """max over axis 1 of relu(batchnorm(x @ w + b)) -> (B, F) f32.

    x: (B, N, C) and w: (C, F) in the matmul dtype (f32 or bf16); b may be
    either; gamma/beta/mean/var f32. Normalization uses the given mean and
    var (batch statistics from ``head_stats`` in training), and their
    gradients are returned, so composing with ``head_stats`` under
    autograd gives the full BatchNorm gradient."""
    _check_head(x, w)
    return _HeadMax.apply(x, w, b, gamma, beta, mean, var, eps)
