"""Training BatchNorm with its ReLU: the batch statistics, the moving
update, the normalization and the ReLU in one autograd Function, K7.

The layers' training BatchNorm (``nn/layers.py`` ``BatchNorm`` in
``PointMLP``, ``FC``, ``UpConv`` and ``Conv``) comes here through
``batch_norm_train``. The arithmetic is the reference's
(``pointnet_autoencoder_tpu/nn/layers.py`` BatchNorm): over every axis
but the last, in f32, the moments (E[y], E[y^2]); var = max(E[y^2] -
E[y]^2, 0); the moving statistics move in place, ``moving = mom *
moving + (1 - mom) * batch``; inv = rsqrt(var + eps) * gamma, shift = beta
- mean * inv; out = relu(y * inv + shift).

On CUDA tensors the work is K7 (``csrc/batch_norm.cu``): forward
``batch_norm_fwd_cuda`` (column sums, their fixed-order reduction, the
apply pass with the moving update), backward ``batch_norm_bwd_cuda`` (the
masked sums, their reduction, dx); each adds one to its ``launches`` a
call. K7 applies the affine in f32 and rounds once to y's type, and its
backward is the closed form of the chain's gradient: with g' the
cotangent behind the ReLU mask (recomputed from y and the moments, the
forward's bit for bit), xhat = (y - mean) * rsqrt(var + eps), S1 = sum g'
and S2 = sum g' * xhat over the P rows, dgamma = S2, dbeta = S1 and dy =
inv * (g' - S1 / P - xhat * S2 / P), the S2 term dropped where the clamp
took the variance below 0 (where torch.clamp_min passes no gradient).
It saves only y and the (2, C) moments.

CPU tensors take ``batch_norm_fwd_plain`` and ``batch_norm_bwd_plain``:
the chain as the layers ran it before K7, op by op (the affine applied in
y's type), and its gradient by autograd over the chain recomputed, so the
CPU's results are that chain's bit for bit (float64 inputs stay float64).
A CUDA tensor goes to the kernel or raises; there is no fallback. Each
direction runs inside ``utils/roofline.charge`` ("batch_norm_fwd",
"batch_norm_bwd").

``group`` (a ``parallel.mesh.DataGroup``) makes the statistics the global
batch's over equal shards: the (2, C) moments go through one
``all_reduce_mean`` before the affine, and their cotangent (K7: the sums
(S1, S2)) through one more in the backward; dgamma and dbeta stay this
rank's, as the autograd chain left them for the gradient all-reduce.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from pointnet_autoencoder_tpu_torch.csrc import build as _build
from pointnet_autoencoder_tpu_torch.utils import roofline

Tensor = torch.Tensor

# C entry points of csrc/batch_norm.cu: (argtypes, restype).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "pcae_bn_max_partials": ([], _I),
    "pcae_bn_moments": ([_I, _P, _P, _P, _L, _I, _P], _I),
    "pcae_bn_apply": ([_I] + [_P] * 8 + [_F, _L, _I, _I, _P], _I),
    "pcae_bn_grad_sums": ([_I] + [_P] * 5 + [_F, _P, _P, _L, _I, _I, _P],
                          _I),
    "pcae_bn_dx": ([_I] + [_P] * 5 + [_F, _P, _P, _L, _I, _I, _P], _I),
}


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The statistics' type: f32, or float64 for float64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _momentum(momentum: Union[float, Tensor], like: Tensor) -> Tensor:
    """The momentum as a 0-dim tensor of ``like``'s type and device."""
    if torch.is_tensor(momentum):
        return momentum.to(device=like.device, dtype=like.dtype)
    return torch.full((), momentum, dtype=like.dtype, device=like.device)


class _Gathered(torch.autograd.Function):
    """The group's mean of the moments, taken by the forward already:
    returns it; backward, as ``all_reduce_mean``'s, the mean of the
    cotangents over the ranks."""

    @staticmethod
    def forward(ctx, local, gathered, group):
        ctx.group = group
        return gathered.clone()

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_mean(grad), None, None


def _moments(x: Tensor, group=None, gathered=None) -> Tuple[Tensor, Tensor]:
    """(E[x], E[x^2]) over every axis of x but the last, in f32 (float64
    for float64 x); with ``group`` their mean over its ranks, taken here
    or, given ``gathered``, by the forward."""
    axes = tuple(range(x.dim() - 1))
    xf = x.to(_acc(x.dtype))
    mean = xf.mean(dim=axes)
    mean_sq = xf.square().mean(dim=axes)
    if group is not None:
        stacked = torch.stack([mean, mean_sq])
        stacked = (group.all_reduce_mean(stacked) if gathered is None else
                   _Gathered.apply(stacked, gathered, group))
        mean, mean_sq = stacked.unbind()
    return mean, mean_sq


def _normalized(x: Tensor, gamma: Tensor, beta: Tensor, mean: Tensor,
                var: Tensor, eps: float, relu: bool) -> Tensor:
    """x by (mean, var) and the affine, folded in the statistics' type and
    applied in x's; then the ReLU."""
    inv = torch.rsqrt(var + eps) * gamma.to(mean.dtype)
    shift = beta.to(mean.dtype) - mean * inv
    out = x * inv.to(x.dtype) + shift.to(x.dtype)
    return torch.relu(out) if relu else out


def batch_norm_fwd_plain(x: Tensor, gamma: Tensor, beta: Tensor,
                         mov_mean: Tensor, mov_var: Tensor,
                         momentum: Union[float, Tensor], eps: float,
                         relu: bool, group=None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K7's forward on x (..., C), op by op as
    the layers ran it before K7 (the affine applied in x's type): (out in
    x's type and shape, moments (2, C)); moves mov_mean and mov_var in
    place."""
    mean, mean_sq = _moments(x, group)
    var = torch.clamp_min(mean_sq - mean.square(), 0.0)
    m = _momentum(momentum, mov_mean)
    mov_mean.mul_(m).add_((1.0 - m) * mean.to(mov_mean.dtype))
    mov_var.mul_(m).add_((1.0 - m) * var.to(mov_var.dtype))
    return (_normalized(x, gamma, beta, mean, var, eps, relu),
            torch.stack([mean, mean_sq]))


def batch_norm_bwd_plain(g: Tensor, x: Tensor, moments: Tensor,
                         gamma: Tensor, beta: Tensor, eps: float,
                         relu: bool, group=None
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K7's backward: (dx, dgamma, dbeta) from
    the output's cotangent g, by autograd through the forward's chain
    recomputed from x (the group's moments, ``moments``, replayed: one
    all-reduce, in the backward)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        gamma = gamma.detach().requires_grad_()
        beta = beta.detach().requires_grad_()
        mean, mean_sq = _moments(x, group, gathered=moments)
        var = torch.clamp_min(mean_sq - mean.square(), 0.0)
        out = _normalized(x, gamma, beta, mean, var, eps, relu)
        return torch.autograd.grad(out, (x, gamma, beta), g)


def _library():
    return _build.load("batch_norm", _SIGNATURES)


def _check_cuda(what: str, y: Tensor, *vectors: Tensor) -> None:
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes a float32 or bfloat16 activation, "
                         f"got {y.dtype}")
    if not y.is_cuda or y.dim() != 2 or not y.is_contiguous() or \
            0 in y.shape:
        raise ValueError(f"{what} takes a non-empty contiguous (rows, C) "
                         f"CUDA activation, got {tuple(y.shape)} on "
                         f"{y.device}")
    c = y.shape[1]
    for t in vectors:
        if not t.is_cuda or t.device != y.device:
            raise ValueError(f"{what} takes CUDA tensors on one device")
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.shape[-1] != c:
            raise ValueError(f"{what} takes contiguous float32 per-channel "
                             f"tensors of {c} channels, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _partials(lib, y: Tensor) -> Tensor:
    return torch.empty((lib.pcae_bn_max_partials(), 2, y.shape[1]),
                       dtype=torch.float32, device=y.device)


def batch_norm_fwd_cuda(y: Tensor, gamma: Tensor, beta: Tensor,
                        mov_mean: Tensor, mov_var: Tensor,
                        momentum: Union[float, Tensor], eps: float,
                        relu: bool, group=None) -> Tuple[Tensor, Tensor]:
    """K7's forward on a CUDA y (rows, C) contiguous, bf16 or f32; the
    other tensors f32 (C,) on its device: ``batch_norm_fwd_plain``'s
    outputs, the affine applied in f32 and rounded once. Three launches
    (column sums, their reduction, apply with the moving update), the
    group's all-reduce between the second and the third. Adds one to
    ``batch_norm_fwd_cuda.launches``."""
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    _check_cuda("batch_norm_fwd_cuda", y, gamma, beta, mov_mean, mov_var)
    lib = _library()
    rows, c = y.shape
    bf16 = int(y.dtype == torch.bfloat16)
    dev = y.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    moments = torch.empty((2, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pcae_bn_moments(bf16, y.data_ptr(),
                                  _partials(lib, y).data_ptr(),
                                  moments.data_ptr(), rows, c, stream)
    _build.check(lib, err, "batch norm statistics kernel")
    if group is not None:
        moments = group.all_reduce_mean(moments)
    m = _momentum(momentum, mov_mean)
    out = torch.empty_like(y)
    with torch.cuda.device(dev):
        err = lib.pcae_bn_apply(
            bf16, y.data_ptr(), out.data_ptr(), moments.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), mov_mean.data_ptr(),
            mov_var.data_ptr(), m.data_ptr(), eps, rows, c, int(relu),
            stream)
    _build.check(lib, err, "batch norm apply kernel")
    batch_norm_fwd_cuda.launches += 1
    return out, moments


batch_norm_fwd_cuda.launches = 0


def batch_norm_bwd_cuda(g: Tensor, y: Tensor, moments: Tensor,
                        gamma: Tensor, beta: Tensor, eps: float,
                        relu: bool, group=None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K7's backward on CUDA tensors (g and y (rows, C) contiguous, one
    type): ``batch_norm_bwd_plain``'s outputs, in closed form (dgamma and
    dbeta f32, dy rounded once to y's type). Three launches
    (the masked sums, their reduction, dx), the group's all-reduce between
    the second and the third. Adds one to
    ``batch_norm_bwd_cuda.launches``."""
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    _check_cuda("batch_norm_bwd_cuda", y, gamma, beta, moments)
    if g.dtype != y.dtype or g.shape != y.shape or not g.is_cuda or \
            g.device != y.device:
        raise ValueError(f"batch_norm_bwd_cuda takes g like y, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    lib = _library()
    rows, c = y.shape
    bf16 = int(y.dtype == torch.bfloat16)
    dev = y.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pcae_bn_grad_sums(
            bf16, g.data_ptr(), y.data_ptr(), moments.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), eps,
            _partials(lib, y).data_ptr(), sums.data_ptr(), rows, c,
            int(relu), stream)
    _build.check(lib, err, "batch norm gradient sums kernel")
    dbeta, dgamma = sums[0], sums[1]
    if group is not None:
        sums = group.all_reduce_mean(sums)
    dy = torch.empty_like(y)
    with torch.cuda.device(dev):
        err = lib.pcae_bn_dx(
            bf16, g.data_ptr(), y.data_ptr(), moments.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), eps, sums.data_ptr(),
            dy.data_ptr(), rows, c, int(relu), stream)
    _build.check(lib, err, "batch norm dx kernel")
    batch_norm_bwd_cuda.launches += 1
    return dy, dgamma, dbeta


batch_norm_bwd_cuda.launches = 0


def _shape(x: Tensor) -> dict:
    """The call's shape, as ``utils/roofline.kernel_bound`` takes it."""
    c = x.shape[-1]
    return dict(rows=x.numel() // c, c=c, dtype=x.dtype)


class _BatchNormReLU(torch.autograd.Function):
    """Training BatchNorm (and ReLU) of x (..., C) over every axis but the
    last; backward to x, gamma and beta. K7 takes x as a contiguous
    (rows, C) matrix; the plain version takes x as it is."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mov_mean, mov_var, momentum, eps, relu,
                group):
        with roofline.charge("batch_norm_fwd", **_shape(x)):
            if x.is_cuda:
                x2 = x.reshape(-1, x.shape[-1]).contiguous()
                out, moments = batch_norm_fwd_cuda(
                    x2, gamma, beta, mov_mean, mov_var, momentum, eps, relu,
                    group)
                out = out.reshape(x.shape)
            else:
                x2 = x
                out, moments = batch_norm_fwd_plain(
                    x, gamma, beta, mov_mean, mov_var, momentum, eps, relu,
                    group)
        ctx.save_for_backward(x2, moments, gamma, beta)
        ctx.eps, ctx.relu, ctx.group = eps, relu, group
        ctx.x_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        x2, moments, gamma, beta = ctx.saved_tensors
        args = (moments, gamma, beta, ctx.eps, ctx.relu, ctx.group)
        with roofline.charge("batch_norm_bwd", **_shape(x2)):
            if x2.is_cuda:
                dx, dgamma, dbeta = batch_norm_bwd_cuda(
                    g.reshape(x2.shape).contiguous(), x2, *args)
                dx = dx.reshape(ctx.x_shape)
            else:
                dx, dgamma, dbeta = batch_norm_bwd_plain(g, x2, *args)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None,
                None, None, None, None)


def batch_norm_train(x: Tensor, gamma: Tensor, beta: Tensor, mean: Tensor,
                     var: Tensor, momentum: Union[float, Tensor] = 0.9,
                     eps: float = 1e-3, relu: bool = False,
                     group=None) -> Tensor:
    """Training BatchNorm of x (..., C) by its batch statistics, then the
    ReLU if ``relu``: out in x's type and shape. ``mean`` and ``var``, the
    layer's moving statistics, move in place by ``momentum`` (a float or a
    0-dim tensor); gamma and beta get gradients. K7 on CUDA tensors, the
    plain version on CPU tensors."""
    return _BatchNormReLU.apply(x, gamma, beta, mean, var, momentum, eps,
                                relu, group)
