"""On-card kernel parity check: every kernel of the port against its numpy
oracle.

The CPU suite runs each kernel's plain PyTorch version; ``chip_smoke.py``
holds each kernel to that plain version on the card. Both are the port's
own code. This module is the independent check, the twin of the JAX
package's ``ops/hwcheck.py``: the compiled kernels on the card against
the numpy oracles of ``ops/oracles.py``, at shapes picked at the kernels'
tile boundaries. Run it after a kernel change or on a new toolkit:

    python -m pointnet_autoencoder_tpu_torch.ops.hwcheck [--device cuda]
        [--fuzz K] [--large_n]

Prints the card's name and power limit, then one PASS/FAIL line per
contract, and exits nonzero on any failure. Each check builds its inputs
with numpy from its seed, moves them to the device, and compares with the
oracle on the host, never with another program on the device.
``--device cpu`` runs the same contracts through the plain versions.

The kernels each check reaches on a card: ``check_chamfer`` K1 and K2,
``check_emd`` K6, ``check_fused_head`` K3 (f32 and bf16),
``check_fused_encoder`` K5 (f32 and bf16), ``check_sp_point_sharded`` K1
and K2 under a process group, ``check_emd_route_boundary`` K6. No check
differentiates through the conv5 head, as in the JAX package, so K4 is
not reached here (``chip_smoke.py`` holds it to its plain version).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch.config import refuse_unported
from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.ops import chamfer, emd, fused_encoder, \
    fused_head, oracles

_FAILURES = []
# (name, err, tol) of every check made, PASS or FAIL.
_RESULTS = []

# Unit roundoff of f32 and of bf16 (8 significant bits).
_U32 = 2.0 ** -24
_U16 = 2.0 ** -8


def _check(name: str, err: float, tol: float, extra: str = ""):
    ok = bool(err <= tol)
    print(f"{'PASS' if ok else 'FAIL'}  {name}: max err {err:.3e} "
          f"(tol {tol:.0e}){' ' + extra if extra else ''}", flush=True)
    _RESULTS.append((name, float(err), float(tol)))
    if not ok:
        _FAILURES.append(name)


def _maxerr(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _host(*tensors):
    return [t.detach().float().cpu().numpy() for t in tensors]


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (to nearest even), as f32 values."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _sum_error(c: int, abs_x: np.ndarray, abs_w: np.ndarray) -> np.ndarray:
    """Bound on the f32 error of x @ w where every product is exact in f32
    (bf16 or f32 values whose product the hardware forms exactly): a sum
    of c terms in any order errs by at most gamma_c times the sum of the
    terms' magnitudes (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., (3.5)). Each addition is taken to err by 2u, not
    u: the tensor cores may truncate instead of rounding their partial
    sums (Fasi et al., PeerJ CS 7:e330, 2021)."""
    gamma = 2 * c * _U32 / (1 - 2 * c * _U32)
    return gamma * (abs_x @ abs_w)


def check_chamfer(b=4, n=500, m=388, seed=0, impls=("kernel", "dense"),
                  tag="", device="cuda"):
    """Forward (dist exact-ish, idx exact) and the gradient through
    autograd, for ``nn_distance`` (K1 forward, K2 gradient on a card) and
    ``nn_distance_dense`` (the dense form, the JAX package's impl="xla"),
    at a non-tile-multiple N != M on purpose."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    x1 = rng.randn(b, n, 3).astype(np.float32)
    x2 = rng.randn(b, m, 3).astype(np.float32)
    g1 = rng.randn(b, n).astype(np.float32)
    g2 = rng.randn(b, m).astype(np.float32)
    rd1, ri1, rd2, ri2 = oracles.nn_distance_np(x1, x2)
    rgx1, rgx2 = oracles.nn_distance_grad_np(x1, x2, ri1, ri2, g1, g2)
    t1, t2, tg1, tg2 = _to(dev, x1, x2, g1, g2)
    for impl in impls:
        fn = chamfer.nn_distance if impl == "kernel" \
            else chamfer.nn_distance_dense
        a = t1.clone().requires_grad_()
        c = t2.clone().requires_grad_()
        d1, i1, d2, i2 = fn(a, c)
        hd1, hd2 = _host(d1, d2)
        _check(f"chamfer[{impl}]{tag} dist", max(_maxerr(hd1, rd1),
                                                 _maxerr(hd2, rd2)), 1e-5)
        idx_ok = int(np.sum(i1.cpu().numpy() != ri1)
                     + np.sum(i2.cpu().numpy() != ri2))
        _check(f"chamfer[{impl}]{tag} idx (mismatches)", float(idx_ok), 0.0)
        gx1, gx2 = torch.autograd.grad(
            (d1 * tg1).sum() + (d2 * tg2).sum(), (a, c))
        gx1, gx2 = _host(gx1, gx2)
        _check(f"chamfer[{impl}]{tag} grad", max(_maxerr(gx1, rgx1),
                                                 _maxerr(gx2, rgx2)), 5e-5)


def _emd_oracle(x1, x2, match=None):
    """(cost, grad1, grad2, the gradients' largest magnitude) of the
    GPU-semantics oracle, from its plan ``match`` if given."""
    if match is None:
        match = oracles.approx_match_np(x1, x2)
    rcost = oracles.match_cost_np(x1, x2, match)
    rg1, rg2 = oracles.match_cost_grad_np(x1, x2, match)
    scale = max(float(np.abs(rg1).max()), float(np.abs(rg2).max()))
    return rcost, rg1, rg2, scale


def _check_emd_forward(label, got, want):
    """Cost within 2e-3 of the largest cost (at least 1), gradients within
    5e-3 of the largest gradient: the JAX package's EMD contract."""
    cost, g1, g2 = _host(*got)
    rcost, rg1, rg2, scale = want
    _check(f"{label} cost", _maxerr(cost, rcost)
           / max(float(np.abs(rcost).max()), 1.0), 2e-3, extra="(relative)")
    _check(f"{label} grads", max(_maxerr(g1, rg1), _maxerr(g2, rg2)) / scale,
           5e-3, extra="(relative to grad max)")


def check_emd(b=2, n=256, m=192, seed=1, device="cuda"):
    """Annealed matching and cost (plain PyTorch on the device) and the
    fused cost with its gradients (K6 on a card) against the
    GPU-semantics oracle, unequal cloud sizes (integer capacity
    factors)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    rmatch = oracles.approx_match_np(x1, x2)
    want = _emd_oracle(x1, x2, rmatch)
    rcost = want[0]
    t1, t2, tmatch = _to(dev, x1, x2, rmatch)

    match, = _host(emd.approx_match(t1, t2))
    _check("emd approx_match", _maxerr(match, rmatch), 1e-3)
    cost, = _host(emd.match_cost(t1, t2, tmatch))
    _check("emd match_cost", _maxerr(cost, rcost) / max(float(rcost.max()),
                                                        1.0), 1e-4,
           extra="(relative)")

    a = t1.clone().requires_grad_()
    c = t2.clone().requires_grad_()
    fcost = emd.emd_cost(a, c)
    g1, g2 = torch.autograd.grad(fcost.sum(), (a, c))
    _check_emd_forward("emd fused", (fcost, g1, g2), want)


def _head_inputs(rng, b, n, c, f):
    x = rng.randn(b, n, c).astype(np.float32)
    w = (rng.randn(c, f) * 0.3).astype(np.float32)
    bias = (rng.randn(f) * 0.1).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(f)).astype(np.float32)
    beta = (0.1 * rng.randn(f)).astype(np.float32)
    y = x.reshape(-1, c) @ w + bias
    mean = y.mean(0).astype(np.float32)
    var = (np.mean(y * y, axis=0) - mean * mean).astype(np.float32)
    return x, w, bias, gamma, beta, mean, var


def head_bound(x, w, bias, gamma, beta, mean, var, eps=1e-3) -> np.ndarray:
    """(B, F) bound on |kernel - oracle| for the conv5 head on inputs whose
    products are exact in f32 (the bf16 route on bf16 values), against
    ``oracles.fused_head_np`` on the same values: the f32 sum of the C
    products (``_sum_error``) scaled by |scale|, and the f32 fold of the
    BN affine (rsqrt within 2 ulp, then three products, a difference and a
    sum, each within u) and the affine's multiply and add, together at
    most 8u of |y * scale| + |(b - mean) * scale| + |beta|. The max over
    points errs by at most the largest point's error."""
    x64, w64 = np.asarray(x, np.float64), np.asarray(w, np.float64)
    scale = np.asarray(gamma, np.float64) / np.sqrt(
        np.asarray(var, np.float64) + eps)
    y = x64 @ w64
    dy = _sum_error(w.shape[0], np.abs(x64), np.abs(w64))
    rest = np.abs((np.asarray(bias, np.float64) - mean) * scale) \
        + np.abs(np.asarray(beta, np.float64))
    bound = np.abs(scale) * dy + 8 * _U32 * (np.abs(y * scale) + rest)
    return bound.max(axis=1)


def check_fused_head(b=3, n=96, c=128, f=1024, seed=2, device="cuda"):
    """The conv5 head (K3 on a card) against the float64 oracle, in f32 at
    1e-5 and in bf16 (the tensor-core kernel) against the oracle on the
    bf16-rounded inputs, within ``head_bound``. On a card K3 takes only
    C = 128 input channels and F a multiple of 256."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    x, w, bias, gamma, beta, mean, var = _head_inputs(rng, b, n, c, f)
    rmax, _ = oracles.fused_head_np(x, w, bias, gamma, beta, mean, var)
    args = _to(dev, x, w, bias, gamma, beta, mean, var)
    out, = _host(fused_head.fused_dense_bn_relu_max(*args))
    _check("fused_head fwd", _maxerr(out, rmax), 1e-5)

    x16, w16 = _bf16(x), _bf16(w)
    rmax16, _ = oracles.fused_head_np(x16, w16, bias, gamma, beta, mean, var)
    bound = head_bound(x16, w16, bias, gamma, beta, mean, var)
    tx, tw = (t.to(torch.bfloat16) for t in _to(dev, x16, w16))
    out16, = _host(fused_head.fused_dense_bn_relu_max(tx, tw, *args[2:]))
    err = np.abs(out16.astype(np.float64) - rmax16)
    _check("fused_head[bf16] fwd", float(np.max(err / bound)), 1.0,
           extra=f"(error over the derived bound; max abs err "
                 f"{err.max():.3e}, bound {bound.max():.3e})")


def _encoder_layers(rng, widths=fused_encoder.KERNEL_WIDTHS[1:]):
    layers, c = [], fused_encoder.KERNEL_WIDTHS[0]
    for fw in widths:
        w = (rng.randn(c, fw) * 0.3).astype(np.float32)
        bias = (rng.randn(fw) * 0.1).astype(np.float32)
        gamma = (1.0 + 0.2 * rng.randn(fw)).astype(np.float32)
        beta = (0.1 * rng.randn(fw)).astype(np.float32)
        mean = (0.05 * rng.randn(fw)).astype(np.float32)
        var = (1.0 + 0.1 * rng.rand(fw)).astype(np.float32)
        layers.append((w, bias, gamma, beta, mean, var))
        c = fw
    return layers


# Standard deviations within which the bf16 routes must land: a normal
# variable exceeds 6 of them with probability 2e-9.
_BF16_SIGMAS = 6.0


def encoder_bf16_walk(pts: np.ndarray, layers, eps: float = 1e-3):
    """(out, tol), both (B, F) float64: the eval encoder's float64 walk of
    the f32 chain ``layers`` (the oracle of the f32 check), and the
    tolerance of the bf16 route against it.

    The bf16 route rounds the points, every weight and every inner
    activation to bf16 (to nearest even), each rounding of a value v
    erring by at most u|v|, u = 2^-8, bf16's unit roundoff; its sums run
    in f32, whose error (2^-24 per addition) is two orders below and is
    not counted. To first order the output's error is a sum of these
    independent errors times their sensitivities, so its variance is
    bounded by the sum of (sensitivity * u * v)^2. That sum is carried
    through each layer's reduction over its C inputs: an input error of
    variance V_c and a weight rounding of w_cf * u reach output f with
    variance sum_c w_cf^2 (V_c + u^2 x_c^2), counting no cross terms
    between inputs (the checks' weights are independent draws of random
    sign), then times the BN scale squared where the ReLU passes, plus
    the activation's own rounding u^2 a^2. To first order the max over
    points moves with the point that attains it, so each channel takes
    that point's variance. The tolerance is
    ``_BF16_SIGMAS`` times the standard deviation."""
    x = np.asarray(pts, np.float64)
    var = (_U16 * x) ** 2
    for i, (w, bias, gamma, beta, mean, v) in enumerate(layers):
        w = np.asarray(w, np.float64)
        scale = gamma / np.sqrt(np.asarray(v, np.float64) + eps)
        shift = (bias - np.asarray(mean, np.float64)) * scale + beta
        y = x @ w
        var_y = var @ (w * w) + (_U16 * _U16) * ((x * x) @ (w * w))
        o = y * scale + shift
        if i == len(layers) - 1:
            break
        x = np.maximum(o, 0.0)
        var = (o > 0.0) * scale * scale * var_y + (_U16 * x) ** 2
    at = np.where(scale >= 0.0, y.argmax(axis=1), y.argmin(axis=1))
    sel = np.take_along_axis(y, at[:, None], axis=1)[:, 0]
    var_sel = np.take_along_axis(var_y, at[:, None], axis=1)[:, 0]
    out = np.maximum(sel * scale + shift, 0.0)
    tol = _BF16_SIGMAS * np.abs(scale) * np.sqrt(var_sel)
    return out, tol


def check_fused_encoder(b=2, n=64, seed=3, device="cuda"):
    """The whole eval encoder (K5 on a card) at the published widths: the
    f32 route against a float64 numpy walk of the chain at 1e-4, and the
    bf16 route (the tensor-core kernel) against the same walk, within
    ``encoder_bf16_walk``'s tolerance."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, 3).astype(np.float32)
    layers = _encoder_layers(rng)
    ref, tol = encoder_bf16_walk(pts, layers)
    tl = [tuple(_to(dev, *layer)) for layer in layers]
    tpts, = _to(dev, pts)
    chain = fused_encoder.fold_layers(tl, eps=1e-3)
    out, = _host(fused_encoder.fused_encoder_eval(tpts, chain))
    _check(f"fused_encoder eval fwd (B={b}, N={n})", _maxerr(out, ref), 1e-4)

    chain16 = fused_encoder.fold_layers(tl, eps=1e-3, dtype=torch.bfloat16)
    out16, = _host(fused_encoder.fused_encoder_eval(tpts, chain16))
    err = np.abs(out16.astype(np.float64) - ref)
    _check(f"fused_encoder[bf16] eval fwd (B={b}, N={n})",
           float(np.max(err / tol)), 1.0,
           extra=f"(error over the derived tolerance; max abs err "
                 f"{err.max():.3e}, largest tolerance {tol.max():.3e})")


def _emd_kernel_route(t1, t2):
    """What ``emd_cost`` runs on these tensors (K6 on a card): its cost and
    plan-constant gradients."""
    a = t1.clone().requires_grad_()
    c = t2.clone().requires_grad_()
    cost = emd.emd_cost(a, c)
    g1, g2 = torch.autograd.grad(cost.sum(), (a, c))
    return cost, g1, g2


def _as_reference(forward):
    """A (cost, grad1, grad2) on the device as ``_check_emd_forward``'s
    reference."""
    cost, g1, g2 = _host(*forward)
    return cost, g1, g2, max(float(np.abs(g1).max()), float(np.abs(g2).max()))


def _check_emd_large(b, n, m, seed, tag, device):
    """``emd_cost`` (K6 on a card) and the streaming form on the device
    against the numpy oracle, which materializes (N, M) on the host."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    want = _emd_oracle(x1, x2)
    t1, t2 = _to(dev, x1, x2)
    for impl, fn in (("kernel", _emd_kernel_route),
                     ("chunked", emd.emd_forward_chunked)):
        _check_emd_forward(f"emd[{impl}] {tag} (B={b}, N={n}, M={m})",
                           fn(t1, t2), want)


def check_emd_large_n(b=1, n=16384, m=16384, seed=4, device="cuda"):
    """The EMD at N=M=16384: K6 (no envelope on a card) and the row-chunked
    streaming form against the oracle at the same shape. Slow (the
    oracle's 10 annealing levels over 268M pairs take minutes); opt in via
    --large_n."""
    _check_emd_large(b, n, m, seed, "large-N", device)


def check_emd_large_prime_n(b=1, n=12289, m=12289, seed=8, device="cuda"):
    """The EMD at a large PRIME N: 12289 has no divisors, so the streaming
    form pads its rows to a chunk multiple with zero-capacity rows; K6 on
    a card takes it as any other N. Slow (host oracle at 151M pairs); opt
    in via --large_n."""
    _check_emd_large(b, n, m, seed, "large-prime-N", device)


def check_emd_route_boundary(device="cuda"):
    """What the port routes for the EMD, in the default sweep.

    The JAX package declines its Pallas kernel past a VMEM envelope and
    streams instead. Here CUDA tensors run K6 at every shape (no
    envelope), and CPU tensors stream past ``_DENSE_BYTES_LIMIT``. So:
    (1) host-side shape logic only: a (1, 32768, 32768) problem is past
        the dense limit, and ``_pick_row_chunk``'s (B, chunk, M) buffer
        stays within its 256 MB budget (beyond the 8-row floor), in at
        most 64 chunks where the budget admits N/64 rows;
    (2) a prime N (251) and a padded N (253; neither divides into the
        8-row multiple the chunk is rounded to) through the streaming form
        against the dense plain form, and the padded one against the
        numpy oracle;
    (3) ``emd_cost`` (K6 on a card) against the streaming form at that
        shape."""
    b_, n_, m_ = 1, 32768, 32768
    streams = 4 * b_ * n_ * m_ > emd._DENSE_BYTES_LIMIT
    _check("emd route: past-limit shape streams (no dense (B,N,M))",
           0.0 if streams else 1.0, 0.0)
    budget = 256 * 1024 * 1024
    chunk = emd._pick_row_chunk(b_, n_, m_)
    nc = -(-n_ // chunk)
    over = max(0, 4 * b_ * chunk * m_ - (budget + 4 * b_ * 8 * m_))
    _check("emd route: streaming buffer within byte budget",
           float(over), 0.0, extra=f"(chunk={chunk}, "
                                   f"{4 * b_ * chunk * m_ >> 20} MiB)")
    if budget // (4 * b_ * m_) >= -(-n_ // 64):
        _check("emd route: chunk count bounded (budget admits <= 64)",
               float(nc), 64.0, extra=f"(chunk={chunk}, nc={nc})")

    dev = resolve_device(device)
    m = 192
    rng = np.random.RandomState(7)
    x2 = rng.rand(2, m, 3).astype(np.float32)
    for n in (251, 253):
        x1 = rng.rand(2, n, 3).astype(np.float32)
        t1, t2 = _to(dev, x1, x2)
        chunked = emd.emd_forward_chunked(t1, t2)
        _check_emd_forward(f"emd[chunked] vs dense (B=2, N={n}, M={m})",
                           chunked,
                           _as_reference(emd.emd_forward_plain(t1, t2)))
    _check_emd_forward(f"emd[chunked] padded-N (B=2, N={n}, M={m})",
                       chunked, _emd_oracle(x1, x2))
    _check_emd_forward(f"emd[kernel] vs chunked (B=2, N={n}, M={m})",
                       _emd_kernel_route(t1, t2), _as_reference(chunked))


def check_chamfer_large_n(b=1, n=16384, m=16384, seed=5, device="cuda"):
    """Chamfer at N=M=16384: K1's running minimum over 64 query blocks and
    K2's gradient past one block's shared memory. The dense form is
    skipped: it materializes (B, N, M) by design."""
    check_chamfer(b=b, n=n, m=m, seed=seed, impls=("kernel",),
                  tag=f" large-N (B={b}, N={n}, M={m})", device=device)


def check_sp_point_sharded(b=2, n=256, m=192, seed=6, device="cuda"):
    """The point-parallel Chamfer loss (``parallel.sp``; K1 and K2 on a
    card) and its gradient, in a process group of one rank over gloo,
    against the oracle: the twin of the JAX package's check_sp_shard_map,
    which runs its shard_map on a one-device mesh. The group is made in
    this process over a file store and destroyed before returning; the
    caller must not be in one."""
    import torch.distributed as dist

    from pointnet_autoencoder_tpu_torch.parallel import sp
    from pointnet_autoencoder_tpu_torch.parallel.mesh import DataGroup

    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("check_sp_point_sharded makes its own one-rank "
                           "process group; call it outside a group")
    rng = np.random.RandomState(seed)
    x1 = rng.randn(b, n, 3).astype(np.float32)
    x2 = rng.randn(b, m, 3).astype(np.float32)
    rd1, ri1, rd2, ri2 = oracles.nn_distance_np(x1, x2)
    rloss = float(rd1.mean() + rd2.mean())
    t1, t2 = _to(dev, x1, x2)
    with tempfile.TemporaryDirectory(prefix="pcae-hwcheck-") as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            group = DataGroup(dev)
            a = t1.clone().requires_grad_()
            c = t2.clone().requires_grad_()
            loss = sp.chamfer_loss_point_sharded(a, c, group)
            g1, g2 = _host(*torch.autograd.grad(loss, (a, c)))
            v = float(loss.detach())
        finally:
            dist.destroy_process_group()
    _check("sp[point_sharded] chamfer loss", abs(v - rloss), 1e-5)
    og1 = np.full((b, n), 1.0 / (b * n), np.float32)
    og2 = np.full((b, m), 1.0 / (b * m), np.float32)
    rg1, rg2 = oracles.nn_distance_grad_np(x1, x2, ri1, ri2, og1, og2)
    _check("sp[point_sharded] chamfer grad",
           max(_maxerr(g1, rg1), _maxerr(g2, rg2)), 5e-5)


# Strategic first draws for fuzz(). The JAX package's eight come first:
# its Pallas tiles of 512 +-1, B=1, single-point clouds and extreme N:M
# (the capacity-factor paths); 511, 513 and 1023 are also +-1 around
# multiples of the CUDA kernels' tiles below. Then +-1 around the CUDA
# kernels' own first tiles: K1 takes 256 queries (N) per block
# (csrc/chamfer.cu:87) and 128 candidates (M) per warp step (:190); K2
# owns at least 256 rows of either cloud per block (:91); K6 owns 128
# points per block, of either cloud in turn, and streams the other in
# tiles of 1024 (csrc/emd.cu:82-83). Each draw runs the EMD at its own
# N and M (B at most 2), so (1, 1025, 129) crosses K6's streamed tile.
# Module-level so the test suite can substitute small shapes.
_FUZZ_POOL = [(1, 511, 513), (2, 512, 512), (3, 1023, 65), (1, 64, 2048),
              (2, 2048, 64), (4, 129, 127), (1, 1, 1), (2, 513, 511),
              (2, 255, 129), (1, 127, 257), (2, 257, 255), (1, 1025, 129)]


def fuzz(draws: int = 8, seed0: int = 100, device: str = "cuda") -> None:
    """Shape-fuzz the loss kernels on the device: ``check_chamfer`` and
    ``check_emd`` at each draw's shape. The first draws are ``_FUZZ_POOL``
    in order; the rest are random (B in 1..4, N and M in 1..1499). The
    numpy oracles cost O(B*N*M) per draw, so the EMD keeps B <= 2."""
    rng = np.random.RandomState(seed0)
    pool = _FUZZ_POOL
    for t in range(draws):
        if t < len(pool):
            b, n, m = pool[t]
        else:
            b = int(rng.randint(1, 5))
            n = int(rng.randint(1, 1500))
            m = int(rng.randint(1, 1500))
        print(f"-- fuzz draw {t}: chamfer b={b} n={n} m={m}")
        check_chamfer(b=b, n=n, m=m, seed=1000 + t, device=device)
        be = min(b, 2)
        print(f"-- fuzz draw {t}: emd b={be} n={n} m={m}")
        check_emd(b=be, n=n, m=m, seed=2000 + t, device=device)


# K5's tiles: 64 points per block in f32 (csrc/fused_encoder.cu:75) and
# 256 in bf16 (:256). The fuzz does not reach K5, so the default sweep
# takes the JAX package's N=64 and +-1 around both tiles.
_ENCODER_POINTS = (64, 63, 65, 255, 257)


def _card_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return f"device: {dev}"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index)],
            capture_output=True, text=True, timeout=60, check=True)
        smi = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"power limit not read ({type(e).__name__})"
    return f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi}"


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu (the "
                        "plain versions)")
    p.add_argument("--fuzz", type=int, default=0, metavar="K",
                   help="after the fixed contracts, fuzz K extra shape "
                        "draws (tile boundaries, B=1, extreme N:M, then "
                        "random) through chamfer and emd on the device")
    p.add_argument("--large_n", action="store_true",
                   help="also check the large-N (N=M=16384) regime: the "
                        "Chamfer kernels (fwd+bwd), and the EMD kernel and "
                        "the streaming EMD at 16384 and at the prime 12289 "
                        "vs the numpy oracles (slow: the EMD host oracle "
                        "takes minutes at 268M pairs)")
    p.add_argument("--compilation_cache_dir", default=None,
                   help="Not ported (no XLA programs to cache)")
    args = p.parse_args(argv)
    refuse_unported("compilation_cache_dir", args.compilation_cache_dir)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # Full f32 products for the plain PyTorch parts on the card
        # (approx_match, match_cost, the dense Chamfer), as the Trainer
        # and the session set.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(_card_line(dev), flush=True)
    device = str(dev)
    check_chamfer(device=device)
    check_emd(device=device)
    check_fused_head(device=device)
    for n in _ENCODER_POINTS:
        check_fused_encoder(n=n, device=device)
    check_sp_point_sharded(device=device)
    check_emd_route_boundary(device=device)
    if args.large_n:
        check_chamfer_large_n(device=device)
        check_emd_large_n(device=device)
        check_emd_large_prime_n(device=device)
    if args.fuzz:
        fuzz(args.fuzz, device=device)
    if _FAILURES:
        print(f"{len(_FAILURES)} FAILURES: {_FAILURES}")
        return 1
    print("all hardware parity checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
