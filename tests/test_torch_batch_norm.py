"""Training BatchNorm + ReLU (``ops/batch_norm.py``, K7's plain version on
the CPU) against the autograd chain the layers ran before it: the
reference's arithmetic written op by op (f32 moments, the clamped biased
variance, the in-place moving update, the folded affine applied in the
activation's type, then ``F.relu``), differentiated by autograd.

- the output, the moving statistics and the gradients of x, gamma and
  beta bit-equal to the chain's, in f32 and bf16, 2-D, 3-D and 4-D (also
  a permuted channels-last view, as ``UpConv`` gives it), ReLU on and
  off: the plain version is that chain, its backward autograd over the
  chain recomputed;
- a channel that is constant, where E[y^2] - E[y]^2 rounds below 0 and
  the clamp passes no gradient to the variance; ``gradcheck`` in float64;
  a group of one rank over gloo bit-equal to no group;
- routing: ``PointMLP``, ``FC``, ``UpConv`` and ``Conv`` in training, and
  every BatchNorm of a ``model`` train step, go through
  ``batch_norm.batch_norm_train`` with the layer's ReLU flag; eval does
  not; a ``StepCost`` of the step charges six ``batch_norm_fwd`` and six
  ``batch_norm_bwd`` calls. The CUDA wrappers refuse CPU tensors.

K7 itself, whose affine rounds once, is held to this plain version on the
card by ``chip_smoke.py`` (phase ``batch_norm_kernel``).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.nn import functional as F

from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.nn import layers
from pointnet_autoencoder_tpu_torch.ops import batch_norm
from pointnet_autoencoder_tpu_torch.parallel.mesh import DataGroup
from pointnet_autoencoder_tpu_torch.train import schedules
from pointnet_autoencoder_tpu_torch.train.state import (TrainState,
                                                        make_optimizer)
from pointnet_autoencoder_tpu_torch.utils import roofline

torch.set_num_threads(2)

EPS = 1e-3
MOMENTUM = 0.9


def chain(x, gamma, beta, mean_buf, var_buf, momentum, eps, relu,
          acc=torch.float32):
    """The layers' training BatchNorm and ReLU before the fused op, op by
    op; with ``acc`` float64 the same arithmetic in float64 throughout."""
    axes = tuple(range(x.dim() - 1))
    xf = x.to(acc)
    mean = xf.mean(dim=axes)
    mean_sq = xf.square().mean(dim=axes)
    var = torch.clamp_min(mean_sq - mean.square(), 0.0)
    with torch.no_grad():
        m = torch.full((), momentum, dtype=mean_buf.dtype)
        mean_buf.mul_(m).add_((1.0 - m) * mean.to(mean_buf.dtype))
        var_buf.mul_(m).add_((1.0 - m) * var.to(var_buf.dtype))
    inv = torch.rsqrt(var + eps) * gamma.to(acc)
    shift = beta.to(acc) - mean * inv
    y = (xf * inv + shift if acc == torch.float64 else
         x * inv.to(x.dtype) + shift.to(x.dtype))
    return F.relu(y) if relu else y


def _inputs(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32))
    gamma = torch.from_numpy((rng.randn(c) * 0.5 + 1).astype(np.float32))
    beta = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    cot = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return x.to(dtype), gamma, beta, cot.to(dtype)


def _run(fn, x, gamma, beta, cot, relu, acc=None):
    """(output, dx, dgamma, dbeta, new moving mean, new moving var), all
    float64, of ``fn`` from fresh moving statistics."""
    c = x.shape[-1]
    dt = acc or torch.float32
    xx = x.to(acc or x.dtype).clone().requires_grad_()
    g = gamma.to(dt).clone().requires_grad_()
    b = beta.to(dt).clone().requires_grad_()
    mb, vb = torch.zeros(c, dtype=dt), torch.ones(c, dtype=dt)
    kw = {} if acc is None else {"acc": acc}
    out = fn(xx, g, b, mb, vb, MOMENTUM, EPS, relu, **kw)
    (out.double() * cot.double()).sum().backward()
    return [t.detach().double() for t in (out, xx.grad, g.grad, b.grad, mb,
                                          vb)]


PERMUTED = (2, 3, 5, 12)
SHAPES = [(96, 16), (4, 30, 8), (2, 4, 5, 12), PERMUTED]


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d", "4d",
                                               "4d_permuted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_matches_the_autograd_chain(dtype, shape, relu):
    x, gamma, beta, cot = _inputs(shape, dtype)
    if shape == PERMUTED:
        # The same values in (B, C, H, W) memory seen channels-last, as
        # ConvTranspose's output.
        x, cot = (t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                  for t in (x, cot))
        assert not x.is_contiguous()
    op = _run(batch_norm.batch_norm_train, x, gamma, beta, cot, relu)
    old = _run(chain, x, gamma, beta, cot, relu)
    names = ("output", "dx", "dgamma", "dbeta", "mean", "var")
    for name, a, b in zip(names, op, old):
        assert torch.equal(a, b), name


def test_a_constant_channel_clamps_the_variance():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(64, 24).astype(np.float32))
    # 16 constant channels: E[y^2] - E[y]^2 rounds to a little below,
    # at or above 0.
    x[:, 8:] = torch.from_numpy(rng.uniform(0.05, 3.0, 16).astype(
        np.float32))
    gamma = torch.ones(24)
    beta = torch.zeros(24)
    cot = torch.from_numpy(rng.randn(64, 24).astype(np.float32))
    yf = x.float()
    d = yf.square().mean(dim=0) - yf.mean(dim=0).square()
    assert bool((d[8:] < 0).any()) and bool((d[8:] >= 0).any())
    for relu in (True, False):
        op = _run(batch_norm.batch_norm_train, x, gamma, beta, cot, relu)
        old = _run(chain, x, gamma, beta, cot, relu)
        for a, b in zip(op, old):
            assert torch.equal(a, b)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_gradcheck_float64(relu):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(7, 2, 3)).requires_grad_()
    gamma = torch.from_numpy(rng.randn(3) + 1.5).requires_grad_()
    beta = torch.from_numpy(rng.randn(3) * 0.1).requires_grad_()
    mb = torch.zeros(3, dtype=torch.float64)
    vb = torch.ones(3, dtype=torch.float64)

    def f(x, gamma, beta):
        return batch_norm.batch_norm_train(x, gamma, beta, mb, vb, MOMENTUM,
                                           EPS, relu)

    assert torch.autograd.gradcheck(f, (x, gamma, beta), eps=1e-6,
                                    atol=1e-6)


def test_a_group_of_one_is_bit_equal_to_no_group(tmp_path):
    x, gamma, beta, cot = _inputs((4, 30, 8), torch.bfloat16, seed=7)
    alone = _run(batch_norm.batch_norm_train, x, gamma, beta, cot, True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        group = DataGroup(torch.device("cpu"))

        def grouped(*args):
            return batch_norm.batch_norm_train(*args, group=group)

        one = _run(grouped, x, gamma, beta, cot, True)
    finally:
        dist.destroy_process_group()
    for a, b in zip(one, alone):
        assert torch.equal(a, b)


@pytest.fixture
def spy(monkeypatch):
    """The calls that reach ``batch_norm.batch_norm_train``: (shape, relu)
    each."""
    calls = []
    real = batch_norm.batch_norm_train

    def stand_in(x, *args, relu=False, **kw):
        calls.append((tuple(x.shape), relu))
        return real(x, *args, relu=relu, **kw)

    monkeypatch.setattr(batch_norm, "batch_norm_train", stand_in)
    return calls


def _layer_cases():
    gen = torch.Generator().manual_seed(0)
    return {
        "point_mlp": (layers.PointMLP(5, 8, generator=gen),
                      torch.randn(2, 9, 5), True),
        "fc": (layers.FC(5, 8, bn=True, generator=gen), torch.randn(6, 5),
               True),
        "fc_linear": (layers.FC(5, 8, bn=True, relu=False, generator=gen),
                      torch.randn(6, 5), False),
        "upconv": (layers.UpConv(4, 6, (2, 2), (2, 2), generator=gen),
                   torch.randn(2, 3, 3, 4), True),
        "conv": (layers.Conv(4, 6, (3,), bn=True, generator=gen),
                 torch.randn(2, 5, 4), True),
    }


@pytest.mark.parametrize("name", list(_layer_cases()))
def test_every_layer_trains_through_the_op(spy, name):
    layer, x, relu = _layer_cases()[name]
    out = layer(x, True, 0.9)
    assert len(spy) == 1 and spy[0] == (tuple(out.shape), relu)
    # The op's output is the layer's.
    if relu:
        assert bool((out >= 0).all())
    out.sum().backward()
    assert layer.bn.gamma.grad is not None
    spy.clear()
    layer(x, False, 0.9)
    assert spy == []


def test_the_model_step_routes_every_batch_norm(spy):
    spec = get_model_spec("model")
    model = spec.make(64, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer("adam", model.parameters()),
                       schedules.learning_rate_schedule(1e-3, 0.7, 32,
                                                        200000))
    x = torch.rand(4, 64, 3, generator=torch.Generator().manual_seed(1))
    with roofline.StepCost() as cost:
        state.train_step(x, spec.loss_fn,
                         schedules.bn_momentum_schedule(32, 200000))
    # conv1-conv4 over the 4 x 64 points, fc1 and fc2 over the batch; conv5's
    # BatchNorm is the fused head's.
    assert spy == [((4, 64, 64), True), ((4, 64, 64), True),
                   ((4, 64, 64), True), ((4, 64, 128), True),
                   ((4, 1024), True), ((4, 1024), True)]
    for kernel in ("batch_norm_fwd", "batch_norm_bwd"):
        assert cost.kernels[kernel]["calls"] == 6
    want = sum(roofline.kernel_bound("batch_norm_fwd", rows=r, c=c,
                                     dtype=torch.float32)["bytes"]
               for r, c in [(256, 64)] * 3 + [(256, 128)] + [(4, 1024)] * 2)
    assert cost.kernels["batch_norm_fwd"]["bytes"] == want


@pytest.mark.parametrize("kernel,passes", [("batch_norm_fwd", 2),
                                           ("batch_norm_bwd", 3)])
def test_the_bound_is_the_activation_bytes(kernel, passes):
    rows, c = 65536, 64
    kb = roofline.kernel_bound(kernel, rows=rows, c=c, dtype="bf16")
    assert kb["bound_by"] == "bytes"
    assert kb["bytes"] == passes * rows * c * 2 + 6 * c * 4
    assert kb["bound_ms"] == pytest.approx(
        kb["bytes"] / roofline.PEAK_BYTES_PER_S * 1e3)


def test_the_kernel_wrappers_refuse_cpu_tensors():
    y = torch.randn(8, 4)
    vec = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        batch_norm.batch_norm_fwd_cuda(y, vec, vec, vec.clone(), vec.clone(),
                                       0.9, EPS, True)
    with pytest.raises(ValueError, match="CUDA"):
        batch_norm.batch_norm_bwd_cuda(y, y, torch.ones(2, 4), vec, vec,
                                       EPS, True)
