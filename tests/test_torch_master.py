"""bf16 master weights and moments of the port
(pointnet_autoencoder_tpu_torch/train/master.py) on the CPU, against the
JAX package's train/master.py.

- Stochastic rounding bit-equal to the JAX package's on the same 16-bit
  noise (drawn by ``jax.random.bits(key, shape, jnp.uint16)``, master.py's
  own call), special values included; exact on representable values,
  sign-symmetric, unbiased within 4 sigma, accumulating tiny updates (the
  JAX package's tests/test_master.py:24-180).
- The matmul class equals ``cast_master_bf16``'s leaf for leaf, through
  ``convert.from_flax_variables``; a JAX ``--bf16_params`` Trainer's tree
  moves into the port with its bf16 leaves.
- The optimizer's f32 arithmetic against ``f32_math(optax.adam)`` and
  ``f32_math(optax.sgd(momentum))`` over 5 steps, with bf16 leaves and the
  rounding noise at zero (truncation on both sides): the weights rtol
  1e-6, atol 1e-9, the moments rtol 1e-6 and an atol of 2^-22 of their
  largest entry (torch's lerp against optax's sum); ``--bf16_moments``
  as tests/test_master.py:281-344.
- The Trainer with ``bf16_params``, ``bf16_moments`` and both: 2 epochs at
  num_point 64, finite, eval loss under 2x the f32-master run's (JAX's
  envelope, tests/test_master.py:249-278); a resume after step 5 ends
  bit-equal to 10 uninterrupted steps; the checkpoint serves through
  ``InferenceSession`` and ``cli.export``.
- The card's form of the step on the CPU (``capturable``: a tensor
  learning rate, the bias corrections in f32 from the device count)
  against the same optax arithmetic; the noise generator's offsets on a
  card through a stand-in CUDA generator: step s draws at s * inc, a
  resume at step 5 at 5 * inc, from a checkpoint as this optimizer has
  always written it (an int step count, a float learning rate).
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pointnet_autoencoder_tpu.config import TrainConfig as JTrainConfig
from pointnet_autoencoder_tpu.data import synthetic as jsynthetic
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu.train import master as jmaster
from pointnet_autoencoder_tpu_torch.cli import export as export_cli
from pointnet_autoencoder_tpu_torch.config import TrainConfig
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.data import synthetic
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.models.registry import (get_model_spec,
                                                            reference_models)
from pointnet_autoencoder_tpu_torch.train import checkpoint, master
from pointnet_autoencoder_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

NUM_POINT = 64
BATCH = 5


def _bits(x) -> np.ndarray:
    return (x.view(torch.int16).numpy().view(np.uint16) if torch.is_tensor(x)
            else np.asarray(x).view(np.uint16))


def _noise(key, shape):
    """JAX's 16-bit draw (master.py:99), as int32 for the port."""
    return np.asarray(jax.random.bits(key, shape, jnp.uint16)).astype(
        np.int32)


# -- stochastic rounding ------------------------------------------------------

SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38,
                    np.finfo(np.float32).max, -np.finfo(np.float32).max,
                    np.inf, -np.inf, 1.0, -2.5, 0.1, 1.0 + 2.0 ** -9],
                   np.float32)
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF, 0xFF812345],
                np.uint32).view(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sr_bit_equal_to_jax_on_the_same_bits(seed):
    rng = np.random.RandomState(seed)
    x = np.concatenate([SPECIAL, NANS, (rng.randn(4096) * 10.0 ** rng.uniform(
        -40, 38, 4096)).astype(np.float32)])
    key = jax.random.PRNGKey(seed)
    want = jmaster.stochastic_round_bf16(jnp.asarray(x), key)
    got = master.stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(
        _noise(key, x.shape)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The largest finite value carries into inf under most draws.
    top = np.flatnonzero(x == np.finfo(np.float32).max)[0]
    assert float(got[top]) in (float(np.finfo(np.float32).max), math.inf)


def test_sr_exact_on_representable_values():
    vals = torch.tensor([0.0, 1.0, -2.5, 0.15625, 3.0e38, -1e-38]).to(
        torch.bfloat16).float()
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        out = master.stochastic_round_bf16_from(vals, gen)
        assert torch.equal(out.float(), vals)


def test_sr_sign_symmetric_and_within_one_ulp():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(7)) * 3.0
    noise = master.draw_noise(x.shape, torch.Generator().manual_seed(11))
    up = master.stochastic_round_bf16(x, noise).float()
    dn = master.stochastic_round_bf16(-x, noise).float()
    assert torch.equal(up, -dn)
    ulp = x.to(torch.bfloat16).float().abs() * 2.0 ** -7 + 1e-45
    assert bool(((up - x).abs() <= ulp * 1.0000001).all())


def test_sr_unbiased_within_four_sigma():
    lo, hi = 1.0, 1.0 + 2.0 ** -7
    frac = 0.25
    x = torch.full((65536,), (1 - frac) * lo + frac * hi)
    out = master.stochastic_round_bf16_from(
        x, torch.Generator().manual_seed(3)).float()
    assert set(out.unique().tolist()) <= {lo, hi}
    p_up = float((out == hi).float().mean())
    sigma = math.sqrt(frac * (1 - frac) / x.numel())
    assert abs(p_up - frac) < 4 * sigma, (p_up, sigma)
    mean = float(out.double().mean())
    assert abs(mean - float(x[0])) < 4 * sigma * (hi - lo)


def test_sr_nonfinite_guard():
    x = torch.tensor([math.inf, -math.inf, math.nan, 1.0])
    out = master.stochastic_round_bf16_from(x, torch.Generator()).float()
    assert out[0] == math.inf and out[1] == -math.inf
    assert math.isnan(out[2]) and out[3] == 1.0


def test_sr_accumulates_tiny_updates():
    """400 updates of 1e-3 ulp each move a bf16 leaf by their sum in
    expectation through the optimizer's rounding; a plain cast never
    moves."""
    p = nn.Parameter(torch.ones(2048, dtype=torch.bfloat16))
    opt = master.MasterOptimizer([("dense.weight", p)], "momentum",
                                 momentum=0.0)
    opt.param_groups[0]["lr"].fill_(1.0)
    u = 1e-3 * 2.0 ** -7
    for _ in range(400):
        p.grad = torch.full((2048,), -u, dtype=torch.bfloat16)
        opt.step()
    # The bf16 gradient is -u rounded: the drift is 400 of those.
    step = -float(torch.tensor(-u, dtype=torch.bfloat16))
    drift = float(p.detach().float().mean()) - 1.0
    assert drift == pytest.approx(400 * step, rel=0.25)
    det = (torch.ones(2048) + u).to(torch.bfloat16)
    assert float(det.float().mean()) == 1.0


# -- the matmul class ---------------------------------------------------------


@pytest.mark.parametrize("name", reference_models())
def test_matmul_selection_equals_jax_leaf_for_leaf(name):
    num_point = 2048 if "upconv" in name else 128
    _, jvars = jspec(name).init_variables(jax.random.PRNGKey(0), num_point)
    jparams = jmaster.cast_master_bf16(jvars["params"])
    moved = from_flax_variables(jax.device_get(
        {"params": jparams, "batch_stats": jvars["batch_stats"]}),
        keep_bf16=True)
    model = master.cast_master_bf16(get_model_spec(name).make(num_point))
    ours = dict(model.named_parameters())
    assert sorted(ours) == sorted(k for k in moved
                                  if not k.endswith((".mean", ".var")))
    assert any(t.dtype == torch.bfloat16 for t in ours.values())
    for k, t in ours.items():
        assert t.dtype == moved[k].dtype, k
        assert master.is_matmul_param(k) == (t.dtype == torch.bfloat16), k
    for k, b in model.named_buffers():
        assert b.dtype == torch.float32 and moved[k].dtype == torch.float32


def test_convert_moves_a_jax_bf16_params_trainer(tmp_path):
    """A JAX Trainer with --bf16_params holds bf16 matmul leaves; they move
    into the port kept (bit for bit) or upcast (exactly), and the kept
    tree loads into a port model cast by ``cast_master_bf16``."""
    from pointnet_autoencoder_tpu.train.loop import Trainer as JTrainer

    root = jsynthetic.write_fixture(str(tmp_path / "data"), 24, NUM_POINT,
                                    categories=["Chair"])
    jt = JTrainer(JTrainConfig(
        model="model", category="Chair", log_dir=str(tmp_path / "jlog"),
        num_point=NUM_POINT, batch_size=4, data_path=root,
        data_parallel=1, bf16_params=True))
    try:
        tree = jax.device_get({"params": jt.state.params,
                               "batch_stats": jt.state.batch_stats})
    finally:
        jt.close()
    kept = from_flax_variables(tree, keep_bf16=True)
    up = from_flax_variables(tree)
    kernel = tree["params"]["encoder"]["conv2"]["dense"]["kernel"]
    assert np.asarray(kernel).dtype.name == "bfloat16"
    w = kept["encoder.conv2.dense.weight"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(w.t().contiguous()), _bits(kernel))
    for k, t in kept.items():
        assert up[k].dtype == torch.float32
        assert torch.equal(up[k], t.float()), k
    model = master.cast_master_bf16(get_model_spec("model").make(NUM_POINT))
    model.load_state_dict(kept)
    assert torch.equal(model.encoder.conv2.dense.weight, w)


# -- the optimizer's f32 arithmetic -------------------------------------------


class _Mixed(nn.Module):
    """A bf16 matmul leaf pair and f32 BN parameters."""

    def __init__(self, w, b, gamma):
        super().__init__()
        self.layer = nn.Module()
        self.layer.dense = nn.Module()
        self.layer.bn = nn.Module()
        self.layer.dense.weight = nn.Parameter(w)
        self.layer.dense.bias = nn.Parameter(b)
        self.layer.bn.gamma = nn.Parameter(gamma)


def _truncate(x):
    """SR with zero noise in JAX: the f32 bits' low half cleared."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    return jax.lax.bitcast_convert_type(
        bits & jnp.uint32(0xFFFF0000), jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_update_matches_jax_f32_math_with_zero_noise(name, monkeypatch):
    _zero_noise_update_against_jax(name, False, monkeypatch)


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_device_form_matches_jax_f32_math_with_zero_noise(name,
                                                          monkeypatch):
    """The card's form (``capturable``: the learning rate a tensor, the
    bias corrections in f32 from the device count, as optax computes
    them from its count), run on the CPU, at the same tolerances, and its
    f32 leaf at least as close to optax's as the host form's."""
    device = _zero_noise_update_against_jax(name, True, monkeypatch)
    assert device <= _zero_noise_update_against_jax(name, False, monkeypatch)


def _zero_noise_update_against_jax(name, capturable, monkeypatch) -> float:
    """Five updates against ``f32_math(optax)``'s with zero noise, held to
    the tolerances below; returns the f32 leaf's largest gap."""
    rng = np.random.RandomState(5)
    w = rng.randn(16, 12).astype(np.float32)
    b = (0.1 * rng.randn(16)).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    lr = 1e-3 if name == "adam" else 0.05
    jparams = {"dense": {"kernel": jnp.asarray(w).astype(jnp.bfloat16),
                         "bias": jnp.asarray(b).astype(jnp.bfloat16)},
               "bn": {"gamma": jnp.asarray(gamma)}}
    tx = jmaster.f32_math(optax.adam(lr) if name == "adam"
                          else optax.sgd(lr, momentum=0.9))
    jstate = tx.init(jparams)
    model = _Mixed(torch.from_numpy(w).to(torch.bfloat16),
                   torch.from_numpy(b).to(torch.bfloat16),
                   torch.from_numpy(gamma))
    opt = master.MasterOptimizer(model.named_parameters(), name,
                                 momentum=0.9)
    opt.capturable = capturable
    monkeypatch.setattr(master, "draw_noise", lambda shape, generator:
                        torch.zeros(tuple(shape), dtype=torch.int32))
    for _ in range(5):
        gw = (0.1 * rng.randn(16, 12)).astype(np.float32)
        gb = (0.1 * rng.randn(16)).astype(np.float32)
        gg = (0.1 * rng.randn(16)).astype(np.float32)
        jgrads = {"dense": {"kernel": jnp.asarray(gw).astype(jnp.bfloat16),
                            "bias": jnp.asarray(gb).astype(jnp.bfloat16)},
                  "bn": {"gamma": jnp.asarray(gg)}}
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = {
            "dense": {k: _truncate(jparams["dense"][k].astype(jnp.float32)
                                   + updates["dense"][k])
                      for k in ("kernel", "bias")},
            "bn": {"gamma": jparams["bn"]["gamma"] + updates["bn"]["gamma"]}}
        for p, g in ((model.layer.dense.weight, gw),
                     (model.layer.dense.bias, gb), (model.layer.bn.gamma, gg)):
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.param_groups[0]["lr"].fill_(lr)
        opt.step()
    tol = dict(rtol=1e-6, atol=1e-9)
    for got, want in ((model.layer.dense.weight, jparams["dense"]["kernel"]),
                      (model.layer.dense.bias, jparams["dense"]["bias"]),
                      (model.layer.bn.gamma, jparams["bn"]["gamma"])):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32)
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), **tol)
    inner = jstate[0]
    slots = opt.slots
    if name == "adam":
        pairs = (("exp_avg", inner.mu), ("exp_avg_sq", inner.nu))
    else:
        pairs = (("momentum_buffer", inner.trace),)
    for slot, tree in pairs:
        for port, jname in (("layer.dense.weight", ("dense", "kernel")),
                            ("layer.dense.bias", ("dense", "bias")),
                            ("layer.bn.gamma", ("bn", "gamma"))):
            want = np.asarray(tree[jname[0]][jname[1]])
            assert slots[port][slot].dtype == torch.float32
            # The slots are torch.optim.Adam's (lerp for the first
            # moment), optax's a different order of the same terms: they
            # differ by ulps of the largest term, which a moment that
            # cancels to near zero shows as a relative error.
            np.testing.assert_allclose(
                slots[port][slot].numpy(), want, rtol=1e-6,
                atol=max(1e-9, 2.0 ** -22 * float(np.abs(want).max())),
                err_msg=f"{slot} {port}")
    return float(np.abs(model.layer.bn.gamma.detach().numpy()
                        - np.asarray(jparams["bn"]["gamma"])).max())


def test_f32_leaves_equal_torch_adam_bit_for_bit():
    """Without bf16 leaves the update is torch.optim.Adam's single-tensor
    arithmetic, bit for bit, so the flags change only the storage. Both
    step at the learning rate the group's f32 tensor holds."""
    torch.manual_seed(0)
    a = [nn.Parameter(torch.randn(8, 5)), nn.Parameter(torch.randn(5))]
    b = [nn.Parameter(t.detach().clone()) for t in a]
    ours = master.MasterOptimizer(
        [(f"bn.p{i}", p) for i, p in enumerate(b)], "adam")
    lr = ours.param_groups[0]["lr"].fill_(1e-3)
    ref = torch.optim.Adam(a, lr=float(lr), betas=(0.9, 0.999), eps=1e-8,
                           foreach=False)
    for _ in range(6):
        grads = [torch.randn_like(p) for p in a]
        for p, q, g in zip(a, b, grads):
            p.grad, q.grad = g.clone(), g.clone()
        ref.step()
        ours.step()
    for p, q in zip(a, b):
        assert torch.equal(p, q)


# -- the noise streams' offsets on a card -------------------------------------


class StandInGenerator:
    """A CUDA generator's offset calls, on the CPU: each offset set is
    recorded, and each draw at its offset, which it moves on by 4 per 1000
    values begun (a whole
    number of Philox rounds; the optimizer reads what a draw of its size
    advances, once, from the generator)."""

    def __init__(self):
        self.offset = 0
        self.draws = []
        self.sets = []

    def get_offset(self):
        return self.offset

    def set_offset(self, offset):
        self.sets.append(offset)
        self.offset = offset

    def draw(self, shape):
        self.draws.append(self.offset)
        self.offset += inc(math.prod(shape))
        return torch.zeros(tuple(shape), dtype=torch.int32)


def inc(size):
    """The offset a stand-in draw of ``size`` values advances."""
    return 4 * -(-size // 1000)


def stand_in_noise(monkeypatch, opt):
    """``opt``'s noise generator, as on a card, replaced by a stand-in
    that ``master.draw_noise`` then draws from; returns it."""
    monkeypatch.setattr(master, "draw_noise",
                        lambda shape, generator: generator.draw(shape))
    opt.generators = (StandInGenerator(),)
    return opt.generators[0]


def test_step_s_draws_at_s_inc_and_a_resume_at_5_at_5_inc(monkeypatch):
    """Step s draws both streams' noise in one draw at offset s * inc, inc
    read once from a draw at offset 0; a state resumed at step 5 draws at
    5 * inc. The draw holds the weights' noise, for the bf16 weight and
    bias, then the moments', for their two bf16 slots each."""
    rng = np.random.RandomState(2)

    def make():
        model = _Mixed(torch.from_numpy(rng.randn(40, 30).astype(
            np.float32)).to(torch.bfloat16), torch.zeros(
            40, dtype=torch.bfloat16), torch.ones(40))
        return model, master.MasterOptimizer(model.named_parameters(),
                                             "adam", bf16_moments=True)

    def step(model, opt):
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(
                np.float32)).to(p.dtype)
        opt.step()

    model, opt = make()
    gen = stand_in_noise(monkeypatch, opt)
    for _ in range(3):
        step(model, opt)
    i = inc(1240 + 2480)
    assert gen.draws == [0, 0, i, 2 * i] and gen.offset == 3 * i
    assert opt.steps == 3
    state = dict(opt.state_dict(), steps=5)
    model, again = make()
    gen = stand_in_noise(monkeypatch, again)
    again.load_state_dict(state)
    assert again.steps == 5
    step(model, again)
    assert gen.draws == [0, 5 * i]


# -- bf16 moments -------------------------------------------------------------


def test_bf16_moments_slot_dtypes():
    """Matmul-class slots store bf16, BN-parameter slots f32, as
    ``bf16_moments(optax.adam)`` (tests/test_master.py:281)."""
    params = {"conv": {"kernel": jnp.zeros((8, 16), jnp.float32)},
              "bn": {"scale": jnp.zeros((16,), jnp.float32)}}
    _, inner = jmaster.bf16_moments(optax.adam(1e-3)).init(params)
    jdt = {k: inner[0].mu[k][leaf].dtype
           for k, leaf in (("conv", "kernel"), ("bn", "scale"))}
    opt = master.MasterOptimizer(
        [("conv.weight", nn.Parameter(torch.zeros(16, 8))),
         ("bn.gamma", nn.Parameter(torch.zeros(16)))], "adam",
        bf16_moments=True)
    for port, jkey in (("conv.weight", "conv"), ("bn.gamma", "bn")):
        want = (torch.bfloat16 if jdt[jkey] == jnp.bfloat16
                else torch.float32)
        for slot in opt.slots[port].values():
            assert slot.dtype == want, port
    sgd = master.MasterOptimizer(
        [("conv.weight", nn.Parameter(torch.zeros(16, 8)))], "momentum",
        bf16_moments=True)
    assert sgd.slots["conv.weight"]["momentum_buffer"].dtype == \
        torch.bfloat16


def test_bf16_moments_update_tracks_f32_adam():
    """tests/test_master.py:299: five steps of bf16-moment Adam stay within
    5e-5 of f32 Adam."""
    rng = np.random.RandomState(0)
    w = rng.randn(32, 64).astype(np.float32)
    g = torch.from_numpy((0.1 * rng.randn(32, 64)).astype(np.float32))
    runs = []
    for moments in (False, True):
        p = nn.Parameter(torch.from_numpy(w.copy()))
        opt = master.MasterOptimizer([("conv.weight", p)], "adam",
                                     bf16_moments=moments)
        opt.param_groups[0]["lr"].fill_(1e-3)
        for _ in range(5):
            p.grad = g.clone()
            opt.step()
        runs.append(p.detach())
    np.testing.assert_allclose(runs[0].numpy(), runs[1].numpy(), atol=5e-5)


def test_bf16_moments_no_ema_stall():
    """tests/test_master.py:323: nu keeps moving under a 2x gradient,
    where a deterministic bf16 EMA would freeze."""
    p = nn.Parameter(torch.ones(512, 512))
    opt = master.MasterOptimizer([("conv.weight", p)], "adam",
                                 bf16_moments=True)
    opt.param_groups[0]["lr"].fill_(1e-3)
    nu = opt.slots["conv.weight"]["exp_avg_sq"]
    for value, steps in ((0.1, 30), (0.2, 30)):
        if value == 0.2:
            before = float(nu.float().mean())
        for _ in range(steps):
            p.grad = torch.full_like(p, value)
            opt.step()
    assert nu.dtype == torch.bfloat16
    assert float(nu.float().mean()) > 1.5 * before


def test_state_dict_round_trip_keeps_dtypes_and_refuses_another_kind():
    p = nn.Parameter(torch.randn(4, 3).to(torch.bfloat16))
    q = nn.Parameter(torch.randn(4))
    opt = master.MasterOptimizer([("dense.weight", p), ("bn.gamma", q)],
                                 "adam", bf16_moments=True)
    opt.param_groups[0]["lr"].fill_(1e-2)
    for _ in range(2):
        p.grad, q.grad = torch.randn_like(p), torch.randn_like(q)
        opt.step()
    state = checkpoint.to_host(checkpoint.snapshot(opt.state_dict()))
    again = master.MasterOptimizer([("dense.weight", p), ("bn.gamma", q)],
                                   "adam", bf16_moments=True)
    again.load_state_dict(state)
    assert again.steps == 2 and again.param_groups[0]["lr"] == 1e-2
    for n, slots in opt.slots.items():
        for s, v in slots.items():
            assert again.slots[n][s].dtype == v.dtype
            assert torch.equal(again.slots[n][s], v)
    with pytest.raises(ValueError, match="another kind"):
        master.MasterOptimizer([("dense.weight", p), ("bn.gamma", q)],
                               "adam").load_state_dict(state)


# -- the Trainer --------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """30 Chair shapes: 25 trainval (5 batches of 5), 5 test (1 batch)."""
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 30, NUM_POINT, categories=["Chair"])


def _config(fixture_root, log_dir, **flags):
    return TrainConfig(**dict(dict(
        data_path=fixture_root, category="Chair", num_point=NUM_POINT,
        batch_size=BATCH, log_dir=str(log_dir), max_epoch=2, log_every=5),
        **flags))


@pytest.fixture(scope="module")
def f32_master_loss(fixture_root, tmp_path_factory):
    tr = Trainer(_config(fixture_root, tmp_path_factory.mktemp("f32")),
                 device="cpu")
    try:
        return tr.train()
    finally:
        tr.close()


FLAGS = {"params": dict(bf16_params=True),
         "moments": dict(bf16_moments=True),
         "both": dict(bf16_params=True, bf16_moments=True)}


@pytest.mark.parametrize("which", sorted(FLAGS))
def test_trainer_two_epochs_within_twice_the_f32_master_loss(
        which, fixture_root, f32_master_loss, tmp_path):
    cfg = _config(fixture_root, tmp_path / "log", **FLAGS[which])
    tr = Trainer(cfg, device="cpu")
    try:
        best = tr.train()
        opt = tr.state.optimizer
        assert isinstance(opt, master.MasterOptimizer) and opt.steps == 10
        for n, p in tr.model.named_parameters():
            matmul = master.is_matmul_param(n)
            assert p.dtype == (torch.bfloat16 if matmul and cfg.bf16_params
                               else torch.float32), n
            for slot in opt.slots[n].values():
                assert slot.dtype == (
                    torch.bfloat16 if matmul and cfg.bf16_moments
                    else torch.float32), n
            assert torch.isfinite(p.float()).all(), n
    finally:
        tr.close()
    assert np.isfinite(best) and best < 2.0 * f32_master_loss, (
        best, f32_master_loss)


def _batches(fixture_root, count):
    rng = np.random.RandomState(9)
    return [torch.from_numpy(rng.randn(BATCH, NUM_POINT, 3).astype(
        np.float32)) for _ in range(count)]


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_resume_after_step_5_is_bit_equal_to_10_steps(
        optimizer, fixture_root, tmp_path):
    """Weights, slots and the step after 5 steps, a checkpoint and
    ``--resume``, then 5 more, equal 10 uninterrupted steps bit for bit:
    the optimizer state and the noise's step both resume."""
    flags = dict(bf16_params=True, bf16_moments=True, optimizer=optimizer,
                 momentum=0.9)
    batches = _batches(fixture_root, 10)
    whole = Trainer(_config(fixture_root, tmp_path / "whole", **flags),
                    device="cpu")
    for x in batches:
        whole.train_step(x)
    cfg = _config(fixture_root, tmp_path / "split", async_checkpoints=False,
                  **flags)
    first = Trainer(cfg, device="cpu")
    for x in batches[:5]:
        first.train_step(x)
    first._save("periodic", 0)
    again = Trainer(dataclasses.replace(cfg, resume=True), device="cpu")
    assert again.state.step == 5 and again.state.optimizer.steps == 5
    for x in batches[5:]:
        again.train_step(x)
    want, got = whole.state.state_dict(), again.state.state_dict()
    assert got["step"] == want["step"] == 10
    for k, v in want["model"].items():
        assert v.dtype == got["model"][k].dtype
        assert torch.equal(v, got["model"][k]), k
    for n, slots in want["optimizer"]["slots"].items():
        for s, v in slots.items():
            assert torch.equal(v, got["optimizer"]["slots"][n][s]), (n, s)
    for t in (whole, first, again):
        t.close()


def test_an_int_step_count_in_a_checkpoint_resumes_at_its_offsets(
        fixture_root, tmp_path, monkeypatch):
    """A Trainer checkpoint as this optimizer has always written it
    (``steps`` a Python int, ``lr`` a float) resumes with the step on the
    host and the device, the learning rate in the group's tensor, and the
    first draw after it at 5 * inc."""
    cfg = _config(fixture_root, tmp_path / "log", bf16_params=True,
                  bf16_moments=True, async_checkpoints=False)
    first = Trainer(cfg, device="cpu")
    for x in _batches(fixture_root, 5):
        first.train_step(x)
    opt = first.state.optimizer
    tree = {"model": first.model.state_dict(), "step": 5, "epoch": 1,
            "best_loss": 1.0,
            "optimizer": {"kind": "master", "name": "adam",
                          "bf16_moments": True, "steps": 5, "lr": 0.001,
                          "slots": {n: dict(s)
                                    for n, s in opt.slots.items()}}}
    checkpoint.CheckpointManager(cfg.log_dir).save_periodic(
        checkpoint.to_host(tree))
    first.close()
    again = Trainer(dataclasses.replace(cfg, resume=True), device="cpu")
    try:
        opt = again.state.optimizer
        lr = opt.param_groups[0]["lr"]
        assert again.state.step == opt.steps == 5
        assert torch.is_tensor(lr) and float(lr) == float(np.float32(0.001))
        gen = stand_in_noise(monkeypatch, opt)
        again.train_step(_batches(fixture_root, 1)[0])
        size = sum(p.numel() for n, p in again.model.named_parameters()
                   if master.is_matmul_param(n))
        # The weights' noise and the two bf16 moment slots'.
        assert gen.draws == [0, 5 * inc(3 * size)]
        assert opt.steps == 6
    finally:
        again.close()


def test_checkpoint_serves_and_exports(fixture_root, tmp_path):
    """A --bf16_params checkpoint in an f32 session holds its bf16 weights
    upcast exactly; a bf16 session holds them as they are; cli.export's
    bundle reconstructs as the checkpoint's session."""
    cfg = _config(fixture_root, tmp_path / "log", max_epoch=1,
                  bf16_params=True, bf16_moments=True)
    tr = Trainer(cfg, device="cpu")
    tr.train()
    tr.close()
    path = os.path.join(cfg.log_dir, "best_model_epoch_000.ckpt")
    stored = checkpoint.load(path)["model"]
    assert stored["decoder.fc3.dense.weight"].dtype == torch.bfloat16
    pts = np.random.RandomState(1).randn(7, NUM_POINT, 3).astype(np.float32)
    for bf16 in (False, True):
        sess = InferenceSession("model", path, NUM_POINT, batch_size=4,
                                bf16=bf16, device="cpu")
        # Each stored value in the session's own type: the f32 session
        # upcasts the bf16 weights exactly; the bf16 one casts the f32
        # BN parameters, as it does any checkpoint's.
        for k, v in sess.model.state_dict().items():
            assert torch.equal(v, stored[k].to(v.dtype)), k
        rec = sess.reconstruct(pts)
        assert rec.shape == pts.shape and np.isfinite(rec).all()
    f32 = InferenceSession("model", path, NUM_POINT, batch_size=4,
                           device="cpu")
    upcast = {k: v.float() for k, v in stored.items()}
    torch.save(upcast, str(tmp_path / "upcast.pt"))
    explicit = InferenceSession("model", str(tmp_path / "upcast.pt"),
                                NUM_POINT, batch_size=4, device="cpu")
    np.testing.assert_array_equal(f32.reconstruct(pts),
                                  explicit.reconstruct(pts))
    out = export_cli.main(["--model", "model", "--model_path", path,
                           "--num_point", str(NUM_POINT), "--out",
                           str(tmp_path / "bundle"), "--device", "cpu"])
    bundle = InferenceSession.from_bundle(out, batch_size=4, device="cpu")
    np.testing.assert_array_equal(bundle.reconstruct(pts),
                                  f32.reconstruct(pts))
