"""bfloat16 master weights (``--bf16_params``) and bfloat16 optimizer
moments (``--bf16_moments``), with stochastic rounding.

Counterpart of ``pointnet_autoencoder_tpu/train/master.py``:

- The matmul parameters (the weights and biases of the ``dense``,
  ``convt`` and ``conv`` modules: ``<layer>.dense.*`` and
  ``<layer>.convt.*`` here) are stored in bf16 (``cast_master_bf16``).
  BatchNorm ``gamma``/``beta`` and the ``mean``/``var`` buffers stay f32.
- ``MasterOptimizer`` runs Adam or the momentum optimizer in f32 whatever
  the storage: each gradient is upcast, the moment slots are f32 (or bf16
  under ``--bf16_moments``, upcast at the arithmetic), and the update is
  the arithmetic of ``torch.optim.Adam``/``SGD`` (``train/state.py``).
  ``p + u`` is applied exactly to f32 leaves and through
  ``stochastic_round_bf16`` into bf16 leaves, so the expected update is
  unbiased and tiny updates accumulate instead of rounding away.
- Stochastic rounding is the bit trick of the JAX package: bf16 is the
  high half of an f32's bits, so adding a uniform 16-bit integer to the
  bits and clearing the low half rounds up with probability equal to the
  dropped fraction. On int32 the addition wraps as the uint32 one does
  mod 2^32, so no unsigned type is needed.
- The noise of step s is a deterministic function of s, the JAX
  package's ``fold_in(key, step)``: the same across a resume and on every
  rank of a group, so data-parallel replicas stay bit-equal. It has two
  streams, the weights' and (``--bf16_moments``) the moments', each for
  its bf16 leaves concatenated in parameter order, each at its full size:
  under tensor parallelism (``shards``) a split leaf takes its slice of
  its full noise, so every rank of a model group rounds the replicated
  leaves with the same noise (they stay bit-equal) and the ranks together
  draw what one device draws. The JAX package's moments ``count`` starts
  at 0 and advances once per update, as the step does.
- On a card both streams come from one Philox generator, seeded once with
  ``SR_BASE_KEY``: step s draws them in one draw (the weights' values,
  then the moments') at the offset s * inc, where inc is what one draw of
  that size advances the offset (fixed for a size and a card; read once
  from the generator). The eager step sets the offset before its draw; a
  captured step registers the generator with its graph, and the caller
  sets its offset to the first step's before each replay (``seek``),
  after which the replayed draws run on from there as the eager ones
  would. One generator, not one per stream: every replay refills the
  seed and offset of each generator its graph registers, two host
  operations each. The CPU's generator (mt19937) has no offsets: the CPU
  runs eager and seeds a generator per stream with (key, s) at every
  step, ``SR_BASE_KEY`` for the weights and ``MOMENTS_KEY`` for the
  moments. Philox and mt19937 draw different bits, so a card's run is
  bit-equal to itself, not to the CPU's.
- On a card the step makes no host sync (``capturable``): the learning
  rate is a 0-dim f32 tensor that ``TrainState.set_lr`` writes, and the
  step count a device tensor from which Adam's bias corrections are
  computed in f32 on the device, as capturable ``torch.optim.Adam`` does
  (and as optax does from its count). So a Trainer captures the step as
  a CUDA graph (``utils/graphs.py``). The CPU computes the corrections
  on the host, ``torch.optim.Adam``'s default form.

The reference trains pure f32; this is the JAX package's opt-in bf16 mode
carried over. On this card it saves state bytes, not time (PERF.md).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor

# Module names whose weight and bias take part in the matmuls
# (nn/layers.py: Dense is held as ``dense``, ConvTranspose as ``convt``).
MATMUL_MODULES = frozenset({"dense", "convt", "conv"})

SR_BASE_KEY = 0x5EED
MOMENTS_KEY = SR_BASE_KEY ^ 0x3A7
# The noise streams' seeds on the CPU, in the step's order: the weights'
# and the moments'.
STREAM_KEYS = (SR_BASE_KEY, MOMENTS_KEY)

# TF's Adam defaults, as train/state.make_optimizer's.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

# Bit patterns as int32: 0xFFFF0000 keeps an f32's high half; the sign
# bit; an f32 quiet NaN whose high half is bf16's 0x7FC0.
_HIGH_HALF = -65536
_SIGN = -(1 << 31)
_QUIET_NAN = 0x7FC00000


def is_matmul_param(name: str) -> bool:
    """Whether the parameter ``name`` (a ``named_parameters`` key) belongs
    to the matmul class: a module on its path is ``dense``, ``convt`` or
    ``conv``."""
    return any(part in MATMUL_MODULES for part in name.split(".")[:-1])


def cast_master_bf16(model: nn.Module) -> nn.Module:
    """Store ``model``'s matmul parameters in bf16, in place; every other
    parameter and every buffer keeps its dtype. Returns the model."""
    for name, p in model.named_parameters():
        if is_matmul_param(name):
            p.data = p.data.to(torch.bfloat16)
    return model


def stochastic_round_bf16(x: Tensor, noise: Tensor) -> Tensor:
    """``x`` rounded to bf16 stochastically with ``noise``, integers in
    [0, 2^16) of ``x``'s shape (any integer dtype): the JAX package's
    ``stochastic_round_bf16`` on the same bits, bit for bit. A carry out
    of the largest finite value rounds to inf. Non-finite values take a
    plain cast, as XLA's: inf stays inf, and NaN becomes the quiet NaN
    0x7FC0 with its sign (PyTorch's own vectorized cast gives 0xFFFF), so
    the whole result is built on the bits."""
    xf = x.float()
    bits = xf.view(torch.int32)
    rounded = (bits + noise.to(torch.int32)) & _HIGH_HALF
    quiet_nan = (bits & _SIGN) | _QUIET_NAN
    out = torch.where(torch.isfinite(xf), rounded,
                      torch.where(torch.isnan(xf), quiet_nan, bits))
    # The high half, by an arithmetic shift: it fits int16 exactly.
    return (out >> 16).to(torch.int16).view(torch.bfloat16)


def draw_noise(shape, generator: torch.Generator) -> Tensor:
    """Uniform 16-bit integers (int32) of ``shape`` from ``generator``, on
    its device."""
    return torch.randint(0, 1 << 16, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int32)


def stochastic_round_bf16_from(x: Tensor,
                               generator: torch.Generator) -> Tensor:
    """``stochastic_round_bf16`` with noise drawn from ``generator`` (on
    ``x``'s device)."""
    return stochastic_round_bf16(x, draw_noise(x.shape, generator))


def _seed(base: int, step: int) -> int:
    return (base << 32) | (step & 0xFFFFFFFF)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _as_f32(tensors: List[Tensor]
            ) -> Tuple[List[Tensor], Optional[Tensor]]:
    """f32 versions of ``tensors``, in order: the f32 ones themselves, the
    others views of one flat f32 copy of them, which is returned too
    (None if every tensor is f32)."""
    low = [t for t in tensors if t.dtype != torch.float32]
    if not low:
        return list(tensors), None
    flat = torch.cat([t.reshape(-1) for t in low]).float()
    views = iter(_split(flat, low))
    return [t if t.dtype == torch.float32 else next(views)
            for t in tensors], flat


def _split(flat: Tensor, like: List[Tensor]) -> List[Tensor]:
    """``flat`` cut into views of the shapes of ``like``, in order."""
    return [v.view(t.shape) for v, t in
            zip(flat.split([t.numel() for t in like]), like)]


def _full_shapes(tensors: List[Tensor], names: List[str],
                 shards: Dict[str, Tuple[int, int, int]]) -> List[List[int]]:
    """The shape of each bf16 member of ``tensors`` (named by ``names``)
    at its whole leaf's size: a member split over a model group
    (``shards``: name -> (dim, rank, parts)) at its full shape."""
    full = []
    for t, n in zip(tensors, names):
        if t.dtype == torch.float32:
            continue
        shape = list(t.shape)
        if n in shards:
            dim, _, parts = shards[n]
            shape[dim] *= parts
        full.append(shape)
    return full


def _round_into(tensors: List[Tensor], names: List[str],
                flat: Optional[Tensor], drawn: Optional[Tensor],
                shards: Dict[str, Tuple[int, int, int]]) -> None:
    """Round ``flat``, the f32 working copy that ``_as_f32(tensors)`` made
    of their bf16 members, stochastically back into those members, with
    ``drawn``, the noise of their ``_full_shapes`` concatenated: a member
    split over a model group takes its slice of its full shape's."""
    if flat is None:
        return
    low = [(t, n) for t, n in zip(tensors, names) if t.dtype != torch.float32]
    noise = drawn
    if shards:
        full = _full_shapes(tensors, names, shards)
        parts = []
        for (t, n), shape, seg in zip(low, full, drawn.split(
                [math.prod(s) for s in full])):
            seg = seg.view(shape)
            if n in shards:
                dim, rank, _ = shards[n]
                seg = seg.narrow(dim, rank * t.shape[dim], t.shape[dim])
            parts.append(seg.reshape(-1))
        noise = torch.cat(parts)
    rounded = stochastic_round_bf16(flat, noise)
    members = [t for t, _ in low]
    torch._foreach_copy_(members, _split(rounded, members))


class MasterOptimizer:
    """Adam or momentum SGD with f32 arithmetic over parameters of mixed
    storage: bf16 leaves take the update through stochastic rounding, f32
    leaves exactly. The interface the Trainer uses of a
    ``torch.optim.Optimizer``: ``param_groups`` (one group; its ``lr`` a
    0-dim f32 tensor on the parameters' device that the Trainer writes
    before each step), ``zero_grad``, ``step``,
    ``state_dict`` and ``load_state_dict``; and for captured steps
    ``generators`` (to register), ``seek`` and ``count_steps``.

    named_params: ``model.named_parameters()``; the names pick the matmul
      class (``is_matmul_param``).
    name: 'adam' (``ADAM_BETAS``, ``ADAM_EPS``) or 'momentum' (no
      Nesterov, no dampening).
    bf16_moments: store the matmul class's moment slots in bf16 (Adam's
      ``exp_avg`` and ``exp_avg_sq``, momentum's ``momentum_buffer``),
      rounded stochastically after each update; BN parameters' slots stay
      f32. The slots start at zero, which bf16 holds exactly.
    shards: under tensor parallelism, each parameter that is this rank's
      slice of a split leaf, name -> (dim, rank, parts) (the split
      dimension, this rank's index and the model group's size): its noise
      is its slice of the full leaf's.

    ``capturable`` (on a card) computes the step's scalars from the device
    tensors on the device, with no host sync.
    """

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 name: str = "adam", momentum: float = 0.9,
                 bf16_moments: bool = False,
                 shards: Optional[Dict[str, Tuple[int, int, int]]] = None):
        if name not in ("adam", "momentum"):
            raise ValueError(f"unknown optimizer {name!r} (use 'adam' or "
                             f"'momentum')")
        named = list(named_params)
        self.names: List[str] = [n for n, _ in named]
        self.params: List[nn.Parameter] = [p for _, p in named]
        self.name = name
        self.momentum = momentum
        self.bf16_moments = bf16_moments
        self.shards = dict(shards or {})
        device = self.params[0].device if self.params else torch.device("cpu")
        self.capturable = device.type == "cuda"
        self.param_groups: List[Dict[str, Any]] = [
            {"params": self.params,
             "lr": torch.zeros((), dtype=torch.float32, device=device)}]
        # The optimizer steps taken (Adam's bias-correction count, and the
        # step of both noise streams): on the device, advanced by the step
        # itself (so a replayed step advances it too), and on the host.
        self._count = torch.zeros((), dtype=torch.int64, device=device)
        self._host_steps = 0
        # On a card, the one Philox generator of both noise streams; step
        # s draws at s * inc, ``_inc`` = (draw size, inc) once read.
        self.generators: Tuple[torch.Generator, ...] = (
            (torch.Generator(device=device).manual_seed(SR_BASE_KEY),)
            if device.type == "cuda" else ())
        self._inc: Optional[Tuple[int, int]] = None
        slot_names = (("exp_avg", "exp_avg_sq") if name == "adam"
                      else ("momentum_buffer",))
        self.slots: Dict[str, Dict[str, Tensor]] = {
            n: {s: torch.zeros(p.shape, dtype=self.slot_dtype(n),
                               device=p.device) for s in slot_names}
            for n, p in named}

    @property
    def steps(self) -> int:
        """The optimizer steps taken (read from the device)."""
        return int(self._count)

    def slot_dtype(self, name: str) -> torch.dtype:
        """The storage type of parameter ``name``'s moment slots."""
        return (torch.bfloat16 if self.bf16_moments and is_matmul_param(name)
                else torch.float32)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def count_steps(self, k: int) -> None:
        """Advance the host's count by ``k`` steps that the device took
        (replays), or take back the steps a capture counted."""
        self._host_steps += k

    def seek(self, step: int) -> None:
        """Set the noise generator's offset to the draw of ``step``: before
        a replay of captured steps from ``step`` on, whose draws then run
        on from there as the eager steps' would. Before the first draw
        there is nothing to set (the captured steps draw nothing)."""
        if self._inc is not None:
            self.generators[0].set_offset(step * self._inc[1])

    def _noise(self, step: int, sizes: List[int]
               ) -> List[Optional[Tensor]]:
        """Step ``step``'s noise of each stream, ``sizes`` values each (None
        where 0): on a card one draw of their sum at the offset step * inc,
        cut in order; on the CPU a draw each from a generator seeded with
        (the stream's key, step)."""
        if not self.generators:
            return [draw_noise((n,), torch.Generator(
                device=self.params[0].device).manual_seed(_seed(key, step)))
                if n else None for key, n in zip(STREAM_KEYS, sizes)]
        total = sum(sizes)
        if not total:
            return [None] * len(sizes)
        gen = self.generators[0]
        if not _capturing():
            # Under capture the draws run on from the replay's offset.
            if self._inc is None or self._inc[0] != total:
                gen.set_offset(0)
                draw_noise((total,), gen)
                self._inc = (total, gen.get_offset())
            gen.set_offset(step * self._inc[1])
        return list(draw_noise((total,), gen).split(sizes))

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter with a gradient, at the group's
        ``lr``: the arithmetic runs over all leaves at once
        (``torch._foreach_*``); the bf16 leaves, and the bf16 slots, are
        upcast as one flat f32 tensor each and rounded back with one
        noise draw of their stream."""
        lr = self.param_groups[0]["lr"]
        step = self._host_steps
        self._host_steps = step + 1
        self._count.add_(1)
        live = [(n, p) for n, p in zip(self.names, self.params)
                if p.grad is not None]
        if not live:
            return
        params = [p for _, p in live]
        grads, _ = _as_f32([p.grad for p in params])
        p32, p_flat = _as_f32(params)
        slot_kinds = list(self.slots[live[0][0]])
        stored = [self.slots[n][s] for s in slot_kinds for n, _ in live]
        work, slot_flat = _as_f32(stored)
        if self.name == "adam":
            # torch.optim.Adam's arithmetic, its foreach form: capturable
            # (the corrections in f32 from the device count) on a card.
            b1, b2 = ADAM_BETAS
            m, v = work[:len(live)], work[len(live):]
            torch._foreach_lerp_(m, grads, 1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
            denom = torch._foreach_sqrt(v)
            if self.capturable:
                t = self._count.float()
                torch._foreach_div_(denom, (1 - torch.pow(b2, t)).sqrt())
                torch._foreach_add_(denom, ADAM_EPS)
                torch._foreach_div_(denom, -lr / (1 - torch.pow(b1, t)))
                torch._foreach_addcdiv_(p32, m, denom)
            else:
                t, lr = step + 1, float(lr)
                torch._foreach_div_(denom, (1 - b2 ** t) ** 0.5)
                torch._foreach_add_(denom, ADAM_EPS)
                torch._foreach_addcdiv_(p32, m, denom,
                                        value=-(lr / (1 - b1 ** t)))
        else:
            torch._foreach_mul_(work, self.momentum)
            torch._foreach_add_(work, grads)
            if self.capturable:
                torch._foreach_add_(p32, torch._foreach_mul(work, -lr))
            else:
                torch._foreach_add_(p32, work, alpha=-float(lr))
        names = [n for n, _ in live]
        # The weights', then the moments' (STREAM_KEYS order).
        rounds = [(params, names, p_flat),
                  (stored, names * len(slot_kinds), slot_flat)]
        noise = self._noise(step, [
            sum(math.prod(shape) for shape in _full_shapes(
                tensors, n, self.shards)) for tensors, n, _ in rounds])
        for (tensors, n, flat), drawn in zip(rounds, noise):
            _round_into(tensors, n, flat, drawn, self.shards)

    def state_dict(self) -> Dict[str, Any]:
        """The step and the learning rate as numbers (read from the
        device), and every slot by parameter name (tensors, not copies;
        bf16 slots stay bf16)."""
        return {"kind": "master", "name": self.name,
                "bf16_moments": self.bf16_moments, "steps": self.steps,
                "lr": float(self.param_groups[0]["lr"]),
                "slots": {n: dict(s) for n, s in self.slots.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore ``state_dict``'s contents in place, slot dtypes and all
        (the learning rate into the group's tensor); raises ValueError for
        the state of another optimizer or another slot storage."""
        if state.get("kind") != "master" or state["name"] != self.name \
                or bool(state["bf16_moments"]) != self.bf16_moments:
            raise ValueError(
                f"optimizer state of another kind ("
                f"{state.get('name', 'torch.optim')}, bf16_moments="
                f"{state.get('bf16_moments')}) for a {self.name} "
                f"MasterOptimizer with bf16_moments={self.bf16_moments}")
        if sorted(state["slots"]) != sorted(self.slots):
            raise ValueError("optimizer state for other parameters")
        for n, slots in self.slots.items():
            for s, v in slots.items():
                stored = state["slots"][n][s]
                if stored.dtype != v.dtype or stored.shape != v.shape:
                    raise ValueError(
                        f"slot {n}.{s}: stored {stored.dtype} "
                        f"{tuple(stored.shape)}, expected {v.dtype} "
                        f"{tuple(v.shape)}")
                v.copy_(stored)
        self._host_steps = int(state["steps"])
        self._count.fill_(self._host_steps)
        self.param_groups[0]["lr"].fill_(float(state["lr"]))
