"""Training traffic of the stand-in configuration (``configs/standin.json``):
its own network, a per-point Dense layer and ReLU, a max over points and
a Dense layer to the cloud, trained on the Chamfer distance through the
library's ``TrainState.train_step`` and Adam, in a closed loop over a
pool of seeded clouds; checked against its own reference
(``reference/standin.py``).

Set-up makes the weights (``benchmark/weights.py`` over the reference's
leaf shapes) and the pool from the seed and takes the first three steps
on three distinct batches; their losses and each variable's change over
the three are the readings. The window cycles the pool, fetching the
losses every ``fetch_every`` steps. After it the reference takes the same
three steps from the same weights on the same batches.

Workload parameters (``params``): ``batch``, ``pool_batches``,
``fetch_every``, ``clouds`` (``benchmark/clouds.py``). It takes no trace.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from benchmark import clouds, compare, harness, weights
from benchmark.harness import Outcome, Run, memory_peak, synchronize

STREAM_WEIGHTS, STREAM_POOL = 0, 1
TRAIN_STEP = True


def _reference():
    return harness.load_module(harness.ROOT / "reference" / "standin.py")


class Net(nn.Module):
    def __init__(self, config: Dict):
        super().__init__()
        n, w = int(config["num_point"]), int(config["code_width"])
        self.encoder = nn.ModuleDict(
            {"fc1": nn.ModuleDict({"dense": nn.Linear(3, w)})})
        self.decoder = nn.ModuleDict(
            {"fc2": nn.ModuleDict({"dense": nn.Linear(w, 3 * n)})})

    def forward(self, points, train=True, bn_momentum=None):
        code = F.relu(self.encoder["fc1"]["dense"](points)).amax(dim=1)
        return self.decoder["fc2"]["dense"](code).reshape(points.shape), {}


def loss_fn(pred, label, end_points):
    d2 = (pred[:, :, None, :] - label[:, None, :, :]).square().sum(-1)
    loss = d2.amin(dim=2).mean() + d2.amin(dim=1).mean()
    return loss, {"chamfer": loss.detach()}


class Program:
    """The stand-in's train step, set up from the seed and driven through
    its first three steps."""

    def __init__(self, run: Run):
        from pointnet_autoencoder_tpu_torch.train import schedules
        from pointnet_autoencoder_tpu_torch.train.state import (
            TrainState, make_optimizer)

        cfg, traffic, dev = run.config, run.workload["params"], run.device
        self.batch = int(traffic["batch"])
        n = int(cfg["num_point"])
        self.variables = weights.initial(
            cfg, clouds.generator(run.seed, STREAM_WEIGHTS, dev), dev,
            shapes=_reference().leaf_shapes(cfg))
        pool = clouds.make_clouds(
            int(traffic["pool_batches"]) * self.batch, n, traffic["clouds"],
            clouds.generator(run.seed, STREAM_POOL, dev), dev)
        self.pool = list(pool.reshape(-1, self.batch, n, 3).unbind(0))
        model = Net(cfg).to(dev, getattr(torch, cfg["compute_dtype"]))
        model.load_state_dict(self.variables)
        opt = cfg["optimizer"]
        self.state = TrainState(
            model, make_optimizer("adam", model.parameters()),
            schedules.learning_rate_schedule(
                opt["learning_rate"], 1.0, self.batch, cfg["decay_step"]))
        self.bn = schedules.bn_momentum_schedule(self.batch,
                                                 cfg["decay_step"])
        self.first = self.pool[:3]
        losses = [float(self.step(b)["loss"]) for b in self.first]
        self.readings = {"losses": losses, "change": compare.norms(
            {k: v.float() - self.variables[k]
             for k, v in model.state_dict().items()})}
        self.taken = 3

    def step(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.state.train_step(batch, loss_fn, self.bn)


def reference_readings(config: Dict, variables: Dict[str, torch.Tensor],
                       batches: List[torch.Tensor],
                       precision: str = "f32") -> Dict:
    ref = _reference().Reference(config, variables, precision)
    losses = [ref.train_step(b) for b in batches]
    return {"losses": losses, "change": compare.norms(
        {k: v - variables[k].float() for k, v in ref.params.items()})}


def compared(side: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """``loss_gap``: the largest relative gap of the three steps' losses;
    ``change_gap``: each variable's change over the three steps, the gap
    of norms over the larger of the reference's norm of that leaf and of
    the median leaf, worst leaf."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(side["losses"],
                                                ref["losses"])]
    median = statistics.median(ref["change"].values())
    change = {k: abs(side["change"][k] - v) / max(v, median)
              for k, v in ref["change"].items()}
    worst = max(change, key=change.get)
    step = max(range(len(gaps)), key=gaps.__getitem__)
    return {"loss_gap": (gaps[step], f"step {step + 1}"),
            "change_gap": (change[worst], worst)}


def small(workload: Dict, config: Dict) -> Tuple[Dict, Dict]:
    """The CPU tests' preset: 32 points, 4 shapes a batch."""
    config["num_point"] = 32
    workload["params"].update(batch=4, pool_batches=4)
    return workload, config


def calibration(run: Run, control: bool) -> List[dict]:
    """Sides: ``program``; with ``control`` also ``control`` (the
    reference in fp8 in the program's place), ``half_batch`` (each step
    on half of its batch) and ``unchanged`` (the state left as it was)."""
    prog = Program(run)
    first, variables = prog.first, prog.variables

    def reference(batches, precision="f32"):
        return reference_readings(run.config, variables, batches, precision)

    ref = reference(first)
    out = [("program", compared(prog.readings, ref))]
    if control:
        sides = {"control": reference(first, "fp8"),
                 "half_batch": reference([b[:b.shape[0] // 2]
                                          for b in first]),
                 "unchanged": dict(ref, change={k: 0.0
                                                for k in ref["change"]})}
        out += [(name, compared(r, ref)) for name, r in sides.items()]
    return [{"side": s, "readings": {k: v for k, (v, _) in r.items()},
             "worst": {k: w for k, (_, w) in r.items()}} for s, r in out]


def run(run: Run) -> Outcome:
    if run.trace:
        raise harness.Refused("the stand-in's driver takes no trace")
    fetch_every = int(run.workload["params"]["fetch_every"])
    prog = Program(run)
    synchronize(run.device)
    setup_s = time.perf_counter() - run.t0
    steps, bad, pending = 0, 0, []
    t_start = time.perf_counter()
    while True:
        pending.append(prog.step(prog.pool[prog.taken % len(prog.pool)]))
        prog.taken += 1
        steps += 1
        if len(pending) == fetch_every:
            losses = torch.stack([m["loss"].float() for m in pending]).cpu()
            bad += int((~torch.isfinite(losses)).sum())
            pending = []
            now = time.perf_counter()
            if now - t_start >= run.seconds:
                break
    window = now - t_start
    peak = memory_peak(run.device)
    ref = reference_readings(run.config, prog.variables, prog.first)
    found = compared(prog.readings, ref)
    limits = run.workload["limits"]
    return Outcome(attempted=steps + 3, failed=bad,
                   end_to_end={"train_shapes_per_s":
                               steps * prog.batch / window,
                               "setup_s": setup_s},
                   checks={k: (found[k][0], float(limits[k]))
                           for k in limits},
                   memory_peak_bytes=peak)
