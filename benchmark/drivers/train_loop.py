"""Training traffic: a closed loop of the library train step
(``train/loop.make_step_fns(state, name, bn_schedule, compiled=True)``:
one captured CUDA graph a step after an eager first call), the step a
user who drives their own loop calls.

Set-up builds one train state from weights made from the seed, makes a
pool of ``pool_batches`` batches of clouds on the card, and takes the
first three steps through the same step function on three distinct
batches of the pool: the first eager, the second captured (and
replayed), the third replayed on a new batch. Their losses, the first
gradient (from Adam's first moment after one step), the change of
BatchNorm's moving statistics over step 1 (eager) and over step 3 (a
replay, the captured program as the window runs it) and the change of
every variable over the three are the program's readings. The window
then drives the same object from step 4, cycling the pool so that no
step sees the last one's clouds, dispatching ahead and fetching the step
metrics every ``fetch_every`` steps in one stacked copy, as the
Trainer's log window does. After the window the reference
(``benchmark/reference``) takes the same three steps from the same
weights on the same batches, and step 3 again from the program's state
after step 2, and the two are compared (``benchmark/compare.training``).

Workload parameters (``traffic``): ``batch``, ``pool_batches``,
``fetch_every``, ``clouds`` (``benchmark/clouds.py``); ``profile``:
``groups`` (fetch groups in the traced stretch) and ``tries``.

The driver's contract (``benchmark/README.md``): ``run``, ``calibration``
(the sides that ``benchmark/calibrate.py`` prints), ``small`` (the CPU
tests' preset) and ``TRAIN_STEP`` (it drives ``TrainState.train_step``,
which the fault tests plant into).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import clouds, compare, harness, trace, weights
from benchmark.harness import Outcome, Run, memory_peak, synchronize
from benchmark.reference.model import ReferenceModel

STREAM_WEIGHTS, STREAM_POOL = 0, 1
TRAIN_STEP = True


def fetch(pending: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The losses of the pending steps, in one stacked copy to the host."""
    return torch.stack([m["loss"].float() for m in pending]).cpu()


class TrainProgram:
    """The program's train step, set up from the seed and driven through
    its first three steps."""

    def __init__(self, run: Run, batch_size: int = 0):
        from pointnet_autoencoder_tpu_torch.csrc import build
        from pointnet_autoencoder_tpu_torch.models.registry import \
            get_model_spec
        from pointnet_autoencoder_tpu_torch.train import schedules
        from pointnet_autoencoder_tpu_torch.train.loop import make_step_fns
        from pointnet_autoencoder_tpu_torch.train.state import (
            TrainState, make_optimizer)

        cfg, traffic = run.config, run.workload["params"]
        dev = run.device
        self.batch = batch_size or int(traffic["batch"])
        n = int(cfg["num_point"])
        if dev.type == "cuda":
            build.build(build.SOURCES)
            # Full f32 products where the step has them (the head's
            # moments), as the configuration states.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        run.log("set-up: kernels built or loaded")
        self.variables = weights.initial(
            cfg, clouds.generator(run.seed, STREAM_WEIGHTS, dev), dev)
        pool = clouds.make_clouds(
            int(traffic["pool_batches"]) * self.batch, n, traffic["clouds"],
            clouds.generator(run.seed, STREAM_POOL, dev), dev)
        self.pool = list(pool.reshape(-1, self.batch, n, 3).unbind(0))
        run.log(f"set-up: weights and a pool of {len(self.pool)} batches "
                f"of {self.batch} made")
        opt = cfg["optimizer"]
        model = get_model_spec(cfg["model"]).make(
            n, dtype=getattr(torch, cfg["compute_dtype"]), device=dev)
        model.load_state_dict(self.variables)
        self.model = model
        lr = schedules.learning_rate_schedule(
            opt["learning_rate"], opt["decay_rate"], self.batch,
            cfg["decay_step"])
        bn = schedules.bn_momentum_schedule(self.batch, cfg["decay_step"])
        self.state = TrainState(model, make_optimizer("adam",
                                                      model.parameters()), lr)
        self.step, _ = make_step_fns(self.state, cfg["model"], bn,
                                     compiled=True)
        self.first = self.pool[:3]
        losses, moving = [], [bn_buffers(model.state_dict())]
        for i, batch in enumerate(self.first):
            losses.append(float(self.step(batch)["loss"]))
            run.log(f"set-up: step {i + 1} taken")
            moving.append(bn_buffers(model.state_dict()))
            slots = self.state.optimizer.state
            if i == 0:
                grad1_t = {k: slots[p]["exp_avg"].float()
                           / (1.0 - opt["beta1"])
                           for k, p in model.named_parameters()}
            if i == 1:
                # The state that step 3 starts from, on the host: the
                # reference takes step 3 again from it.
                self.resumed = {
                    "variables": {k: host(v)
                                  for k, v in model.state_dict().items()},
                    "slots": {k: (host(slots[p]["exp_avg"]),
                                  host(slots[p]["exp_avg_sq"]))
                              for k, p in model.named_parameters()}}
        change = compare.norms({k: v.float() - self.variables[k]
                                for k, v in model.state_dict().items()})
        self.readings = {"losses": losses, "grad1": compare.norms(grad1_t),
                         "grad1_t": grad1_t, "change": change,
                         "bn1": moving_change(moving[0], moving[1]),
                         "bn3": moving_change(moving[2], moving[3])}
        self.taken = 3
        synchronize(dev)
        run.log(f"set-up: three steps taken (eager, captured, replayed), "
                f"losses {losses}")

    def steps(self, k: int, fetch_every: int, spans: bool = False) -> int:
        """``k`` more steps, fetching every ``fetch_every``; returns the
        steps whose loss was not finite."""
        bad = 0
        pending = []
        for _ in range(k):
            batch = self.pool[self.taken % len(self.pool)]
            if spans:
                with torch.profiler.record_function("bench.step"):
                    pending.append(self.step(batch))
            else:
                pending.append(self.step(batch))
            self.taken += 1
            if len(pending) == fetch_every:
                if spans:
                    with torch.profiler.record_function("bench.fetch"):
                        losses = fetch(pending)
                else:
                    losses = fetch(pending)
                bad += int((~torch.isfinite(losses)).sum())
                pending = []
        return bad

    def release(self) -> None:
        programs = getattr(self.step, "programs", None)
        if programs is not None:
            programs.close()
        self.step = self.state = self.model = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def bn_buffers(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of BatchNorm's moving statistics, in f32."""
    return {k: v.detach().float().clone() for k, v in state.items()
            if k.endswith((".bn.mean", ".bn.var"))}


def moving_change(before: Dict[str, torch.Tensor],
                  after: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: after[k] - before[k] for k in after}


def host(t: torch.Tensor) -> torch.Tensor:
    """A copy in f32 on the host."""
    return t.detach().float().to("cpu", copy=True)


def reference_readings(config: Dict, variables: Dict[str, torch.Tensor],
                       batches: List[torch.Tensor], resumed: Dict,
                       precisions=("f32", "f32", "f32")) -> Dict:
    """The reference's readings of the same three steps from the same
    weights; ``precisions`` gives each step's (with "fp8", the
    control's). ``bn3``: the reference takes the third step again from
    ``resumed``, the program's state after its second step (variables and
    Adam's moments): by then the two sides' weights differ by the rounding
    of two steps, which Adam's first steps, sized by the gradient's sign,
    make as large as the third step's own arithmetic."""
    ref = ReferenceModel(config, variables, precisions[0])
    losses, grad1 = [], None
    moving = [bn_buffers(ref.buffers)]
    for batch, precision in zip(batches, precisions):
        ref.precision = precision
        out = ref.train_step(batch)
        losses.append(out["loss"])
        moving.append(bn_buffers(ref.buffers))
        if grad1 is None:
            grad1 = out["grads"]
    change = compare.norms({k: v - variables[k].float()
                            for k, v in ref.variables().items()})
    device = batches[2].device
    again = ReferenceModel(
        config, {k: v.to(device) for k, v in resumed["variables"].items()},
        precisions[2], slots=resumed["slots"], step=2)
    before = bn_buffers(again.buffers)
    again.train_step(batches[2])
    return {"losses": losses, "grad1": compare.norms(grad1),
            "grad1_t": grad1, "change": change,
            "bn1": moving_change(moving[0], moving[1]),
            "bn3": moving_change(before, bn_buffers(again.buffers))}


def checks(run: Run, side: Dict, ref: Dict) -> Dict:
    limits = run.workload["limits"]
    found = compare.training(side, ref)
    run.log("compared: " + ", ".join(f"{k} {v!r} (worst at {where})"
                                     for k, (v, where) in found.items()))
    return {k: (found[k][0], float(limits[k])) for k in limits}


def run(run: Run) -> Outcome:
    traffic, profile = run.workload["params"], run.workload["profile"]
    fetch_every = int(traffic["fetch_every"])
    prog = TrainProgram(run)
    dev = run.device
    if run.trace:
        # The profiler's first session initializes CUPTI: not in the window.
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            prog.steps(fetch_every, fetch_every)
    bad = prog.steps(fetch_every, fetch_every)   # the fetch path, warmed
    synchronize(dev)
    setup_s = time.perf_counter() - run.t0
    run.log(f"set-up done: {setup_s:.3f} s")

    steps, traced = 0, None
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    stretch_at = t_start + 0.25 * run.seconds
    marks = []
    while True:
        bad += prog.steps(fetch_every, fetch_every)
        steps += fetch_every
        now = time.perf_counter()
        marks.append(now)
        if run.trace and traced is None and now >= stretch_at:
            groups = int(profile["groups"])
            k = groups * fetch_every
            facts = {"config": run.config["model"], "batch": prog.batch,
                     "num_point": int(run.config["num_point"])}

            def stretch():
                nonlocal bad, steps
                bad += prog.steps(k, fetch_every, spans=True)
                steps += k

            traced = trace.take(stretch, k, groups, run.declared,
                                harness.launch_counts,
                                int(profile["tries"]), facts, run.log)
            # The network the stretch ran, for K4's rows after the window.
            stretched = {name: host(v)
                         for name, v in prog.model.state_dict().items()}
            now = time.perf_counter()
        if now >= deadline:
            break
    window = now - t_start
    groups = np.diff([t_start] + marks) * 1e3 / fetch_every
    run.log("ms a step by group of {}: min {:.4f}, median {:.4f}, max {:.4f}"
            .format(fetch_every, groups.min(), np.median(groups),
                    groups.max()))
    rate = steps * prog.batch / window
    peak = memory_peak(dev)
    run.log(f"window {window:.3f} s, {steps} steps, {rate:.1f} shapes/s, "
            f"memory peak {peak} B")

    first, variables, side = prog.first, prog.variables, prog.readings
    resumed = prog.resumed
    prog.release()
    if traced is not None:
        # K4's rows: the reference's argmax over each batch of the pool,
        # which the stretch cycles through, on the variables that the
        # program held at the stretch's end.
        ref = ReferenceModel(run.config, {k: v.to(dev) for k, v in
                                          stretched.items()})
        rows = [ref.head_argmax_rows(b) for b in prog.pool]
        traced.facts["head_rows"] = sum(rows) / len(rows)
        del ref, stretched
    ref = reference_readings(run.config, variables, first, resumed)
    return Outcome(attempted=steps + 3, failed=bad,
                   end_to_end={"train_shapes_per_s": rate,
                               "setup_s": setup_s},
                   checks=checks(run, side, ref), memory_peak_bytes=peak,
                   trace=traced)


def small(workload: Dict, config: Dict) -> Tuple[Dict, Dict]:
    """The CPU tests' preset: 64 points, 4 shapes a batch, a pool of 4
    batches; everything else as the files state, limits included."""
    config["num_point"] = 64
    workload["params"].update(batch=4, pool_batches=4)
    return workload, config


def calibration(run: Run, control: bool) -> List[dict]:
    """The readings of the program's set-up and first three steps, as a
    run takes them (step 1 eager, steps 2 and 3 replays of the captured
    step), each against the reference's; with ``control`` also the
    control's and each fault's. One dict a side: ``side``, ``readings``
    and ``worst`` (where each was worst).

    - ``program``: the timed path as a run drives it.
    - ``control``: the reference with every matmul in fp8
      (``benchmark/reference/model.py``) put in the program's place: the
      precision below the configuration's bf16. ``control_replay``: the
      same in steps 2 and 3 only, the replayed steps.
    - Faults, in the reference put in the program's place: ``half_batch``
      (each step on half of its batch, the mean over the rest) and
      ``half_batch_replay`` (steps 2 and 3 only); ``stale_input`` (step 3
      on step 2's batch, as a replay that left its static input
      unrefreshed would take it); ``unchanged`` (a step that leaves the
      state as it was).
    """
    prog = TrainProgram(run)
    first, variables, side = prog.first, prog.variables, prog.readings
    resumed = prog.resumed
    prog.release()

    def reference(batches, precisions=("f32",) * 3):
        return reference_readings(run.config, variables, batches,
                                  resumed, precisions)

    ref = reference(first)
    out = [("program", compare.training(side, ref))]
    if control:
        half = [b[:b.shape[0] // 2] for b in first]
        still = dict(ref, change={k: 0.0 for k in ref["change"]},
                     bn1={k: torch.zeros_like(v)
                          for k, v in ref["bn1"].items()},
                     bn3={k: torch.zeros_like(v)
                          for k, v in ref["bn3"].items()})
        sides = {"control": reference(first, ("fp8",) * 3),
                 "control_replay": reference(first, ("f32", "fp8", "fp8")),
                 "half_batch": reference(half),
                 "half_batch_replay": reference(first[:1] + half[1:]),
                 "stale_input": reference(first[:2] + first[1:2]),
                 "unchanged": still}
        out += [(name, compare.training(reading, ref))
                for name, reading in sides.items()]
    return [{"side": s, "readings": {k: v for k, (v, _) in r.items()},
             "worst": {k: w for k, (_, w) in r.items()}} for s, r in out]
