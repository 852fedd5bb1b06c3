"""Training traffic of PCN (``configs/pcn_emd.json``): a closed loop of the
library train step (``train/loop.make_step_fns(state, "pcn_emd", ...,
compiled=True)``: one captured CUDA graph a step after an eager first
call) on (input, target) pairs, checked against PCN's own plain reference
(``reference/pcn_emd.py``).

Set-up makes the weights (``benchmark/weights.py`` over the reference's
leaf shapes) and a pool of ``pool_batches`` batches of targets of
``num_gt_point`` points from the seed on the card, each target's points
in a seeded order, its input the first ``num_point`` of them. The step
counter starts at ``start_step``. The first three steps take three
distinct pairs of the pool through the same step function: the first
eager, the second captured (and replayed), the third replayed on a new
pair. Their losses, the first gradient (from Adam's first moment after
one step), the third (from Adam's moments before and after it) and the
change of every variable over the three are the program's readings. The
window then drives the same object from step 4, cycling the pool,
dispatching ahead and fetching the losses every ``fetch_every`` steps in
one stacked copy. After the window the reference takes the same three
steps from the same weights on the same pairs, and step 3 again from the
program's state after its step 2, and the two are compared
(``compared``).

Workload parameters (``params``): ``batch``, ``pool_batches``,
``fetch_every``, ``start_step``, ``clouds`` (``benchmark/clouds.py``);
``profile``: ``groups`` (fetch groups in the traced stretch) and
``tries``.

The driver's contract (``benchmark/README.md``): ``run``, ``calibration``,
``small`` and ``TRAIN_STEP``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import clouds, compare, harness, trace, weights
from benchmark.harness import Outcome, Run, memory_peak, synchronize

STREAM_WEIGHTS, STREAM_POOL, STREAM_ORDER = 0, 1, 2
TRAIN_STEP = True


def _reference():
    return harness.load_module(harness.ROOT / "reference" / "pcn_emd.py")


def fetch(pending: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The losses of the pending steps, in one stacked copy to the host."""
    return torch.stack([m["loss"].float() for m in pending]).cpu()


def host(t: torch.Tensor) -> torch.Tensor:
    """A copy in f32 on the host."""
    return t.detach().float().to("cpu", copy=True)


def make_pool(run: Run, batch: int) -> List[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """``pool_batches`` (input, target) pairs on the card: seeded targets of
    ``num_gt_point`` points, each in a seeded order, the input the first
    ``num_point`` points of its target."""
    cfg, traffic, dev = run.config, run.workload["params"], run.device
    count = int(traffic["pool_batches"]) * batch
    gt, n = int(cfg["num_gt_point"]), int(cfg["num_point"])
    targets = clouds.make_clouds(
        count, gt, traffic["clouds"],
        clouds.generator(run.seed, STREAM_POOL, dev), dev)
    order = torch.rand((count, gt), device=dev,
                       generator=clouds.generator(run.seed, STREAM_ORDER,
                                                  dev)).argsort(dim=1)
    targets = torch.gather(targets, 1, order[:, :, None].expand(-1, -1, 3))
    inputs = targets[:, :n].contiguous()
    return list(zip(inputs.reshape(-1, batch, n, 3).unbind(0),
                    targets.reshape(-1, batch, gt, 3).unbind(0)))


class PCNProgram:
    """The program's PCN train step, set up from the seed and driven
    through its first three steps."""

    def __init__(self, run: Run):
        from pointnet_autoencoder_tpu_torch.csrc import build
        from pointnet_autoencoder_tpu_torch.models.autoencoder import \
            PCNAutoencoder
        from pointnet_autoencoder_tpu_torch.train import schedules
        from pointnet_autoencoder_tpu_torch.train.loop import make_step_fns
        from pointnet_autoencoder_tpu_torch.train.state import (
            PairedBatch, TrainState, make_optimizer)

        cfg, traffic, dev = run.config, run.workload["params"], run.device
        self.batch = int(traffic["batch"])
        if dev.type == "cuda":
            build.build(build.SOURCES)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        run.log("set-up: kernels built or loaded")
        self.variables = weights.initial(
            cfg, clouds.generator(run.seed, STREAM_WEIGHTS, dev), dev,
            shapes=_reference().leaf_shapes(cfg))
        self.pool = [PairedBatch(x, y) for x, y in make_pool(run, self.batch)]
        run.log(f"set-up: weights and a pool of {len(self.pool)} pairs of "
                f"{self.batch} made")
        model = PCNAutoencoder(int(cfg["num_point"]),
                               int(cfg["num_coarse"]), int(cfg["grid_size"]),
                               float(cfg["grid_scale"]),
                               dtype=getattr(torch, cfg["compute_dtype"]),
                               device=dev)
        model.load_state_dict(self.variables)
        self.model = model
        opt = cfg["optimizer"]
        lr = schedules.Staircase(opt["learning_rate"], opt["decay_rate"], 1,
                                 opt["decay_steps"], floor=opt["lr_floor"])
        self.start = int(traffic["start_step"])
        self.state = TrainState(model, make_optimizer("adam",
                                                      model.parameters()),
                                lr, step=self.start)
        self.step, _ = make_step_fns(
            self.state, cfg["model"],
            schedules.bn_momentum_schedule(self.batch, opt["decay_steps"]),
            compiled=True)
        self.first = self.pool[:3]
        slots = self.state.optimizer.state
        b1 = opt["beta1"]
        losses, moments = [], []
        for i, pair in enumerate(self.first):
            losses.append(float(self.step(pair)["loss"]))
            run.log(f"set-up: step {i + 1} taken")
            moments.append({k: slots[p]["exp_avg"].float().clone()
                            for k, p in model.named_parameters()})
            if i == 1:
                # The state that step 3 starts from, on the host: the
                # reference takes step 3 again from it.
                self.resumed = {
                    "variables": {k: host(v)
                                  for k, v in model.state_dict().items()},
                    "slots": {k: (host(slots[p]["exp_avg"]),
                                  host(slots[p]["exp_avg_sq"]))
                              for k, p in model.named_parameters()}}
        grad1 = {k: m / (1.0 - b1) for k, m in moments[0].items()}
        grad3 = {k: (moments[2][k] - b1 * moments[1][k]) / (1.0 - b1)
                 for k in moments[2]}
        change = compare.norms({k: v.float() - self.variables[k]
                                for k, v in model.state_dict().items()})
        self.readings = {"losses": losses, "grad1": grad1, "grad3": grad3,
                         "change": change}
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
            pair = self.pool[self.taken % len(self.pool)]
            if spans:
                with torch.profiler.record_function("bench.step"):
                    pending.append(self.step(pair))
            else:
                pending.append(self.step(pair))
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


def reference_readings(config: Dict, variables: Dict[str, torch.Tensor],
                       pairs: List[Tuple[torch.Tensor, torch.Tensor]],
                       start: int, resumed: Dict,
                       precisions=("f32", "f32", "f32")) -> Dict:
    """The reference's readings of the same three steps from the same
    weights at the same step counter; ``precisions`` gives each step's
    (with "fp8", the control's). ``grad3`` and ``loss3``: the reference
    takes the third step again from ``resumed``, the program's state after
    its second step (variables and Adam's moments), on the third pair."""
    ref_module = _reference()
    ref = ref_module.PCNReference(config, variables, precisions[0],
                                  step=start)
    losses, grad1 = [], None
    for (inputs, target), precision in zip(pairs, precisions):
        ref.precision = precision
        out = ref.train_step(inputs, target)
        losses.append(out["loss"])
        if grad1 is None:
            grad1 = out["grads"]
    change = compare.norms({k: v - variables[k].float()
                            for k, v in ref.params.items()})
    device = pairs[2][0].device
    again = ref_module.PCNReference(
        config, {k: v.to(device) for k, v in resumed["variables"].items()},
        precisions[2], step=start + 2, slots=resumed["slots"], t=2)
    third = again.train_step(*pairs[2])
    return {"losses": losses, "grad1": grad1, "grad3": third["grads"],
            "loss3": third["loss"], "change": change}


def compared(side: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """Each number, with where it was worst (a step, or a leaf; for a
    median, the median leaf):

    - ``loss1_gap``: step 1's loss, its relative gap; ``loss_gap``: the
      largest over steps 1-3.
    - ``grad_diff`` (worst leaf) and ``grad_diff_median``: step 1's
      gradient as Adam got it, the norm of the difference over the larger
      of the reference's norm of that leaf and of the median leaf.
    - ``grad3_diff`` and ``grad3_diff_median``: the same of step 3's, the
      program's replayed step against the reference's step 3 from the
      program's state after step 2; ``loss3_gap``: that step's loss.
    - ``change_gap`` (worst leaf) and ``change_gap_median``: the change of
      every variable over the three steps, the gap of norms over the
      larger of the reference's norm of that leaf and of the median leaf.
    """
    gaps = [abs(a - b) / abs(b) for a, b in zip(side["losses"],
                                                ref["losses"])]
    step = max(range(len(gaps)), key=gaps.__getitem__)
    ref_grad = compare.norms(ref["grad1"])
    leaves = compare.counted_leaves(ref_grad)
    diff = compare._diffs(side["grad1"], ref["grad1"], leaves)
    diff3 = compare._diffs(side["grad3"], ref["grad3"], leaves)
    change = compare._gaps(side["change"], ref["change"], leaves)
    loss3 = abs(side["losses"][2] - ref["loss3"]) / abs(ref["loss3"])
    return {"loss1_gap": (gaps[0], "step 1"),
            "loss_gap": (gaps[step], f"step {step + 1}"),
            "grad_diff": compare._worst(diff),
            "grad_diff_median": compare._median(diff),
            "grad3_diff": compare._worst(diff3),
            "grad3_diff_median": compare._median(diff3),
            "loss3_gap": (loss3, "step 3"),
            "change_gap": compare._worst(change),
            "change_gap_median": compare._median(change)}


def checks(run: Run, side: Dict, ref: Dict) -> Dict:
    limits = run.workload["limits"]
    found = compared(side, ref)
    run.log("compared: " + ", ".join(f"{k} {v!r} (worst at {where})"
                                     for k, (v, where) in found.items()))
    return {k: (found[k][0], float(limits[k])) for k in limits}


def run(run: Run) -> Outcome:
    traffic, profile = run.workload["params"], run.workload["profile"]
    fetch_every = int(traffic["fetch_every"])
    prog = PCNProgram(run)
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
    cfg = run.config
    while True:
        bad += prog.steps(fetch_every, fetch_every)
        steps += fetch_every
        now = time.perf_counter()
        marks.append(now)
        if run.trace and traced is None and now >= stretch_at:
            groups = int(profile["groups"])
            k = groups * fetch_every
            facts = {"config": cfg["model"], "batch": prog.batch,
                     "num_point": int(cfg["num_point"]),
                     "num_gt_point": int(cfg["num_gt_point"]),
                     "num_coarse": int(cfg["num_coarse"]),
                     "grid_size": int(cfg["grid_size"])}

            def stretch():
                nonlocal bad, steps
                bad += prog.steps(k, fetch_every, spans=True)
                steps += k

            traced = trace.take(stretch, k, groups, run.declared,
                                harness.launch_counts,
                                int(profile["tries"]), facts, run.log)
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
    resumed, start = prog.resumed, prog.start
    prog.release()
    ref = reference_readings(cfg, variables, first, start, resumed)
    return Outcome(attempted=steps + 3, failed=bad,
                   end_to_end={"train_shapes_per_s": rate,
                               "setup_s": setup_s},
                   checks=checks(run, side, ref), memory_peak_bytes=peak,
                   trace=traced)


def small(workload: Dict, config: Dict) -> Tuple[Dict, Dict]:
    """The CPU tests' preset: 64 input points, targets of 256 (16 coarse
    points on the configuration's grid), 2 shapes a batch, a pool of 4
    batches; everything else as the files state, limits included."""
    grid = int(config["grid_size"]) ** 2
    config.update(num_point=64, num_coarse=16, num_gt_point=16 * grid)
    workload["params"].update(batch=2, pool_batches=4)
    return workload, config


def calibration(run: Run, control: bool) -> List[dict]:
    """The readings of the program's set-up and first three steps, as a
    run takes them (step 1 eager, steps 2 and 3 replays of the captured
    step), each against the reference's; with ``control`` also the
    control's and each fault's. One dict a side: ``side``, ``readings``
    and ``worst`` (where each was worst).

    - ``program``: the timed path as a run drives it.
    - ``control``: the reference with every matmul in fp8
      (``reference/pcn_emd.py``) put in the program's place: the precision
      below the configuration's bf16. ``control_replay``: the same in
      steps 2 and 3 only, the replayed steps.
    - Faults, in the reference put in the program's place: ``half_batch``
      (each step on half of its batch, the mean over the rest) and
      ``half_batch_replay`` (steps 2 and 3 only); ``stale_input`` (step 3
      on step 2's pair, as a replay that left its static inputs
      unrefreshed would take it); ``unchanged`` (a step that leaves the
      state as it was).
    """
    prog = PCNProgram(run)
    first, variables, side = prog.first, prog.variables, prog.readings
    resumed, start = prog.resumed, prog.start
    prog.release()

    def reference(pairs, precisions=("f32",) * 3):
        # Each side's step 3 is taken again from the program's state after
        # step 2, on that side's third pair.
        return reference_readings(run.config, variables, pairs, start,
                                  resumed, precisions)

    ref = reference(first)
    out = [("program", compared(side, ref))]
    if control:
        half = [tuple(t[:t.shape[0] // 2] for t in pair) for pair in first]
        zero = {k: torch.zeros_like(v) for k, v in ref["grad3"].items()}
        still = dict(ref, change={k: 0.0 for k in ref["change"]},
                     grad3=zero, loss3=ref["losses"][2])
        sides = {"control": reference(first, ("fp8",) * 3),
                 "control_replay": reference(first, ("f32", "fp8", "fp8")),
                 "half_batch": reference(half),
                 "half_batch_replay": reference(first[:1] + half[1:]),
                 "stale_input": reference(first[:2] + first[1:2]),
                 "unchanged": still}
        out += [(name, compared(reading, ref))
                for name, reading in sides.items()]
    return [{"side": s, "readings": {k: v for k, (v, _) in r.items()},
             "worst": {k: w for k, (_, w) in r.items()}} for s, r in out]

