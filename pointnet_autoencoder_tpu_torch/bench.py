"""Benchmark: the flagship train step's throughput, in
shapes/sec/chip, printed as a growing JSON artifact. The port's
counterpart of the root ``bench.py``, the JAX package's TPU benchmark.

    python -m pointnet_autoencoder_tpu_torch.bench               # the card
    python -m pointnet_autoencoder_tpu_torch.bench --device cpu  # the CPU

Workload: the reference's headline configuration, ``model`` (PointNet
encoder, FC decoder, Chamfer x100 loss) at batch 32 and 2048 points in
bf16, as the library's train step (``train.loop.make_step_fns(...,
compiled=True)``): forward, the Chamfer kernels, backward, Adam and the BN
update, one captured CUDA graph a step.

Artifact contract (the root ``bench.py``'s):

- stdout carries only complete JSON lines. The headline line prints as
  soon as the headline exists and again after each extra, so a consumer
  reads the last line; stage marks go to stderr.
- A wall-clock budget (``BENCH_BUDGET_S``, default 240 s) gates each
  extra; once it is spent the remaining extras are named in
  ``extras.skipped`` and the last line still prints.
- ``metric`` is ``train_throughput_model_b32_n{N}``, ``value`` B / step
  time / chips in ``shapes/sec/chip``; ``vs_baseline`` is the value over
  300 shapes/sec, the documented estimate of the reference's TF-1.4 GPU
  stack (BASELINE.md), and 0.0 unless N = 2048.

Extras, in order: ``model_step_ms`` and ``roofline.model``;
``model_emd``; ``serving`` (the bf16 eval forward at B=32);
``serving_b1`` with ``dispatch_overhead_ms``; ``families``;
``serving_b512``; then ``bench_wall_s`` and ``recorded_at``.
``extras.rows`` keeps, for every timed row, each window's ms a step
(``windows_ms``; the row's time is the best window), the steps or
forwards timed, the graph replays its ``ProgramCache`` counted in them
(one a step on a card; null on the CPU), and the kernel launches in them
beside those of one eager call (``launches``, ``eager_launches``, by
kernel wrapper).

Timing, on the card:

- A train row alternates two batches made with numpy from seeds 0 and 1
  and already on the card; three calls warm it (the first eager, the
  second captured), then each window of steps ends with a host fetch of
  the loss.
- A serving row replays the bf16 eval forward (the folded encoder's K5
  and the decoder) captured as one graph through
  ``utils/graphs.ProgramCache``, fed tensors on the card: what
  ``InferenceSession`` replays.
- The dispatch probe replays a captured graph of one scalar add,
  chained: the host's cost of one replay.
- Each roofline (``utils/roofline.roofline_report``) takes a
  ``StepCost`` of one eager step (one eager forward for serving) of the
  same configuration, run before the row's programs exist on a state of
  its own (a count is of an eager call, and the eager step would advance
  the timed state's optimizer), without the group's collectives: the
  state's second step, since the first also makes Adam's slots.

Hooks: ``BENCH_NUM_POINT`` (default 2048), ``BENCH_ITERS_SCALE`` (scales
every loop; default 1), ``BENCH_BUDGET_S``, and ``BENCH_SELF_PATH``: the
file that each artifact line is also written to. Without it no file is
written; the root ``BENCH_SELF.json`` is the JAX package's record.

Under a group (``parallel.mesh.initialize_distributed_if_requested``:
torchrun, SLURM's srun or Open MPI's mpirun; one process a card) each rank
times its B/k rows of the global batch of 32 through the grouped step (BN
and the gradients over the group), the chip count is the world size,
rank 0 alone prints and writes, and the one-chip rows ``serving_b1`` and
``serving_b512`` do not run. The ranks agree on every budget decision.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.parallel import mesh
from pointnet_autoencoder_tpu_torch.train import schedules
from pointnet_autoencoder_tpu_torch.train.loop import make_step_fns
from pointnet_autoencoder_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
)
from pointnet_autoencoder_tpu_torch.utils import graphs, roofline

BASELINE_SHAPES_PER_SEC = 300.0  # estimated reference GPU throughput
BATCH = 32


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pointnet_autoencoder_tpu_torch.bench",
        description="The flagship train step's throughput (shapes/sec/"
                    "chip) and its extras, as JSON lines on stdout.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu, "
                        "which runs the kernels' plain versions")
    return p


def _launches() -> Dict[str, int]:
    return {fn.__name__: n for fn, n in zip(graphs.COUNTED,
                                            graphs.launch_counts())}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in _launches().items()}


class Bench:
    """One run of the benchmark on ``device``, as this process's rank of the
    default process group if there is one."""

    def __init__(self, device: torch.device, t_start: float):
        self.device = device
        self.t_start = t_start
        self.budget_s = float(os.environ.get("BENCH_BUDGET_S", "240"))
        self.num_point = int(os.environ.get("BENCH_NUM_POINT", "2048"))
        self.scale = float(os.environ.get("BENCH_ITERS_SCALE", "1"))
        self.self_path = os.environ.get("BENCH_SELF_PATH")
        self.group = mesh.DataGroup.current(device)
        self.chips = 1 if self.group is None else self.group.world_size
        self.rank = 0 if self.group is None else self.group.rank
        mesh.check_batch_divisible(BATCH, self.chips)
        per = BATCH // self.chips
        self.per_chip = per
        rows = slice(self.rank * per, (self.rank + 1) * per)
        self.lr = schedules.learning_rate_schedule(0.001, 0.7, BATCH, 200000)
        self.bn = schedules.bn_momentum_schedule(BATCH, 200000)
        # Two batches on the device, alternated so that no step sees the
        # last one's input; made with numpy, this rank's rows of each.
        self.batches = self._clouds(BATCH, (0, 1), rows)
        self.kind = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
        self.extras: Dict = {
            "device": {"kind": self.kind, "count": self.chips},
            "group": (None if self.group is None else {
                "backend": dist.get_backend(), "ranks": self.chips}),
            "rows": {}, "roofline": {}, "skipped": []}
        self.result: Dict = {}
        if self.group is not None:
            # The group's first collective, outside every capture.
            self.group.barrier()

    # -- helpers ------------------------------------------------------------

    def _clouds(self, batch: int, seeds, rows=slice(None)) -> List:
        return [torch.from_numpy(np.random.RandomState(s).randn(
            batch, self.num_point, 3).astype(np.float32)[rows]).to(
                self.device) for s in seeds]

    def it(self, n: int) -> int:
        return max(1, int(n * self.scale))

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def mark(self, msg: str) -> None:
        who = "" if self.group is None else f" rank {self.rank}"
        print(f"[bench{who} {self.elapsed():7.1f}s] {msg}", file=sys.stderr,
              flush=True)

    def out_of_time(self, need_s: float) -> bool:
        """Whether ``need_s`` more seconds overrun the budget, on any
        rank: every rank takes the same decision."""
        late = self.elapsed() + need_s >= self.budget_s
        return late if self.group is None else self.group.any(late)

    def emit(self) -> None:
        """Print the artifact line (rank 0), and write it to
        BENCH_SELF_PATH if that is set."""
        self.extras["bench_wall_s"] = self.elapsed()
        self.extras["recorded_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                   time.gmtime())
        if self.rank != 0:
            return
        line = json.dumps(self.result)
        print(line, flush=True)
        if self.self_path:
            with open(self.self_path, "w") as f:
                f.write(line + "\n")

    def _windows(self, call: Callable, data: List, iters: int,
                 windows: int, fetch: Callable) -> List[float]:
        """Each window's ms a call: ``iters`` chained calls alternating
        ``data``, ended by a host fetch of the last result."""
        out = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for i in range(iters):
                y = call(data[i % 2])
            fetch(y)
            out.append(1e3 * (time.perf_counter() - t0) / iters)
        return out

    def _row(self, name: str, windows_ms: List[float], calls: int,
             replays: Optional[int], launches: Dict[str, int],
             eager: Dict[str, int]) -> float:
        ms = min(windows_ms)
        self.extras["rows"][name] = {
            "ms": ms, "windows_ms": windows_ms, "calls": calls,
            "replays": replays,
            "path": ("captured: one graph replay a call" if replays
                     is not None else "eager (the CPU)"),
            "launches": launches, "eager_launches": eager}
        self.mark(f"{name}: {ms:.4f} ms best of {len(windows_ms)} windows, "
                  f"{calls} calls, {replays} replays")
        return ms

    # -- the rows -----------------------------------------------------------

    def _state(self, name: str) -> TrainState:
        """A bf16 train state of ``--model name`` from seed 0."""
        model = get_model_spec(name).make(
            self.num_point, dtype=torch.bfloat16,
            generator=torch.Generator().manual_seed(0)).to(self.device)
        return TrainState(model, make_optimizer("adam", model.parameters()),
                          self.lr)

    def time_step(self, name: str, iters: int, windows: int) -> float:
        """ms of the best window of ``make_step_fns``' train step of
        ``--model name`` on this rank's rows; its roofline into
        ``extras.roofline[name]``."""
        self.mark(f"{name}: one eager step counted (StepCost)")
        counted, _ = make_step_fns(self._state(name), name, self.bn,
                                   compiled=False)
        # The count is of the second step: the first also makes the
        # optimizer's slots, which no later step does.
        float(counted(self.batches[1])["loss"])
        before = _launches()
        with roofline.StepCost() as cost:
            float(counted(self.batches[0])["loss"])
        eager = _since(before)
        step, _ = make_step_fns(self._state(name), name, self.bn,
                                self.group, compiled=True)
        programs = getattr(step, "programs", None)
        self.mark(f"{name}: warm-up and capture")
        for i in range(3):
            metrics = step(self.batches[i % 2])
        float(metrics["loss"])
        self.mark(f"{name}: timing {windows}x{iters}")
        before = _launches()
        replays = None if programs is None else programs.replays
        windows_ms = self._windows(step, self.batches, iters, windows,
                                   lambda m: float(m["loss"]))
        if programs is not None:
            replays = programs.replays - replays
            programs.close()
        ms = self._row(name, windows_ms, iters * windows, replays,
                       _since(before), eager)
        self.extras["roofline"][name] = roofline.roofline_report(
            name, self.per_chip, self.num_point, ms, cost=cost,
            dtype="bf16")
        return ms

    def time_forward(self, row: str, data: List, iters: int,
                     windows: int) -> Dict:
        """ms of the best window of the bf16 eval forward of ``model`` on
        ``data`` (two batches of one shape), captured on a card; its
        roofline report (``serving=True``)."""
        model = get_model_spec("model").make(
            self.num_point, dtype=torch.bfloat16,
            generator=torch.Generator().manual_seed(0))
        model.to(self.device).eval().requires_grad_(False)
        # Parameters pre-cast as InferenceSession casts them; BN
        # statistics are buffers and stay f32.
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
        with torch.inference_mode():
            folded = model.encoder.fold()

            def forward(x):
                return model(x, folded=folded)[0]

            before = _launches()
            with roofline.StepCost() as cost:
                float(forward(data[0])[0, 0, 0])
            eager = _since(before)
            programs = None
            call = forward
            if self.device.type == "cuda":
                programs = graphs.ProgramCache(self.device)
                programs.warm_up(lambda: forward(data[0]))

                def call(x):
                    return programs.program("forward", forward,
                                            (x,)).replay(x)

            float(call(data[1])[0, 0, 0])
            before = _launches()
            replays = None if programs is None else programs.replays
            windows_ms = self._windows(call, data, iters, windows,
                                       lambda y: float(y[0, 0, 0]))
            if programs is not None:
                replays = programs.replays - replays
                programs.close()
        ms = self._row(row, windows_ms, iters * windows, replays,
                       _since(before), eager)
        return roofline.roofline_report(
            "model", data[0].shape[0], self.num_point, ms, cost=cost,
            dtype="bf16", serving=True)

    def dispatch_overhead_ms(self, iters: int, windows: int) -> float:
        """ms a call of a captured graph of one scalar add, replayed
        chained (each replay's input the last one's output): its device
        time is about 0, so this is the host's cost of one replay, the
        share of the B=1 row that is not the card's."""
        x = torch.zeros((), device=self.device)

        def add(y):
            return y + 1.0

        programs = None
        call = add
        if self.device.type == "cuda":
            programs = graphs.ProgramCache(self.device)
            programs.warm_up(lambda: add(x))
            call = programs.program("add", add, (x,)).replay
        float(call(x))
        replays = None if programs is None else programs.replays
        out = []
        for _ in range(windows):
            t0 = time.perf_counter()
            y = x
            for _ in range(iters):
                y = call(y)
            float(y)
            out.append(1e3 * (time.perf_counter() - t0) / iters)
        if programs is not None:
            replays = programs.replays - replays
            programs.close()
        return self._row("dispatch", out, iters * windows, replays, {}, {})

    # -- the artifact -------------------------------------------------------

    def run(self) -> None:
        n = self.num_point
        self.mark(f"setup done on {self.kind}, {self.chips} chip(s), "
                  f"{self.per_chip} rows a chip")
        step_ms = self.time_step("model", self.it(150), self.it(4))
        value = BATCH / (step_ms / 1e3) / self.chips
        self.extras["model_step_ms"] = step_ms
        self.result.update({
            # The label tracks the workload run: under BENCH_NUM_POINT it
            # does not claim the flagship N, and the N=2048 baseline
            # estimate does not apply (0.0 marks not comparable).
            "metric": f"train_throughput_model_b32_n{n}",
            "value": value,
            "unit": "shapes/sec/chip",
            "vs_baseline": (value / BASELINE_SHAPES_PER_SEC if n == 2048
                            else 0.0),
            "extras": self.extras})
        self.emit()

        def extra(name: str, need_s: float, fn: Callable[[], None]):
            if self.out_of_time(need_s):
                self.extras["skipped"].append(name)
                return
            fn()
            self.emit()

        extra("model_emd", 30.0, self.do_emd)
        extra("serving", 15.0, self.do_serving)
        extra("serving_b1", 10.0, self.do_b1)
        extra("families", 25.0, self.do_families)
        extra("serving_b512", 15.0, self.do_b512)
        self.emit()

    def do_emd(self) -> None:
        ms = self.time_step("model_emd", self.it(40), self.it(3))
        self.extras["model_emd_step_ms"] = ms
        self.extras["model_emd_shapes_per_sec_per_chip"] = \
            BATCH / (ms / 1e3) / self.chips

    def do_serving(self) -> None:
        report = self.time_forward("serving", self.batches, self.it(200),
                                   self.it(3))
        ms = report["measured_ms"]
        self.extras["serving_fwd_ms"] = ms
        self.extras["serving_shapes_per_sec_per_chip"] = \
            BATCH / (ms / 1e3) / self.chips
        self.extras["serving_roofline"] = report

    def do_b1(self) -> None:
        # B=1 is a latency, one chip's by definition.
        if self.chips != 1:
            return
        report = self.time_forward("serving_b1", self._clouds(1, (0, 1)),
                                   self.it(300), self.it(3))
        raw = report["measured_ms"]
        disp = self.dispatch_overhead_ms(self.it(300), self.it(3))
        self.extras["serving_b1_latency_ms"] = raw
        self.extras["serving_b1"] = {
            "raw_ms": raw, "dispatch_overhead_ms": disp,
            # Two windows of separate timings: clamped at 0.
            "dispatch_corrected_ms": max(0.0, raw - disp),
            "roofline": report}

    def do_families(self) -> None:
        """The other families' train steps. The deconv families emit
        exactly 2048 points (reference models/model_upconv.py:37), so they
        run only at the headline N. ``model_cpu`` runs too, which the root
        ``bench.py`` skips: on the TPU it is the same program as ``model``, but
        on the card it is another one, the dense Chamfer
        (``ops/chamfer.py``, a (B, N, M) matrix) in place of the K1 and K2
        kernels."""
        names = (("model_cpu", "model_upconv", "model_fc_upconv",
                  "model_hierachy") if self.num_point == 2048
                 else ("model_cpu", "model_hierachy"))
        fam = {}
        for name in names:
            if self.out_of_time(20.0):
                self.extras["skipped"].append(name)
                continue
            fam[name] = self.time_step(name, self.it(60), self.it(2))
        self.extras["family_step_ms"] = fam

    def do_b512(self) -> None:
        # The throughput batch, one chip's row like the latency one.
        if self.chips != 1:
            return
        report = self.time_forward("serving_b512", self._clouds(512, (10, 11)),
                                   self.it(60), self.it(3))
        ms = report["measured_ms"]
        self.extras["serving_b512"] = {
            "measured_ms": ms, "shapes_per_sec_per_chip": 512 / (ms / 1e3),
            "analytic_floor_ms": report["analytic_floor_ms"],
            "pct_of_roofline": report["pct_of_roofline"],
            "roofline": report}


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.perf_counter()
    device = resolve_device(args.device)
    already = dist.is_available() and dist.is_initialized()
    joined = (mesh.initialize_distributed_if_requested(device.type)
              and not already)
    if joined and device.type == "cuda":
        # The hook made this rank's card (LOCAL_RANK) the current one.
        device = resolve_device("cuda")
    if device.type == "cuda":
        # Full f32 products where a step has any, as the Trainer sets.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        Bench(device, t_start).run()
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
