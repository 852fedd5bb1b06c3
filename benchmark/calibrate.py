"""The readings that a cell's limits are set from, on the card at the
cell's own sizes: the program's compared numbers over many seeds (the
lower readings), and the control's and each fault's over a few (the
upper readings). One JSON line per (seed, side).

    python3 -m benchmark.calibrate --workload <cell> \\
        --seeds 1,2,...,12 --control-seeds 1,2,3 [--out FILE]

Sides (the program's set-up and first three steps, as a run takes them:
step 1 eager, steps 2 and 3 replays of the captured step):

- ``program``: the timed path as a run drives it.
- ``control``: the reference with every matmul in fp8
  (``benchmark/reference/model.py``) put in the program's place: the
  precision below the configuration's bf16. ``control_replay``: the same
  in steps 2 and 3 only, the replayed steps.
- Faults, in the reference put in the program's place: ``half_batch``
  (each step on half of its batch, the mean over the rest) and
  ``half_batch_replay`` (steps 2 and 3 only); ``stale_input`` (step 3 on
  step 2's batch, as a replay that left its static input unrefreshed
  would take it); ``unchanged`` (a step that leaves the state as it was).

This is not part of a benchmark run: no timing is taken.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import torch

from benchmark import compare, harness


def _train(run, control: bool) -> List[dict]:
    driver = harness.load_module(harness.ROOT / "drivers" / "train_loop.py")
    prog = driver.TrainProgram(run)
    first, variables, side = prog.first, prog.variables, prog.readings
    resumed = prog.resumed
    prog.release()

    def reference(batches, precisions=("f32",) * 3):
        return driver.reference_readings(run.config, variables, batches,
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


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    workload, config = harness.cell_files(args.workload)
    device = harness.card_check(1)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            run = harness.Run(args.workload, seed, 0.0, False, workload,
                              config, device, t0, {},
                              lambda m: print(m, file=sys.stderr))
            lines = _train(run, seed in controls)
            for line in lines:
                line.update(cell=args.workload, seed=seed,
                            seconds=time.perf_counter() - t0)
                text = json.dumps(line)
                print(text, flush=True)
                if sink:
                    sink.write(text + "\n")
                    sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
