"""The readings that a cell's limits are set from, on the card at the
cell's own sizes: the program's compared numbers over many seeds (the
lower readings), and the control's and each fault's over a few (the
upper readings). One JSON line per (seed, side).

    python3 -m benchmark.calibrate --workload <cell> \\
        --seeds 1,2,...,12 --control-seeds 1,2,3 [--out FILE]

The sides are the cell's own driver's (``drivers/<driver>.py``
``calibration``): the program's readings, and with ``--control-seeds``
the control's and each fault's, which its docstring lists.

This is not part of a benchmark run: no timing is taken.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import torch

from benchmark import harness


def driver(workload: dict):
    """The workload's own driver module."""
    return harness.load_module(harness.ROOT / "drivers"
                               / f"{workload['driver']}.py")


def sides(run, control: bool) -> List[dict]:
    """The lines of one seed: the sides of ``run``'s own driver."""
    return driver(run.workload).calibration(run, control)


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
            lines = sides(run, seed in controls)
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
