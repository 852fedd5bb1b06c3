"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It sets up the cell (loads or builds the kernels, makes the weights and
the inputs from the seed on the card, warms up and captures the cell's
own shapes), measures for ``--seconds``, checks what the timed path
produced against the plain reference (``benchmark/reference``), and
prints as its last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a checked trace of a
bounded stretch of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the same numbers end standard error. It prints no result and exits
non-zero without a CUDA card, when a traced stretch keeps losing events,
or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

# Every cache of compiled kernels at one fixed place inside the checkout,
# so that only a cell's first run there compiles: torch's runtime-compiled
# elementwise kernels, Triton's, and torch's extension builds, should the
# program come to use them. The port's own CUDA sources build into its
# csrc/_build/, keyed by a hash of the sources.
CACHE = Path(__file__).resolve().parent.parent / ".benchmark_cache"
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def cache_byte_code() -> None:
    """Compiled Python byte code at one fixed place inside the checkout,
    written by a cell's first run there and read by the later ones, also
    where the environment turns the writing off (PYTHONDONTWRITEBYTECODE):
    without it every run compiles torch's modules from source, some 13 s
    of set-up that moves by seconds with the host's load."""
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, t0: float = T0) -> int:
    cache_byte_code()
    args = parse(argv)
    cell = args.workload

    def log(msg: str) -> None:
        print(f"[{cell} {time.perf_counter() - t0:8.2f}s] {msg}",
              file=sys.stderr, flush=True)

    from benchmark import harness, trace
    log("set-up: torch and the harness imported")
    try:
        spec = harness.benchmark_spec()
        workload, config = harness.cell_files(cell, spec)
        e2e, layer = harness.cell_metrics(cell, spec)
        modules = harness.readers(layer) if args.trace else {}
        device = harness.card_check(
            next(w["chips"] for w in spec["workloads"] if w["name"] == cell))
        log(f"set-up: card {device} ready; seed {args.seed}, "
            f"{args.seconds:g} s, trace {args.trace}")
        driver = harness.load_module(harness.ROOT / "drivers"
                                     / f"{workload['driver']}.py")
        run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                          workload, config, device, t0,
                          harness.declared_kernels(modules), log)
        outcome = driver.run(run)
        log(f"card {harness.card_line(device)}")
        metrics = harness.metric_values(outcome, e2e, layer, modules,
                                        run.trace)
        line, correct = harness.result_line(outcome, metrics, device,
                                            run.trace)
    except (harness.Refused, trace.TraceLost) as e:
        print(f"[{cell}] no result: {e}", file=sys.stderr, flush=True)
        return 2
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"[{cell}] no result: modules of JAX or of the JAX package "
              f"were loaded: {', '.join(loaded)}", file=sys.stderr,
              flush=True)
        return 3
    print(f"correct {correct}", file=sys.stderr)
    for k, (value, limit) in outcome.checks.items():
        print(f"check {k} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
