"""Op micro-benchmarks, the port's twin of
``pointnet_autoencoder_tpu/ops/benchmarks.py``: the reference's Chamfer
self-benchmark (tf_nndistance.py:40-66: gradient descent on random
32x16384x3 clouds against 32x1024x3, time per step) and an EMD
equivalent, each step one captured program on the card
(``utils/graphs.py``), replayed back to back.

    python -m pointnet_autoencoder_tpu_torch.ops.benchmarks [--quick]
        [--device cuda|cpu]

The clouds are made from numpy seeds (0 for the moving cloud, 1 for the
target). As in the JAX module the first step runs before the clock
starts (there the compile, here the warm-up before capture); the clock
covers ``steps`` more steps and ends when the last loss reaches the host,
and the final loss is that step's. ``--device cpu`` runs the same loop
eagerly on the kernels' plain versions (no times worth reading). The
first line printed names the card and its power limit. ``compiled=False``
runs the card's loop eagerly, the reference a captured loop is held to.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.ops import chamfer, emd
from pointnet_autoencoder_tpu_torch.utils.graphs import ProgramCache


def _gd(loss_fn: Callable, p0: np.ndarray, target: np.ndarray, steps: int,
        lr: float, device: torch.device, compiled: bool = True) -> tuple:
    """Gradient descent on ``loss_fn(p, target)`` wrt p from ``p0``: one
    step, then ``steps`` timed steps, replays of a captured step on a card
    unless ``compiled`` is False. Returns (ms per step, final loss)."""
    p = torch.from_numpy(p0).to(device)
    tgt = torch.from_numpy(target).to(device)

    def step():
        q = p.detach().requires_grad_(True)
        loss = loss_fn(q, tgt)
        grad, = torch.autograd.grad(loss, q)
        p.sub_(lr * grad)
        return loss.detach()

    if device.type != "cuda" or not compiled:
        float(step())
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        final = float(loss)
        return (time.perf_counter() - t0) / steps * 1e3, final
    programs = ProgramCache(device)
    try:
        float(programs.warm_up(step))
        prog = programs.program("gd", step)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = prog.replay()
        final = float(loss)
        return (time.perf_counter() - t0) / steps * 1e3, final
    finally:
        programs.close()


def bench_chamfer_gd(b=32, n=16384, m=1024, steps=100, lr=0.05,
                     device="cuda", compiled=True) -> dict:
    """GD on sum(dist1)+sum(dist2) wrt the first cloud (the reference's
    exact objective, tf_nndistance.py:55-57), through K1 and K2 on a
    card."""
    xyz1 = np.random.RandomState(0).randn(b, n, 3).astype(np.float32)
    xyz2 = np.random.RandomState(1).randn(b, m, 3).astype(np.float32)

    def loss(q, tgt):
        d1, _, d2, _ = chamfer.nn_distance(q, tgt)
        return d1.sum() + d2.sum()

    ms, final = _gd(loss, xyz1, xyz2, steps, lr, resolve_device(device),
                    compiled)
    return {"ms_per_step": ms, "final_loss": final,
            "config": f"chamfer GD b{b} n{n} m{m}"}


def bench_emd_gd(b=8, n=1024, m=1024, steps=20, lr=0.01,
                 device="cuda", compiled=True) -> dict:
    """GD on the summed approximate EMD cost wrt the first cloud, through
    K6 on a card."""
    xyz2 = np.random.RandomState(1).rand(b, m, 3).astype(np.float32)
    xyz1 = np.random.RandomState(0).rand(b, n, 3).astype(np.float32)
    ms, final = _gd(lambda q, tgt: emd.emd_cost(q, tgt).sum(), xyz1, xyz2,
                    steps, lr, resolve_device(device), compiled)
    return {"ms_per_step": ms, "final_loss": final,
            "config": f"emd GD b{b} n{n} m{m}"}


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's name."""
    if device.type != "cuda":
        return "device: cpu (the kernels' plain versions; no card times)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True).stdout.strip()
    return f"device: {torch.cuda.get_device_name(device)} ({smi})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="smaller clouds / fewer steps")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(device_line(device))
    kw = dict(device=device)
    if args.quick:
        runs = [
            bench_chamfer_gd(b=4, n=2048, m=512, steps=20, **kw),
            bench_emd_gd(b=2, n=256, m=256, steps=5, **kw),
        ]
    else:
        runs = [
            bench_chamfer_gd(**kw),           # the reference harness workload
            bench_chamfer_gd(n=2048, m=2048, **kw),  # the training workload
            bench_emd_gd(**kw),
        ]
    for r in runs:
        print(f"{r['config']}: {r['ms_per_step']:.3f} ms/step, "
              f"final loss {r['final_loss']:.2f}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
