"""The program's phase clocks (``train/state.StepPrograms``) on the card,
at the size of ``train.model.b32``: what a profiler trace of the same
replay shows. Run with ``python3 -m pytest benchmark/tests`` on a machine
with a card."""

import time

import pytest

from benchmark import harness


@pytest.mark.card
def test_phase_clocks_sum_to_the_replay_on_the_card(card):
    """The library step of ``train.model.b32`` after its three set-up
    steps, its programs released so that the next call captures again
    inside one profiler session, with the clocks: replay A, wait, then
    the next call, which samples A's phases first. Each phase is above 0
    and the four sum to within 10% of A's device span in the trace (its
    first to its last device event after its graph launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.tests import small
    from pointnet_autoencoder_tpu_torch.utils import profiling

    cell = "train.model.b32"
    workload, config = small.files(cell)
    run = harness.Run(cell, 2 ** 31 + 211, 0.0, False, workload, config,
                      card, time.perf_counter(), {}, lambda msg: None)
    train_loop = harness.load_module(harness.ROOT / "drivers"
                                     / "train_loop.py")
    prog = train_loop.TrainProgram(run)
    try:
        prog.step.programs.clear()
        torch.cuda.synchronize(card)
        replayed = prog.state.step
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prog.step(prog.pool[3])
            torch.cuda.synchronize(card)
            prog.step(prog.pool[4])
            torch.cuda.synchronize(card)
        steps = prog.step.step_programs
        sample = next(s for s in steps.phases if s.step == replayed)
        phases = [getattr(sample, f"{p}_ms")
                  for p in profiling.PHASES_OF_A_STEP]
        assert all(ms > 0 for ms in phases), sample
        host = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name in ("step",
                                                              "step.launch"):
                host.setdefault(e.name, []).append(e.time_range.start)
        launch, after = sorted(host["step.launch"])[0], \
            sorted(host["step"])[1]
        device = [e.time_range for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and launch <= e.time_range.start < after]
        span_ms = (max(r.end for r in device)
                   - min(r.start for r in device)) / 1e3
        assert abs(sum(phases) - span_ms) <= 0.1 * span_ms, (phases,
                                                              span_ms)
    finally:
        prog.release()
