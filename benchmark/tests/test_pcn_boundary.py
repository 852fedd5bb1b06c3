"""PCN's captured step across its schedules' boundaries on the card, at
the size of ``train.pcn_emd.b32``: the learning rate's staircase at step
50,000 and alpha's last step at 50,001 (TF's ``piecewise_constant``:
``values[i]`` while ``step <= boundaries[i]``). A captured program reads
both from the device's step counter at every replay, so one capture
replays the right values on both sides of each boundary. Run with
``python3 -m pytest benchmark/tests`` on a machine with a card."""

import time

import pytest

from benchmark import harness


@pytest.mark.card
def test_captured_step_replays_across_the_boundaries_as_eager(card):
    """Two states from the same weights at step 49,998, one through
    ``make_step_fns(compiled=True)`` (step 49,998 eager, 49,999 captured,
    then replays), one eager throughout, on the same five pairs: each
    step's alpha and learning rate are the schedules' (0.5, 0.5, 0.5,
    1.0, 1.0 and 1e-4, 1e-4, 7e-5, 7e-5, 7e-5), and the losses, metrics
    and variables of the two are bit-equal."""
    import torch

    from benchmark.tests import small
    from pointnet_autoencoder_tpu_torch.csrc import build
    from pointnet_autoencoder_tpu_torch.models.autoencoder import PCNAutoencoder
    from pointnet_autoencoder_tpu_torch.train import schedules
    from pointnet_autoencoder_tpu_torch.train.loop import make_step_fns
    from pointnet_autoencoder_tpu_torch.train.state import (PairedBatch,
                                                            TrainState,
                                                            make_optimizer)

    cell = "train.pcn_emd.b32"
    workload, config = small.files(cell)
    run = harness.Run(cell, 2 ** 31 + 307, 0.0, False, workload, config,
                      card, time.perf_counter(), {}, lambda msg: None)
    driver = harness.load_module(harness.ROOT / "drivers" / "pcn_loop.py")
    build.build(build.SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variables = harness.load_module(harness.ROOT / "weights.py").initial(
        config, torch.Generator(card).manual_seed(11), card,
        shapes=harness.load_module(harness.ROOT / "reference"
                                   / "pcn_emd.py").leaf_shapes(config))
    pairs = [PairedBatch(x, y) for x, y in driver.make_pool(
        run, int(workload["params"]["batch"]))[:5]]
    opt = config["optimizer"]
    out = {}
    for compiled in (True, False):
        model = PCNAutoencoder(
            int(config["num_point"]), int(config["num_coarse"]),
            int(config["grid_size"]), float(config["grid_scale"]),
            dtype=torch.bfloat16, device=card)
        model.load_state_dict(variables)
        state = TrainState(
            model, make_optimizer("adam", model.parameters()),
            schedules.Staircase(opt["learning_rate"], opt["decay_rate"], 1,
                                opt["decay_steps"], floor=opt["lr_floor"]),
            step=49998)
        step, _ = make_step_fns(state, "pcn_emd",
                                schedules.bn_momentum_schedule(32, 50000),
                                compiled=compiled)
        metrics = [{k: v.clone() for k, v in step(p).items()} for p in pairs]
        torch.cuda.synchronize(card)
        if compiled:
            assert step.programs.replays == 4
            step.programs.close()
        out[compiled] = (metrics, {k: v.clone() for k, v in
                                   model.state_dict().items()}, state.step)
    (captured, cap_vars, cap_step), (eager, eager_vars, eager_step) = (
        out[True], out[False])
    assert cap_step == eager_step == 50003
    assert [float(m["alpha"]) for m in captured] == [0.5, 0.5, 0.5, 1.0, 1.0]
    assert [float(m["learning_rate"]) for m in captured] == pytest.approx(
        [1e-4, 1e-4, 7e-5, 7e-5, 7e-5], rel=1e-6)
    for a, b in zip(captured, eager):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (k, a[k], b[k])
    for k, v in cap_vars.items():
        assert torch.equal(v, eager_vars[k]), k
