"""The traced run's reader on synthetic traces: every metric comes out
when a few events of a kernel are lost, the stretch is taken again when a
kernel is absent or an operation falls out of step, and after the last
try the run fails rather than print a line without a metric."""

import random

import pytest

from benchmark import harness, trace

CELL = "train.model.b32"
ROUNDS, GROUPS = 40, 4
# One step of the captured program: the head, the Chamfer kernels, and
# plain device operations; once a group of ten steps, a fetch.
STEP = ["void (anonymous namespace)::head_fwd_mma_kernel<64>(bf16 const*)",
        "void (anonymous namespace)::head_w_transpose_kernel<short>(x)",
        "void (anonymous namespace)::head_bwd_dx_kernel<__nv_bfloat16>(x)",
        "void (anonymous namespace)::head_bwd_dw_kernel<__nv_bfloat16>(x)",
        "(anonymous namespace)::nn_distance_kernel(float const*, int)",
        "(anonymous namespace)::nn_distance_cols_kernel(unsigned long long)",
        "void (anonymous namespace)::nn_distance_grad_kernel<false>(float)",
        "void at::native::vectorized_elementwise_kernel<4, add>(int)",
        "void at::native::reduce_kernel<128, 4>(float)"] + [
        f"void at::native::elementwise_kernel<{i}>(x)" for i in range(40)]
FETCH = ["Memcpy DtoH (Device -> Pageable)", "void at::native::stack<1>(x)"]
LAUNCHES = {"head_max_cuda": ROUNDS, "head_bwd_cuda": ROUNDS,
            "nn_distance_cuda": ROUNDS, "nn_distance_grad_cuda": ROUNDS}


def _events():
    out, t = [], 0.0
    for step in range(ROUNDS):
        for name in STEP:
            out.append(trace.Event(name, t, t + 5.0))
            t += 6.0
        if (step + 1) % (ROUNDS // GROUPS) == 0:
            for name in FETCH:
                out.append(trace.Event(name, t, t + 3.0))
                t += 50.0
    return out


def _declared():
    spec = harness.benchmark_spec()
    _, layer = harness.cell_metrics(CELL, spec)
    modules = harness.readers(layer)
    return layer, modules, harness.declared_kernels(modules)


def _take(attempts, tries=3):
    """``take`` over a fake recorder that hands out ``attempts`` in turn."""
    queue = list(attempts)
    counter = {"n": 0}

    def launches():
        return {k: v * counter["n"] for k, v in LAUNCHES.items()}

    def recorder(stretch):
        counter["n"] += 1
        events = queue.pop(0)
        span = trace.Event("bench.step", 0.0, 1e9)
        return events, [span], (events[-1].end_us + 100.0) / 1e6 if events \
            else 1.0

    _, _, declared = _declared()
    facts = {"config": "model", "batch": 32, "num_point": 2048,
             "head_rows": 20000.0}
    log = []
    got = trace.take(lambda: None, ROUNDS, GROUPS, declared, launches,
                     tries, facts, log.append, recorder=recorder)
    return got, log


def _metrics(got):
    layer, modules, _ = _declared()
    outcome = harness.Outcome(1, 0, {}, {}, 0, got)
    return harness.metric_values(outcome, [], layer, modules, True)


def test_kernel_ids():
    assert trace.kernel_id(STEP[2]) == "head_bwd_dx_kernel"
    assert trace.kernel_id(STEP[4]) == "nn_distance_kernel"
    assert trace.kernel_id("emd_init(float*, float*)") == "emd_init"
    assert trace.kernel_id(FETCH[0]) == FETCH[0]


def test_whole_trace_gives_every_metric():
    got, _ = _take([_events()])
    values = _metrics(got)
    assert set(values) == {m["name"] for m in _declared()[0]}
    assert got.tries == 1
    assert values["device_ops_per_step.train"]["value"] == pytest.approx(
        len(STEP) + len(FETCH) * GROUPS / ROUNDS)
    assert 0 < values["fused_head_roofline.train"]["value"]
    assert 0 < got.busy_s <= got.window_s


def test_a_few_lost_events_are_tolerated():
    events = _events()
    heads = [i for i, e in enumerate(events) if "head_fwd_mma" in e.name]
    drop = set(heads[:2])
    got, log = _take([[e for i, e in enumerate(events) if i not in drop]])
    assert got.tries == 1 and not any("taken again" in m for m in log)
    values = _metrics(got)
    assert set(values) == {m["name"] for m in _declared()[0]}
    # Per-call times come from the events found.
    whole, _ = _take([events])
    assert values["fused_head_roofline.train"]["value"] == pytest.approx(
        _metrics(whole)["fused_head_roofline.train"]["value"])


def test_absent_kernel_is_taken_again():
    events = _events()
    no_head = [e for e in events if "head_fwd_mma" not in e.name]
    got, log = _take([no_head, events])
    assert got.tries == 2
    assert "taken again" in log[0] and "head_fwd_mma_kernel" in log[0]
    assert "fused_head_roofline.train" in _metrics(got)


def test_random_loss_is_taken_again():
    events = _events()
    rng = random.Random(7)
    lossy = [e for e in events if rng.random() > 0.01]
    got, log = _take([lossy, lossy, events])
    assert got.tries == 3 and len(log) == 3


def test_every_try_lost_fails_the_run():
    events = _events()
    truncated = events[: len(events) // 3]
    with pytest.raises(trace.TraceLost, match="3 traces"):
        _take([truncated, [], truncated])
