#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (pointnet_autoencoder_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this script. Phases, one
line each; any failure exits non-zero before the final line:

1. card:    device name, power limit.
2. build:   nvcc builds every kernel of the serving path from csrc/.
3. kernels: each kernel against its plain PyTorch version on the card,
            at the serving shapes and at ragged shapes.
4. session: the serving path (``--model model``, full width, num_point
            2048, batch 32, random weights from a numpy seed written as a
            reference-named .npz) through ``InferenceSession(device="cuda")``,
            compared with the same session on the CPU.
5. server:  the port's ``PointServer``, built as ``cli.serve`` builds it,
            answering 4 concurrent clients; responses equal direct session
            calls and the stats show batching.
            Launch counters are zeroed before phase 4 and read after phase 5:
            every kernel of the path must have run there.
6. timings: CUDA-event medians of each kernel, its plain version and the
            library yardstick; the host time of one full reconstruct, and
            one torch.profiler trace of it (device busy time, idle share,
            device time by kernel).

The last two lines are the kernels JSON line (before it, the nvidia-smi
line), and then the device JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

NUM_POINT = 2048
BATCH = 32
SEED = 0
EPS = 1e-3
# Published peaks of one H100 SXM (dense): f32 outside the tensor cores,
# bf16 on the tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
ENCODER_WIDTHS = (3, 64, 64, 64, 128, 1024)
# Tolerances of kernel against plain version, same inputs, same card.
# f32: the kernel and cuBLAS sum the products in different orders.
# bf16: an order difference can flip one bf16 rounding of an activation,
# which the next layers carry (the reference's own bf16 tolerance).
TOL = {"f32": (1e-5, 1e-4), "bf16": (3e-2, 3e-2)}  # (rtol, atol)


class PhaseError(RuntimeError):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def close(a, b, rtol, atol):
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# Inputs from a numpy seed
# ---------------------------------------------------------------------------


def random_layers(rng, widths=ENCODER_WIDTHS):
    """Per layer (w (C,F), b, gamma, beta, mean, var): Glorot-scale weights
    and BN statistics with about a quarter of the gammas negative, so the
    min branch of the last layer's fold is exercised."""
    layers = []
    for c, f in zip(widths[:-1], widths[1:]):
        a = np.sqrt(6.0 / (c + f))
        gamma = rng.uniform(0.5, 1.5, f) * np.where(rng.rand(f) < 0.25, -1, 1)
        layers.append(tuple(np.asarray(x, np.float32) for x in (
            rng.uniform(-a, a, (c, f)), 0.1 * rng.randn(f), gamma,
            0.1 * rng.randn(f), 0.1 * rng.randn(f),
            rng.uniform(0.5, 1.5, f))))
    return layers


def write_reference_npz(path: str, rng) -> None:
    """Random weights for ``--model model`` under the reference's variable
    names, as the JAX package's ``cli.export --format reference_npz``
    writes them."""
    arrays = {}
    enc = random_layers(rng)
    for i, (w, b, gamma, beta, mean, var) in enumerate(enc):
        scope = f"conv{i + 1}"
        c, f = w.shape
        arrays[f"{scope}/weights"] = (w.reshape(1, c, 1, f) if i == 0
                                      else w.reshape(1, 1, c, f))
        arrays[f"{scope}/biases"] = b
        for name, v in (("gamma", gamma), ("beta", beta),
                        ("moving_mean", mean), ("moving_variance", var)):
            arrays[f"{scope}/bn/{name}"] = v
    for scope, c, f, bn in (("fc1", 1024, 1024, True),
                            ("fc2", 1024, 1024, True),
                            ("fc3", 1024, NUM_POINT * 3, False)):
        a = np.sqrt(6.0 / (c + f))
        arrays[f"{scope}/weights"] = rng.uniform(-a, a, (c, f)).astype(
            np.float32)
        arrays[f"{scope}/biases"] = (0.01 * rng.randn(f)).astype(np.float32)
        if bn:
            arrays[f"{scope}/bn/gamma"] = rng.uniform(0.5, 1.5, f).astype(
                np.float32)
            arrays[f"{scope}/bn/beta"] = (0.1 * rng.randn(f)).astype(
                np.float32)
            arrays[f"{scope}/bn/moving_mean"] = (0.1 * rng.randn(f)).astype(
                np.float32)
            arrays[f"{scope}/bn/moving_variance"] = rng.uniform(
                0.5, 1.5, f).astype(np.float32)
    np.savez(path, **arrays)


def clouds(rng, b, n):
    return (0.5 * rng.randn(b, n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_kernels(torch, fe, ch, rng) -> dict:
    dev = torch.device("cuda")
    errs = {}

    def encoder_case(b, n, dtype_name):
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        layers = [tuple(torch.from_numpy(x).to(dev) for x in layer)
                  for layer in random_layers(rng)]
        chain = fe.fold_layers(layers, eps=EPS, dtype=dtype)
        pts = torch.from_numpy(clouds(rng, b, n)).to(dev)
        kmax, kmin = fe.encoder_extrema_cuda(pts, chain)
        pmax, pmin = fe.encoder_extrema_plain(pts, chain)
        torch.cuda.synchronize()
        k = np.concatenate([kmax.cpu().numpy(), kmin.cpu().numpy()])
        p = np.concatenate([pmax.cpu().numpy(), pmin.cpu().numpy()])
        rtol, atol = TOL[dtype_name]
        err = max_err(k, p)
        require(np.all(np.isfinite(k)), f"fused encoder B={b} N={n} "
                f"{dtype_name}: non-finite output")
        require(close(k, p, rtol, atol),
                f"fused encoder B={b} N={n} {dtype_name}: max abs err "
                f"{err:.3e} over rtol {rtol} atol {atol}")
        say("kernels", f"fused_encoder B={b} N={n} {dtype_name}: max_abs_err "
            f"{err:.3e} (rtol {rtol}, atol {atol}) ok")
        return err

    errs["fused_encoder"] = encoder_case(BATCH, NUM_POINT, "f32")
    encoder_case(BATCH, NUM_POINT, "bf16")
    encoder_case(BATCH, NUM_POINT - 1, "f32")
    encoder_case(BATCH, 100, "f32")
    encoder_case(3, 37, "bf16")

    def chamfer_case(x1, x2, label):
        a = torch.from_numpy(x1).to(dev)
        b = torch.from_numpy(x2).to(dev)
        k = [t.cpu().numpy() for t in ch.nn_distance_cuda(a, b)]
        p = [t.cpu().numpy() for t in ch.nn_distance_plain(a, b)]
        err = max(max_err(k[0], p[0]), max_err(k[2], p[2]))
        require(close(k[0], p[0], 1e-6, 0.0) and close(k[2], p[2], 1e-6, 0.0),
                f"nn_distance {label}: distances off, max abs err {err:.3e}")
        require(np.array_equal(k[1], p[1]) and np.array_equal(k[3], p[3]),
                f"nn_distance {label}: indices differ at "
                f"{int((k[1] != p[1]).sum()) + int((k[3] != p[3]).sum())} "
                f"points")
        say("kernels", f"nn_distance {label}: max_abs_err {err:.3e} "
            f"(rtol 1e-6), indices equal ok")
        return err

    errs["nn_distance"] = chamfer_case(
        clouds(rng, BATCH, NUM_POINT), clouds(rng, BATCH, NUM_POINT),
        f"B={BATCH} N=M={NUM_POINT}")
    chamfer_case(clouds(rng, BATCH, NUM_POINT), clouds(rng, BATCH, 1000),
                 f"B={BATCH} N={NUM_POINT} M=1000")
    # Ties: every target point appears twice (lower index first), and the
    # queries include exact copies of targets (zero-distance ties).
    half = clouds(rng, 4, 500)
    x2 = np.concatenate([half, half], axis=1)
    x1 = np.concatenate([half[:, ::3], clouds(rng, 4, 300)], axis=1)
    chamfer_case(x1, x2, "ties B=4 N=467 M=1000")
    return errs


def phase_session(torch, InferenceSession, weights, rng):
    gpu = InferenceSession("model", weights, NUM_POINT, batch_size=BATCH,
                           device="cuda")
    cpu = InferenceSession("model", weights, NUM_POINT, batch_size=BATCH,
                           device="cpu")
    x = clouds(rng, 100, NUM_POINT)  # 4 batches, ragged tail of 4
    rec = gpu.reconstruct(x)
    emb = gpu.embed(x)
    dec = gpu.decode(emb)
    require(rec.shape == (100, NUM_POINT, 3) and emb.shape == (100, 1024),
            f"shapes {rec.shape} {emb.shape}")
    require(bool(np.all(np.isfinite(rec)) and np.all(np.isfinite(emb))),
            "non-finite outputs")
    require(close(dec, rec, 1e-6, 1e-6),
            f"decode(embed(x)) != reconstruct(x): {max_err(dec, rec):.3e}")
    rec_cpu, emb_cpu = cpu.reconstruct(x), cpu.embed(x)
    require(close(rec, rec_cpu, 1e-4, 1e-4),
            f"reconstruct vs CPU session: max abs err "
            f"{max_err(rec, rec_cpu):.3e}")
    require(close(emb, emb_cpu, 1e-4, 1e-4),
            f"embed vs CPU session: max abs err {max_err(emb, emb_cpu):.3e}")
    one = gpu.reconstruct(x[7])
    require(close(one, rec[7], 1e-6, 1e-6), "single-cloud reconstruct")
    target = x[:BATCH]
    noisy = (target + 0.01 * rng.randn(*target.shape)).astype(np.float32)
    cd, cd_cpu = gpu.chamfer(rec[:BATCH], target), cpu.chamfer(rec[:BATCH],
                                                               target)
    require(close(cd, cd_cpu, 1e-5, 0.0),
            f"chamfer vs CPU: {max_err(cd, cd_cpu):.3e}")
    fs, fs_cpu = gpu.fscore(target, noisy, 0.02), cpu.fscore(target, noisy,
                                                             0.02)
    require(close(fs, fs_cpu, 1e-6, 0.0) and 0.0 < fs.mean() < 1.0,
            f"fscore vs CPU: {fs[:4]} vs {fs_cpu[:4]}")
    dataset = [(c,) for c in x[:40]]
    mean_cd, per = gpu.evaluate(dataset)
    mean_cd_cpu, per_cpu = cpu.evaluate(dataset)
    require(per.shape == (40,) and close(per, per_cpu, 1e-4, 0.0),
            f"evaluate vs CPU: {max_err(per, per_cpu):.3e}")
    say("session", f"100 shapes: reconstruct/embed max abs err vs CPU "
        f"{max_err(rec, rec_cpu):.3e}/{max_err(emb, emb_cpu):.3e}; "
        f"chamfer {float(cd.mean()):.6f} (err {max_err(cd, cd_cpu):.1e}); "
        f"fscore@0.02 {float(fs.mean()):.4f}; evaluate mean "
        f"{mean_cd:.6f} vs CPU {mean_cd_cpu:.6f} ok")
    return gpu


def phase_server(weights, rng):
    from pointnet_autoencoder_tpu_torch.cli import serve as cli_serve
    from pointnet_autoencoder_tpu_torch.serve import PointClient

    args = cli_serve.build_parser().parse_args([
        "--model", "model", "--model_path", weights,
        "--num_point", str(NUM_POINT), "--batch_size", str(BATCH),
        "--host", "127.0.0.1", "--port", "0", "--max_delay_ms", "50"])
    session, server = cli_serve.build_server(args)
    server.start()
    inputs = [clouds(rng, 6, NUM_POINT) for _ in range(4)]
    results = [None] * 4
    errors = []
    barrier = threading.Barrier(4)

    def client(i):
        try:
            with PointClient("127.0.0.1", server.port, timeout=120) as c:
                barrier.wait(timeout=60)
                rec = c.reconstruct(inputs[i])
                emb = c.embed(inputs[i])
                dec = c.decode(emb)
                one = c.reconstruct(inputs[i][0])
                results[i] = (rec, emb, dec, one)
        except Exception as e:  # reported below; the phase fails
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        require(not any(t.is_alive() for t in threads), "client timed out")
        require(not errors, "; ".join(errors))
        with PointClient("127.0.0.1", server.port) as c:
            stats = c.stats()
    finally:
        server.stop()
    for i, (rec, emb, dec, one) in enumerate(results):
        want_rec = session.reconstruct(inputs[i])
        want_emb = session.embed(inputs[i])
        require(close(rec, want_rec, 1e-6, 1e-6), f"client {i} reconstruct")
        require(close(emb, want_emb, 1e-6, 1e-6), f"client {i} embed")
        require(close(dec, session.decode(want_emb), 1e-6, 1e-6),
                f"client {i} decode")
        require(close(one, want_rec[0], 1e-6, 1e-6),
                f"client {i} single reconstruct")
    require(stats["requests"] == 16, f"requests {stats['requests']}")
    require(stats["batches"] < stats["requests"],
            f"no batching: {stats['batches']} batches for "
            f"{stats['requests']} requests")
    say("server", f"4 clients x 4 requests answered; batches "
        f"{stats['batches']}, mean occupancy "
        f"{stats['mean_batch_occupancy']:.2f} shapes, mean batch "
        f"{stats['mean_batch_ms']} ms ok")


def cuda_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median CUDA-event time of one call, after warmup."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timings(torch, fe, ch, session, rng, launches, errs) -> list:
    dev = torch.device("cuda")
    pts = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    chain = session.model.encoder.fold()
    rows = []

    # K5: operations 2*B*N*sum(C*F); bytes: points, weights and folded rows
    # read once, the (B, 1024) max and min written once.
    macs = sum(c * f for c, f in zip(ENCODER_WIDTHS[:-1], ENCODER_WIDTHS[1:]))
    flops = 2.0 * BATCH * NUM_POINT * macs
    nbytes = (pts.numel() * 4 + sum(w.numel() * w.element_size()
                                    for w in chain.weights)
              + chain.affine.numel() * 4 + 2 * BATCH * 1024 * 4)
    k_ms = cuda_ms(torch, lambda: fe.encoder_extrema_cuda(pts, chain))
    p_ms = cuda_ms(torch, lambda: fe.encoder_extrema_plain(pts, chain))
    rows.append(dict(
        name="fused_encoder_eval", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/fused_encoder.cu",
        replaces="pointnet_autoencoder_tpu/ops/fused_encoder.py:61",
        launches=launches["fused_encoder_eval"],
        max_abs_err=errs["fused_encoder"], ms=k_ms, plain_ms=p_ms,
        **bound(flops, nbytes), library_ms=None))
    bf16_chain = fe.fold_layers(
        [tuple(torch.from_numpy(x).to(dev) for x in layer)
         for layer in random_layers(rng)], eps=EPS, dtype=torch.bfloat16)
    kb_ms = cuda_ms(torch, lambda: fe.encoder_extrema_cuda(pts, bf16_chain))
    say("timings", f"fused_encoder_eval bf16 B={BATCH} N={NUM_POINT}: "
        f"{kb_ms:.4f} ms on CUDA cores; bf16 tensor-core bound "
        f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms")

    # K1, both directions: the function needs each pair's d2 once (3 sub,
    # 3 mul, 2 add) and one compare per direction, 10 f32 operations per
    # pair; bytes: both clouds read once, (dist, idx) of every point
    # written once.
    x1 = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    x2 = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    flops = 10.0 * BATCH * NUM_POINT * NUM_POINT
    nbytes = 2 * BATCH * NUM_POINT * 3 * 4 + 2 * BATCH * NUM_POINT * 8
    k_ms = cuda_ms(torch, lambda: ch.nn_distance_cuda(x1, x2))
    p_ms = cuda_ms(torch, lambda: ch.nn_distance_plain(x1, x2))

    def cdist_min():
        d = torch.cdist(x1, x2)
        return d.min(dim=2), d.min(dim=1)

    l_ms = cuda_ms(torch, cdist_min)
    rows.append(dict(
        name="nn_distance", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/chamfer.cu",
        replaces="pointnet_autoencoder_tpu/ops/chamfer.py:92",
        launches=launches["nn_distance"], max_abs_err=errs["nn_distance"],
        ms=k_ms, plain_ms=p_ms, **bound(flops, nbytes), library_ms=l_ms))

    # One served batch: host time of reconstruct, then one torch.profiler
    # trace of the same call.
    batch = clouds(rng, BATCH, NUM_POINT)
    session.reconstruct(batch)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        session.reconstruct(batch)
        host.append(1e3 * (time.perf_counter() - t0))
    host_ms = statistics.median(host)
    trace = reconstruct_trace(torch, session, batch)
    for r in rows:
        say("timings", f"{r['name']} B={BATCH} N={NUM_POINT}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms")
    say("timings", f"reconstruct of one batch of {BATCH} (host clock, "
        f"copies included): median {host_ms:.3f} ms")
    say("timings", f"reconstruct traced: {trace}")
    return rows


def reconstruct_trace(torch, session, batch) -> str:
    """One torch.profiler trace of ``session.reconstruct(batch)``: the
    call's span on the host clock, the union of device intervals (kernels
    and copies) inside it, the idle share 1 - busy/span, and device time
    by name. Reports "not measured" when the trace holds no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    label = "chip_smoke.reconstruct"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):  # the last call is read
            with record_function(label):
                session.reconstruct(batch)
    events = prof.events()
    spans = [e.time_range for e in events
             if e.name == label and e.device_type == DeviceType.CPU]
    require(len(spans) == 3, f"trace holds {len(spans)} calls, not 3")
    t0, t1 = spans[-1].start, spans[-1].end
    dev = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1),
                  e.name) for e in events
                 if e.device_type == DeviceType.CUDA and e.name != label
                 and e.time_range.end > t0 and e.time_range.start < t1)
    if not dev:
        return (f"span {(t1 - t0) / 1e3:.3f} ms; device time and idle "
                f"share not measured (no device events in the trace)")
    busy, end, by_name = 0.0, t0, {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (f"span {(t1 - t0) / 1e3:.4f} ms, device busy {busy / 1e3:.4f} "
            f"ms, idle share {1.0 - busy / (t1 - t0):.4f}; device ms by "
            f"name: " + "; ".join(f"{n[:48]} {v / 1e3:.4f}" for n, v in top))


def bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from pointnet_autoencoder_tpu_torch.csrc import build
        from pointnet_autoencoder_tpu_torch.inference import InferenceSession
        from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
        from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    except ImportError as e:
        print(f"chip_smoke: the port package is not next to this script: "
              f"{e}", file=sys.stderr)
        return 2

    phase = "card"
    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        say(phase, f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
            f"CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False

        phase = "build"
        t0 = time.perf_counter()
        logs = build.build()
        build_s = time.perf_counter() - t0
        for src, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {src}: {line.strip()}", file=sys.stderr)
        say(phase, f"built {', '.join(logs) or 'nothing (cached)'} in "
            f"{build_s:.1f} s")

        rng = np.random.RandomState(SEED)
        phase = "kernels"
        errs = phase_kernels(torch, fe, ch, rng)

        with tempfile.TemporaryDirectory() as tmp:
            weights = os.path.join(tmp, "model_2048.npz")
            write_reference_npz(weights, rng)
            fe.encoder_extrema_cuda.launches = 0
            ch.nn_distance_cuda.launches = 0
            phase = "session"
            session = phase_session(torch, InferenceSession, weights, rng)
            phase = "server"
            phase_server(weights, rng)
            launches = {"fused_encoder_eval": fe.encoder_extrema_cuda.launches,
                        "nn_distance": ch.nn_distance_cuda.launches}
            require(all(n > 0 for n in launches.values()),
                    f"a kernel of the serving path never launched: "
                    f"{launches}")
            say(phase, f"main-path launches {launches}")

            phase = "timings"
            rows = phase_timings(torch, fe, ch, session, rng, launches, errs)
        smi = nvidia_smi_line()
    except Exception as e:  # any phase failing fails the run
        print(f"chip_smoke: FAIL in phase {phase}: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
