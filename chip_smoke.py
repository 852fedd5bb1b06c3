#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (pointnet_autoencoder_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this script. Phases, one
line each; any failure exits non-zero before the final line:

1. card:    device name, power limit.
2. build:   nvcc builds every kernel source in csrc/, all at once.
3. kernels: each kernel against its plain PyTorch version on the card,
            at the main paths' shapes and at ragged shapes.
4. session: the serving path (``--model model``, full width, num_point
            2048, batch 32, random weights from a numpy seed written as a
            reference-named .npz) through ``InferenceSession(device="cuda")``,
            compared with the same session on the CPU.
5. server:  the port's ``PointServer``, built as ``cli.serve`` builds it,
            answering 4 concurrent clients; responses equal direct session
            calls and the stats show batching.
            Launch counters are zeroed before phase 4 and read after phase 5:
            every kernel of the serving path must have run there.
6. train:   the training path (``--model model --category Chair
            --num_point 2048 --batch_size 32 --no_rotation``, bf16 by
            default) built as ``cli.train`` builds it, on a fixture of 320
            train and 64 test Chair shapes, for 2 epochs: finite losses, a
            falling pcloss, a best checkpoint, a ``--resume`` that restarts
            at the stored epoch and step, and a session on the checkpoint.
            Launch counters are zeroed before it and read after it: every
            kernel of the training path (its eval epoch included) must have
            run. Then one f32 train step on the card against the same step
            on the CPU from the same weights and batch, with the card's
            argmin/argmax choices: loss, every gradient, BN statistics.
7. timings: CUDA-event medians of each kernel, its plain version and the
            library yardstick; the host time of one full reconstruct and of
            one train step, and one torch.profiler trace of each (device
            busy time, idle share, device time by kernel).

The last two lines are the kernels JSON line (before it, the nvidia-smi
line), and then the device JSON line.
"""

from __future__ import annotations

import contextlib
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
# Head forward (K3), f32 and bf16: bf16 values multiply exactly in f32,
# so both types differ from the plain version only by the f32 sum's
# order; an argmax is held only where the best and second-best values
# differ by more than this.
HEAD_FWD_TOL = (1e-5, 1e-5)
# Head backward (K4) given the same argmax: dw sums over b in order; dx's
# atomic adds land in a varying order, f32 rounding; in bf16 mode dx is
# that f32 sum rounded to bf16, so an order difference can move it by one
# bf16 step (2^-8 relative).
HEAD_BWD_TOL = {"f32": (1e-5, 1e-6), "bf16": (1e-2, 1e-6)}
# Chamfer gradient (K2): f32 atomic adds in a varying order.
CHAMFER_GRAD_TOL = (1e-5, 1e-6)
# One f32 train step, card against CPU with the same argmin/argmax
# choices: each leaf's relative gradient error norm. The two differ in
# every product's and reduction's summation order (cuBLAS against the
# CPU's BLAS, the kernels' atomics); the largest reading on an H100 was
# 4.3e-4 (fc1's BN gamma).
GRAD_REL_TOL = 1e-3
TRAIN_EPOCHS = 2


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


def head_inputs(torch, rng, b, n, dtype):
    """K3/K4 inputs as conv5 sees them in training: x is conv4's ReLU
    output, (B, N, 128); w (128, 1024) at Glorot scale; scale/shift the
    folded BN rows, about a fifth of the scales negative."""
    dev = torch.device("cuda")
    a = np.sqrt(6.0 / (128 + 1024))
    x = np.maximum(rng.randn(b, n, 128), 0.0)
    w = rng.uniform(-a, a, (128, 1024))
    scale = rng.uniform(0.5, 1.5, 1024) * np.where(rng.rand(1024) < 0.2,
                                                    -1, 1)
    shift = 0.1 * rng.randn(1024)
    t = [torch.from_numpy(np.asarray(v, np.float32)).to(dev)
         for v in (x, w, scale, shift)]
    return t[0].to(dtype), t[1].to(dtype), t[2], t[3]


def phase_kernels(torch, fe, ch, fh, rng) -> dict:
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

    def head_case(b, n, dtype_name):
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        x, w, scale, shift = head_inputs(torch, rng, b, n, dtype)
        kmax, karg = fh.head_max_cuda(x, w, scale, shift)
        pmax, parg = fh.head_max_plain(x, w, scale, shift)
        # The plain version's best and second-best value per channel.
        o = torch.clamp_min(torch.matmul(x.float(), w.float()) * scale
                            + shift, 0.0)
        top2 = o.topk(2, dim=1).values
        torch.cuda.synchronize()
        rtol, atol = HEAD_FWD_TOL
        k, p = kmax.cpu().numpy(), pmax.cpu().numpy()
        err = max_err(k, p)
        require(np.all(np.isfinite(k)) and close(k, p, rtol, atol),
                f"head forward B={b} N={n} {dtype_name}: max abs err "
                f"{err:.3e} over rtol {rtol} atol {atol}")
        v1, v2 = top2[:, 0].cpu().numpy(), top2[:, 1].cpu().numpy()
        clear = (v1 - v2) > atol + rtol * np.abs(v1)
        wrong = (karg.cpu().numpy() != parg.cpu().numpy()) & clear
        require(not wrong.any(), f"head forward B={b} N={n} {dtype_name}: "
                f"argmax differs at {int(wrong.sum())} clear maxima")
        # K4 given the plain version's argmax; gvals at the scale of a
        # training step's (loss x100 over B*F outputs).
        gvals = torch.from_numpy(
            (1e-3 * rng.randn(b, 1024)).astype(np.float32)).to(dev)
        kdx, kdw = fh.head_bwd_cuda(x, w, gvals, parg)
        pdx, pdw = fh.head_bwd_plain(x, w, gvals, parg)
        torch.cuda.synchronize()
        brtol, batol = HEAD_BWD_TOL[dtype_name]
        kdx, pdx = kdx.float().cpu().numpy(), pdx.float().cpu().numpy()
        kdw, pdw = kdw.cpu().numpy(), pdw.cpu().numpy()
        require(kdx.dtype == pdx.dtype and close(kdx, pdx, brtol, batol),
                f"head backward dx B={b} N={n} {dtype_name}: max abs err "
                f"{max_err(kdx, pdx):.3e}")
        require(close(kdw, pdw, *HEAD_BWD_TOL["f32"]),
                f"head backward dw B={b} N={n} {dtype_name}: max abs err "
                f"{max_err(kdw, pdw):.3e}")
        berr = max(max_err(kdx, pdx), max_err(kdw, pdw))
        say("kernels", f"fused_head B={b} N={n} {dtype_name}: forward "
            f"max_abs_err {err:.3e}, argmax equal at {int(clear.sum())} "
            f"clear maxima; backward max_abs_err {berr:.3e} (dx rtol "
            f"{brtol}) ok")
        return err, berr

    errs["head_f32"] = head_case(BATCH, NUM_POINT, "f32")
    errs["head_bf16"] = head_case(BATCH, NUM_POINT, "bf16")
    head_case(BATCH, NUM_POINT - 1, "f32")
    head_case(BATCH, 100, "bf16")
    head_case(3, 37, "f32")

    def chamfer_grad_case(x1, x2, label):
        a = torch.from_numpy(x1).to(dev)
        b = torch.from_numpy(x2).to(dev)
        _, i1, _, i2 = ch.nn_distance_cuda(a, b)
        g1 = torch.from_numpy(rng.randn(*x1.shape[:2]).astype(
            np.float32)).to(dev)
        g2 = torch.from_numpy(rng.randn(*x2.shape[:2]).astype(
            np.float32)).to(dev)
        k = [t.cpu().numpy() for t in ch.nn_distance_grad_cuda(
            a, b, i1, i2, g1, g2)]
        p = [t.cpu().numpy() for t in ch.nn_distance_grad_plain(
            a, b, i1, i2, g1, g2)]
        err = max(max_err(k[0], p[0]), max_err(k[1], p[1]))
        require(all(close(kk, pp, *CHAMFER_GRAD_TOL)
                    for kk, pp in zip(k, p)),
                f"nn_distance_grad {label}: max abs err {err:.3e}")
        say("kernels", f"nn_distance_grad {label}: max_abs_err {err:.3e} "
            f"(rtol {CHAMFER_GRAD_TOL[0]}, atol {CHAMFER_GRAD_TOL[1]}) ok")
        return err

    errs["nn_distance_grad"] = chamfer_grad_case(
        clouds(rng, BATCH, NUM_POINT), clouds(rng, BATCH, NUM_POINT),
        f"B={BATCH} N=M={NUM_POINT}")
    chamfer_grad_case(clouds(rng, BATCH, NUM_POINT), clouds(rng, BATCH, 1000),
                      f"B={BATCH} N={NUM_POINT} M=1000")
    chamfer_grad_case(x1, x2, "ties B=4 N=467 M=1000")
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


def kernel_counters(ch, fe, fh):
    """Name -> the wrapper whose ``launches`` counts that kernel."""
    return {"fused_encoder_eval": fe.encoder_extrema_cuda,
            "nn_distance": ch.nn_distance_cuda,
            "fused_head_fwd": fh.head_max_cuda,
            "fused_head_bwd": fh.head_bwd_cuda,
            "nn_distance_grad": ch.nn_distance_grad_cuda}


def phase_train(torch, counters, tmp, rng):
    """Train through ``cli.train``'s own build; returns (trainer, logger,
    launches, summary). The trainer stays open for the timings."""
    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.data import synthetic
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.train import checkpoint

    data = os.path.join(tmp, "chair")
    t0 = time.perf_counter()
    # 384 shapes: 320 trainval (10 batches of 32), 64 test (2 batches).
    synthetic.write_fixture(data, shapes_per_category=384,
                            points_per_shape=NUM_POINT, seed=SEED,
                            categories=["Chair"])
    fixture_s = time.perf_counter() - t0
    log_dir = os.path.join(tmp, "train_log")
    argv = ["--model", "model", "--category", "Chair", "--num_point",
            str(NUM_POINT), "--batch_size", str(BATCH), "--no_rotation",
            "--device", "cuda", "--data_path", data, "--log_dir", log_dir,
            "--log_every", "5"]
    parser = cli_train.build_parser()

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer, logger = cli_train.build_trainer(parser.parse_args(
        argv + ["--max_epoch", str(TRAIN_EPOCHS)]))
    best = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the training path never launched: {launches}")
    steps = trainer.state.step
    require(len(trainer.train_pipe) >= 10
            and steps == TRAIN_EPOCHS * len(trainer.train_pipe),
            f"{steps} steps in {TRAIN_EPOCHS} epochs of "
            f"{len(trainer.train_pipe)} batches")
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    pcloss = [r["pcloss"] for r in recs if r["split"] == "train"]
    require(len(pcloss) == steps // 5 and all(
        np.isfinite(r["loss"]) for r in recs), f"train records {recs}")
    require(pcloss[-1] < pcloss[0], f"pcloss did not fall: {pcloss}")
    bests = sorted(n for n in os.listdir(log_dir)
                   if n.startswith("best_model_epoch_"))
    require(bool(bests), f"no best checkpoint in {os.listdir(log_dir)}")
    best_path = os.path.join(log_dir, bests[-1])
    latest = checkpoint.CheckpointManager(log_dir).latest()
    stored = checkpoint.load(latest)

    resumed, rlogger = cli_train.build_trainer(parser.parse_args(
        argv + ["--max_epoch", str(TRAIN_EPOCHS + 1), "--resume"]))
    try:
        require(resumed.start_epoch == stored["epoch"]
                and resumed.state.step == stored["step"],
                f"resume at epoch {resumed.start_epoch} step "
                f"{resumed.state.step}, stored {stored['epoch']}/"
                f"{stored['step']}")
        require(all(torch.equal(v.cpu(), stored["model"][k]) for k, v in
                    resumed.model.state_dict().items()),
                "resumed weights differ from the checkpoint")
    finally:
        resumed.close()
        rlogger.close()
    session = InferenceSession("model", best_path, NUM_POINT,
                               batch_size=BATCH, bf16=True, device="cuda")
    x = clouds(rng, BATCH, NUM_POINT)
    rec = session.reconstruct(x)
    require(rec.shape == x.shape and np.all(np.isfinite(rec)),
            "session on the best checkpoint")
    say("train", f"fixture of 384 Chair shapes written in {fixture_s:.1f} s; "
        f"{TRAIN_EPOCHS} epochs, {steps} steps in {train_s:.1f} s (data "
        f"loading included); train pcloss by 5-step window "
        f"{[round(v, 6) for v in pcloss]}; best eval loss {best:.6f} in "
        f"{bests[-1]}; resumed from {os.path.basename(latest)} at epoch "
        f"{resumed.start_epoch}, step {resumed.state.step}; a session on "
        f"the best reconstructs (chamfer to input "
        f"{float(session.chamfer(rec, x).mean()):.4f})")
    say("train", f"main-path launches {launches}")

    # One f32 step on the card and the same step on the CPU: same seed, so
    # the same initial weights, and the same batch. Besides loss and
    # pcloss (the forward), each leaf's gradient (the backward through K2,
    # K3's closed form and K4) and the new BN moving statistics. The CPU
    # step takes the card's discrete choices (see shared_choices), so the
    # two differ in rounding only.
    steps_out, choices = [], {}
    for device in ("cuda", "cpu"):
        tr, lg = cli_train.build_trainer(parser.parse_args(
            argv + ["--no-bf16", "--device", device, "--log_dir",
                    os.path.join(tmp, f"step_{device}")]))
        try:
            with shared_choices(choices, replay=device == "cpu"):
                m = tr.train_step(torch.from_numpy(x).to(tr.device))
            steps_out.append((
                {k: float(v) for k, v in m.items()},
                {n: p.grad.double().cpu().numpy()
                 for n, p in tr.model.named_parameters()},
                {n: b.cpu().numpy() for n, b in tr.model.named_buffers()}))
        finally:
            tr.close()
            lg.close()
    (gpu, ggrads, gbufs), (cpu, cgrads, cbufs) = steps_out
    for key in ("loss", "pcloss"):
        require(close(np.float64(gpu[key]), np.float64(cpu[key]), 1e-4, 0.0),
                f"train step {key}: card {gpu[key]} vs CPU {cpu[key]}")
    # A choice differs only at a near-tie; the kernels' own checks above
    # hold the choices at clear margins.
    require(choices["differed"] <= 1e-3 * choices["made"],
            f"train step: the CPU chose otherwise at {choices['differed']} "
            f"of {choices['made']} argmin/argmax choices")
    gaps, noise = grad_gaps(ggrads, cgrads)
    worst, worst_name = gaps[0]
    require(worst < GRAD_REL_TOL,
            f"train step gradient of {worst_name}: relative error norm "
            f"{worst:.3e} over {GRAD_REL_TOL}")
    buf_err = max(max_err(gbufs[n], cbufs[n]) for n in cbufs)
    require(all(close(gbufs[n], cbufs[n], 1e-4, 1e-5) for n in cbufs),
            f"train step BN moving statistics: max abs err {buf_err:.3e}")
    say("train", f"one f32 step, card vs CPU: loss {gpu['loss']:.6f} vs "
        f"{cpu['loss']:.6f} (rtol 1e-4); the CPU's own argmin/argmax "
        f"differed at {choices['differed']} of {choices['made']} choices "
        f"(replaced by the card's); relative gradient error norm, largest "
        f"three: " + ", ".join(f"{n} {r:.3e}" for r, n in gaps[:3])
        + f" (tolerance {GRAD_REL_TOL}); {len(noise)} leaves zero in exact "
        f"arithmetic read under 1e-5 of the gradient's norm on both sides; "
        f"BN moving statistics max abs err {buf_err:.3e} (rtol 1e-4, atol "
        f"1e-5) ok")
    summary = {"pcloss": pcloss, "best_eval_loss": best, "steps": steps}
    return trainer, logger, launches, summary


@contextlib.contextmanager
def shared_choices(store: dict, replay: bool):
    """Within the block, the discrete choices of a train step's forward
    (the Chamfer argmins, the head's argmax) are recorded from the card's
    kernels into ``store``; with ``replay``, the CPU's plain versions
    return the recorded choices in place of their own, counting in
    ``store["differed"]`` where their own differed. A near-tie can fall
    either way under different rounding, and one changed choice moves a
    whole row of a gradient: sharing the choices leaves rounding as the
    only difference between the two steps' gradients."""
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    nn_name = "nn_distance_plain" if replay else "nn_distance_cuda"
    head_name = "head_max_plain" if replay else "head_max_cuda"
    nn_fn, head_fn = getattr(ch, nn_name), getattr(fh, head_name)
    store.setdefault("differed", 0)
    store.setdefault("made", 0)

    def take(key, own):
        if not replay:
            store[key] = own.cpu()
            return own
        card = store[key].to(own.device, own.dtype)
        store["differed"] += int((own != card).sum())
        store["made"] += own.numel()
        return card

    def nn(a, b):
        d1, i1, d2, i2 = nn_fn(a, b)
        return d1, take("idx1", i1), d2, take("idx2", i2)

    def head(x, w, scale, shift):
        maxout, argmax = head_fn(x, w, scale, shift)
        return maxout, take("argmax", argmax)

    # A kernel wrapper counts its launches on the function its module's
    # name holds: the stand-in carries the count meanwhile.
    patched = ((ch, nn_name, nn_fn, nn), (fh, head_name, head_fn, head))
    for mod, name, fn, stand_in in patched:
        stand_in.launches = getattr(fn, "launches", 0)
        setattr(mod, name, stand_in)
    try:
        yield
    finally:
        for mod, name, fn, stand_in in patched:
            setattr(mod, name, fn)
            if hasattr(fn, "launches"):
                fn.launches = stand_in.launches


def grad_gaps(got: dict, want: dict):
    """Each leaf's ||got - want|| / ||want||, as a list of (value, leaf),
    largest first, and the leaves left out. The biases before a training
    BN (and conv5's beta, which fc1's BN cancels) have a gradient that is
    zero in exact arithmetic: both sides must read under 1e-5 of the whole
    gradient's norm, and they are not held by a relative error."""
    total = np.sqrt(sum(float(np.sum(g * g)) for g in want.values()))
    gaps, noise = [], []
    for name, w in want.items():
        g = got[name]
        if np.linalg.norm(w) < 1e-5 * total:
            require(np.linalg.norm(g) < 1e-5 * total,
                    f"train step gradient of {name}: norm "
                    f"{np.linalg.norm(g):.3e} where the CPU's is rounding "
                    f"noise ({np.linalg.norm(w):.3e})")
            noise.append(name)
            continue
        gaps.append((float(np.linalg.norm(g - w) / np.linalg.norm(w)), name))
    return sorted(gaps, reverse=True), noise


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


def phase_timings(torch, fe, ch, fh, session, trainer, rng, launches,
                  errs) -> list:
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

    # K3 and K4 at the training path's shapes, in its default type (bf16)
    # for the JSON rows, and in f32 for the record. K3: operations
    # 2*B*N*128*1024; bytes: x, w, scale and shift read once, (max,
    # argmax) written once. K4: B*F*C products, 4 operations each with the
    # sum; bytes: dx written once, the argmax rows of x, w, gvals, argmax
    # read once, dw written once. No single PyTorch call computes either.
    head = {}
    for dtype_name in ("f32", "bf16"):
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        peak = PEAK_F32_FLOPS if dtype_name == "f32" else PEAK_BF16_FLOPS
        x, w, scale, shift = head_inputs(torch, rng, BATCH, NUM_POINT, dtype)
        es = x.element_size()
        b, n, c = x.shape
        f = w.shape[1]
        _, arg = fh.head_max_cuda(x, w, scale, shift)
        gvals = torch.from_numpy(
            (1e-3 * rng.randn(b, f)).astype(np.float32)).to(dev)
        fwd = dict(
            ms=cuda_ms(torch, lambda: fh.head_max_cuda(x, w, scale, shift)),
            plain_ms=cuda_ms(torch, lambda: fh.head_max_plain(
                x, w, scale, shift)),
            **bound(2.0 * b * n * c * f,
                    x.numel() * es + w.numel() * es + 2 * f * 4 + b * f * 8,
                    peak))
        rows_x = int(torch.unique(arg.long() + n * torch.arange(
            b, device=dev)[:, None]).numel())
        bwd = dict(
            ms=cuda_ms(torch, lambda: fh.head_bwd_cuda(x, w, gvals, arg)),
            plain_ms=cuda_ms(torch, lambda: fh.head_bwd_plain(
                x, w, gvals, arg)),
            **bound(4.0 * b * f * c,
                    x.numel() * es + rows_x * c * es + w.numel() * es
                    + b * f * 8 + c * f * 4, peak))
        say("timings", f"fused_head {dtype_name} B={b} N={n}: forward "
            f"{fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}, bound "
            f"{fwd['bound_ms']:.4f} {fwd['bound_by']}); backward "
            f"{bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, bound "
            f"{bwd['bound_ms']:.4f} {bwd['bound_by']}; {rows_x} argmax "
            f"rows)")
        head[dtype_name] = fwd, bwd
    fwd, bwd = head["bf16"]
    rows.append(dict(
        name="fused_head_fwd", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/fused_head.cu",
        replaces="pointnet_autoencoder_tpu/ops/fused_head.py:116",
        launches=launches["fused_head_fwd"],
        max_abs_err=errs["head_bf16"][0], library_ms=None, **fwd))
    rows.append(dict(
        name="fused_head_bwd", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/fused_head.cu",
        replaces="pointnet_autoencoder_tpu/ops/fused_head.py:180",
        launches=launches["fused_head_bwd"],
        max_abs_err=errs["head_bf16"][1], library_ms=None, **bwd))

    # K2, both directions: bytes: per point of either cloud its xyz (12 B),
    # index (4 B) and cotangent (4 B) read once and its gradient (12 B)
    # written once, 32 B; about 13 operations per point. Library yardstick:
    # one index_add_ doing both directions' segment sums of precomputed -t
    # terms.
    _, i1, _, i2 = ch.nn_distance_cuda(x1, x2)
    g1 = torch.from_numpy(rng.randn(BATCH, NUM_POINT).astype(
        np.float32)).to(dev)
    g2 = torch.from_numpy(rng.randn(BATCH, NUM_POINT).astype(
        np.float32)).to(dev)
    k_ms = cuda_ms(torch, lambda: ch.nn_distance_grad_cuda(
        x1, x2, i1, i2, g1, g2))
    p_ms = cuda_ms(torch, lambda: ch.nn_distance_grad_plain(
        x1, x2, i1, i2, g1, g2))
    offs = NUM_POINT * torch.arange(BATCH, device=dev)[:, None]
    rows_idx = torch.cat([(i1.long() + offs).reshape(-1) + BATCH * NUM_POINT,
                          (i2.long() + offs).reshape(-1)])
    terms = torch.randn(2 * BATCH * NUM_POINT, 3, device=dev)
    out = torch.zeros(2 * BATCH * NUM_POINT, 3, device=dev)
    l_ms = cuda_ms(torch, lambda: out.index_add_(0, rows_idx, terms))
    pts = 2 * BATCH * NUM_POINT
    rows.append(dict(
        name="nn_distance_grad", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/chamfer.cu",
        replaces="pointnet_autoencoder_tpu/ops/chamfer.py:229",
        launches=launches["nn_distance_grad"],
        max_abs_err=errs["nn_distance_grad"], ms=k_ms, plain_ms=p_ms,
        **bound(13.0 * pts, 32.0 * pts), library_ms=l_ms))

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
    trace = device_trace(torch, lambda: session.reconstruct(batch),
                         "chip_smoke.reconstruct")
    for r in rows:
        say("timings", f"{r['name']} B={BATCH} N={NUM_POINT}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms")
    say("timings", f"reconstruct of one batch of {BATCH} (host clock, "
        f"copies included): median {host_ms:.3f} ms")
    say("timings", f"reconstruct traced: {trace}")

    # One train step of the trained bf16 trainer on a batch already on the
    # card: host clock to the loss on the host, median of 10, then traced.
    tb = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)

    def step():
        trainer.train_step(tb)["loss"].item()

    step()
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        host.append(1e3 * (time.perf_counter() - t0))
    say("timings", f"train step, bf16, B={BATCH} N={NUM_POINT} (host "
        f"clock, to the loss on the host): median "
        f"{statistics.median(host):.3f} ms, min {min(host):.3f}, max "
        f"{max(host):.3f}")
    say("timings", f"train step traced: "
        f"{device_trace(torch, step, 'chip_smoke.train_step', top=10, own=True)}")
    return rows


# Substrings of the device-side names of the port's kernels and memsets.
OWN_KERNELS = ("encoder_tile", "reduce_tiles", "nn_distance", "head_",
               "f32_to_bf16", "Memset")


def device_trace(torch, fn, label, top=6, own=False) -> str:
    """One torch.profiler trace of ``fn()`` (which must end with the
    device's work done, e.g. by a copy to the host): the call's span on
    the host clock, the union of device intervals (kernels, memsets and
    copies) inside it, the idle share 1 - busy/span, the number of device
    events, and device time by name. Reports "not measured" when the
    trace holds no device events. ``own``: also the device time and
    count of each of the port's kernels (the CUDA-event time of one call
    of a small kernel also holds its wrapper's launch latency)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):  # the last call is read
            with record_function(label):
                fn()
    events = prof.events()
    spans = [e.time_range for e in events
             if e.name == label and e.device_type == DeviceType.CPU]
    require(len(spans) == 3, f"trace holds {len(spans)} calls, not 3")
    t0, t1 = spans[-1].start, spans[-1].end
    # Annotations on the device timeline (this label, the optimizer's
    # "Optimizer.step#...") are spans around kernels, not device work.
    dev = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1),
                  e.name) for e in events
                 if e.device_type == DeviceType.CUDA and e.name != label
                 and not getattr(e, "is_user_annotation", False)
                 and e.time_range.end > t0 and e.time_range.start < t1)
    if not dev:
        return (f"span {(t1 - t0) / 1e3:.3f} ms; device time and idle "
                f"share not measured (no device events in the trace)")
    busy, end, by_name, count = 0.0, t0, {}, {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        count[name] = count.get(name, 0) + 1
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = (f"span {(t1 - t0) / 1e3:.4f} ms, device busy {busy / 1e3:.4f} "
           f"ms, idle share {1.0 - busy / (t1 - t0):.4f}, {len(dev)} "
           f"device events; device ms by "
           f"name: " + "; ".join(f"{n[:72]} {v / 1e3:.4f}"
                                 for n, v in names))
    if own:
        mine = sorted((n, v) for n, v in by_name.items()
                      if any(k in n for k in OWN_KERNELS))
        out += "; the port's kernels (device ms, count): " + "; ".join(
            f"{_short(n)} {v / 1e3:.4f} x{count[n]}" for n, v in mine)
    return out


def _short(kernel_name: str) -> str:
    """'void (anonymous namespace)::k<T>(args)' -> 'k<T>'."""
    name = kernel_name.replace("void ", "")
    return name.replace("(anonymous namespace)::", "").split("(")[0][:60]


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> dict:
    t_ops = flops / peak * 1e3
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
        from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
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
        errs = phase_kernels(torch, fe, ch, fh, rng)
        counters = kernel_counters(ch, fe, fh)

        with tempfile.TemporaryDirectory() as tmp:
            weights = os.path.join(tmp, "model_2048.npz")
            write_reference_npz(weights, rng)
            serving = ("fused_encoder_eval", "nn_distance")
            for name in serving:
                counters[name].launches = 0
            phase = "session"
            session = phase_session(torch, InferenceSession, weights, rng)
            phase = "server"
            phase_server(weights, rng)
            launches = {name: counters[name].launches for name in serving}
            require(all(n > 0 for n in launches.values()),
                    f"a kernel of the serving path never launched: "
                    f"{launches}")
            say(phase, f"main-path launches {launches}")

            phase = "train"
            trainer, logger, train_launches, _ = phase_train(
                torch, counters, tmp, rng)
            # Serving kernels keep their serving-path counts; the training
            # kernels report the training path's.
            launches.update({k: v for k, v in train_launches.items()
                             if k not in serving})
            try:
                phase = "timings"
                rows = phase_timings(torch, fe, ch, fh, session, trainer,
                                     rng, launches, errs)
            finally:
                trainer.close()
                logger.close()
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
