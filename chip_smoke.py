#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (pointnet_autoencoder_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this script. Phases, one
line each; any failure exits non-zero before the final line:

1. card:    device name, power limit.
2. build:   nvcc builds every kernel source in csrc/, all at once; then
            g++ builds the host sources: the native renderer
            (csrc/render_balls.cpp) and the data loader's parser
            (csrc/fastio.cpp).
3. kernels: each kernel against its plain PyTorch version on the card,
            at the main paths' shapes and at ragged shapes. K1, K2, K3, K4,
            K5 bf16 and K6 are also held bit-equal over two calls; K1
            bit-equal to its plain version (distances and indices, ties and
            B=1, N=M=65536 included); K3 in bf16 (tensor cores) at N=2048,
            2047 and 100, with duplicated points (the lower copy wins every
            tie) and all-zero channels (point 0 wins); K4's dx bit-equal to
            its plain version on the CPU, in f32 and bf16, also where many
            channels share a row; K5 f32 and bf16 (tensor cores) at N=2048
            and 2047; K2 bit-equal to its plain version on the CPU (and at
            B=1, N=M=65536, past one block's shared memory); K1 and K2
            also at model_hierachy's center term, B=32 with (N, M) =
            (64, 2048) and (2048, 64), bit-equal; K1 and K2 at PCN's
            fine Chamfer, B=32 with N=M=16384 (K2 in its scratch
            buffer), bit-equal; K6 against float64 no worse than 2x the
            plain f32 version, and at PCN's coarse EMD, B=32 N=M=1024.
3b. batch_norm_kernel: K7, training BatchNorm + ReLU, against its plain
            version in f32 (a bf16 input upcast) on the card at the
            training path's shapes ((65536,
            64), (65536, 128), (262144, 64), (262144, 128), (32, 1024),
            (128, 1024) in bf16; two in f32), ragged rows, channel counts
            that take one element a thread, and an UpConv stage's
            permuted 4-D activation through the autograd Function: the
            moments, the moving statistics, the output, and dx, dgamma and
            dbeta on the kernel's own moments and ReLU mask; two calls
            bit-equal, a CUDA graph's replay bit-equal to eager. After
            phase 8, each direction's CUDA-event and device time a call
            at the main shapes beside its bound, the plain version's
            time and F.batch_norm + F.relu's (the yardstick).
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
            --num_point 2048 --batch_size 32 --no_rotation``, bf16, device
            input and background saves by default) built as ``cli.train``
            builds it, on a fixture of 320
            train and 64 test Chair shapes, for 2 epochs: finite losses, a
            falling pcloss, a best checkpoint, a ``--resume`` that restarts
            at the stored epoch and step, and a session on the checkpoint.
            Launch counters are zeroed before it and read after it: every
            kernel of the training path (its eval epoch included) must have
            run. Then one f32 train step on the card against the same step
            on the CPU from the same weights and batch, with the card's
            argmin/argmax choices and ReLU masks: loss, every gradient, BN
            statistics; on two batches. Device input's batch assembly
            (gather, resample, rotation) on the card equals the CPU's bit
            for bit at B=32, N=2048.
7. train_emd: the EMD training path (``--model model_emd``, otherwise as
            phase 6) on the same fixture for 2 epochs: finite losses, a
            falling EMD loss, a best checkpoint and a ``model_emd`` session
            on it. Launch counters are zeroed before it and read after it:
            K6, K3, K4, K1 and K5 must have run. Then one f32 step on the
            card against the CPU's at B=8 (the CPU's dense EMD), the CPU
            taking the card's choices and EMD outputs; K6 is held to its
            plain version on the step's own inputs, and the CPU's own EMD
            to K6, at K6's tolerances.
8. timings: CUDA-event medians of each kernel, its plain version and the
            library yardstick; the device time per call (median of 50
            traced calls) of K5, K3 and K4 (both types), K1, K2 and
            index_add_ (no memset for K2, only K4's own kernels in its
            trace); the host time of one full
            reconstruct and of one train step of each model, and one
            torch.profiler trace of each (device busy time, idle share,
            device time by kernel); the ``model`` bf16 step with its input
            built on the card (device input) and from the host pipeline
            (host input): host median, device busy time, idle share; K1
            beside its library yardstick (torch.cdist and two min) by
            device time per call at model_hierachy's (64, 2048) and at
            B=1.
9. families: ``--model`` model_cpu, model_hierachy, model_upconv and
            model_fc_upconv, each trained as phase 6 (bf16, 2 epochs, the
            same fixture) but with ``--input_mode host``: finite losses, a falling eval pcloss, a best
            checkpoint and a bf16 session on it (reconstruct, embed,
            decode at B=32). Launch counters are zeroed before each run
            and read after it, and must equal what the path needs: K3 and
            K4 once per step, K5 once per eval batch, K1 and K2 once per
            Chamfer call (two per batch for model_hierachy, none for
            model_cpu, whose loss is the dense Chamfer). The host median
            and a trace of one bf16 train step of each (of the two upconv
            families also with cuDNN deterministic, as the point-parallel
            step runs them); one f32 step at B=8 on the card against the
            CPU's, as in phase 6, for the three families with Chamfer
            kernels.
9b. pcn_emd: ``--model pcn_emd`` at its published widths and the cell
            train.pcn_emd.b32's shapes (B=32, 2048 input points, a
            16,384-point target), bf16, through ``make_step_fns``'
            captured step from step 50,001. Launch counters zeroed
            before each call: exactly one K1, one K2 and one K6 call and
            nothing else in the eager first call, in the call that
            captures the program and in a replay (which counts the
            program's captured launches); a traced replay shows one
            graph launch and each of the three kernels once, and the
            program counts 5 replays. Finite losses. (Phase 3 holds K1 and K2 to
            their plain versions at B=32, N=M=16384 and K6 at B=32,
            N=M=1024, the step's shapes.)
10. cli_test: ``cli.test.main`` on phase 6's best checkpoint (16 shapes,
            4 decoder groups, F-score at 0.01): K5 launched once and K1
            twice per shape (chamfer and fscore) and nothing else, each
            shape's Chamfer within rtol 1e-5 of the same command on the
            CPU, 48 renders, the native image of the first shape against
            the plain renderer; shapes per second, and the device time per
            call of K5 f32 and K1 at B=1 with their bounds.
11. export_import: ``cli.export --format reference_npz`` of that
            checkpoint, ``cli.import_tf`` on it (a dry run with no unmapped
            variable, then ``--out``), ``cli.export --format bundle``: both
            bundles reconstruct a B=32 batch bit-equal to the checkpoint's
            session.
12. preempt: device-input training of ``model`` in this process, SIGTERM
            from a thread after the first logged step: ``train()``
            returns with a preemption checkpoint, ``--resume`` starts at
            the same step, the previous handler is back. Then a snapshot
            submitted to the background saver, a synchronous host copy, 5
            more steps and a flush: the checkpoint equals the host copy
            bit for bit. The training thread's time in one save of the
            model state, in the background and synchronous.
13. data_parallel: 2 ranks sharing the card over gloo (NCCL refuses two
            ranks on one device), spawned by ``parallel.mesh.launch``. One
            f32 step of ``model`` and of ``model_emd`` at a global B=32,
            16 rows per rank, through ``cli.train``'s build, against the
            same step on the card alone, the ranks replaying its choices:
            loss rtol 1e-5, BN statistics rtol 1e-4 atol 1e-6, gradients
            within 1e-5 of the largest element, each of the two raised to
            twice the same step's own f32 floor (the batch's rows swapped
            in pairs) where that floor is higher; per-rank launches K3 =
            K4 = K1 = K2 = 1 (``model_emd``: K6 = 1, no K2). The step in an
            NCCL group of one rank, bit-equal to the step without a group.
            SIGTERM to rank 1 alone during device-input training: both
            ranks stop at the epoch's end, one checkpoint, a 2-rank resume
            from that step. ``cli.train`` with 2 ranks on the card
            (``devices``, ``backend="gloo"``), 2 bf16 epochs of device
            input: per-rank launches exactly the path's, weights bit-equal
            across ranks, eval pcloss falling, rank 0's checkpoint in a
            one-card session; each rank's step host median, trace and peak
            memory. A 2-replica ``InferenceSession`` against the one-card
            session within 1e-5 (ragged batch included), K5 once per
            replica and batch, a ``PointServer`` over it. The ranks'
            bf16 Trainers of ``model`` and ``model_emd`` captured (a tape
            each: a graph per stretch between two all-reduces, the
            all-reduces eager between replays) beside eager from one
            seed, 2 device-input epochs at log_every 3: train state, eval
            losses and launches bit-equal, 15 all-reduces a step both
            ways, at most one graph launch more; host median, host
            operations, graph launches and collectives a step, both ways.
            The NCCL group of one captured (its all-reduces inside each
            graph, one graph launch a chunk) bit-equal to the graphed
            Trainer without a group; the logs name both paths. No time
            here is a multi-card time.
14. master: bf16 master weights and moments (``--bf16_params
            --bf16_moments``, train/master.py). Stochastic rounding of 2^20
            values (zeros, subnormals, the largest finite, infs, NaNs) on
            the card bit-equal to the CPU's on one injected noise tensor.
            ``cli.train`` 2 epochs of ``model``, the default run and the
            bf16-master run: launches exactly the path's (K3 = K4 = K2 =
            20, K1 24, K5 4), matmul weights and their Adam slots bf16, BN
            parameters, slots and statistics f32, eval pcloss falling and
            under 2x the default run's, the train state's MB beside the
            default's; each step's host median and trace (both runs
            captured, the default on a card). 10 steps, a checkpoint,
            ``--resume`` and 10 more equal 20 uninterrupted steps bit for
            bit. One ``model_emd --bf16_params`` step runs
            K6. 2 ranks over gloo, 2 epochs: the ranks' states bit-equal.
            An f32 session on the bf16 checkpoint equals one on its
            explicit f32 upcast bit for bit.
15. point_parallel: 2 ranks sharing the card over gloo, each with 1024
            of every shape's 2048 points (parallel/sp.py). One f32 step of
            ``model`` and ``model_emd`` at B=32 and of the other four
            families at B=8, through ``cli.train``'s build with
            ``--point_parallel``, against the card alone's step on the
            same batch and weights, the ranks replaying its ReLU masks and
            Chamfer argmins: loss rtol 1e-5, BN statistics rtol 1e-4 atol
            1e-6 and gradients within 1e-5 of the largest element, each
            raised to twice the card alone's f32 floor (the same step with
            every shape's points rolled by N/2; for ``model_emd``'s loss
            also its distance to the float64 EMD on the step's inputs);
            ``model_emd``'s reference runs the EMD's dense form on the
            card (the ranks' per-shard formulation), and its SP loss is
            also held to the card alone's step on K6 within twice the
            larger of K6's gap to the dense form and the dense form's
            floor.
            Per-rank launches per step: K3 = K4 = 1, K1 = K2 = 1 (2 for
            ``model_hierachy``, 0 for ``model_cpu``), ``model_emd`` K1 = 1
            and K2 = K6 = 0. The combined Chamfer indices equal K1's on
            the card alone; the eval embedding bit-equal to the card
            alone's, K5 once per rank; ``--bf16_params`` for 3 steps: the
            ranks' states bit-equal; each rank's bf16 step of ``model``,
            ``model_emd`` and ``model_upconv`` (cuDNN deterministic within
            the step): host median, trace, peak memory.
            ``cli.train --point_parallel --data_parallel 2``, 2 bf16 epochs:
            per-rank launches the path's, the ranks' states bit-equal, eval
            pcloss falling. K1, K3, K4 and K5 at one rank's shard shapes:
            device time per call beside each bound. ``model`` and
            ``model_emd`` captured beside eager as in phase 13. No time
            here is a multi-card time.
16. fastio: (run after phase 6 writes its fixture) the data loader's
            native parser (data/fastio.py over csrc/fastio.cpp) on every
            .pts and .seg file of the 384-shape fixture, bit-equal to its
            numpy version; both paths refuse a .pts with normals (3
            columns expected, 6 found), a .seg with a confidence column
            and a .pts of 5 values, as the JAX package's loader does.
17. tensor_parallel: 2 ranks sharing the card over gloo, 1 data x 2
            model: the decoder's fc1 and fc3 split by columns and fc2 by
            rows (parallel/tp.py). One f32 step of ``model`` and of
            ``model_emd`` (K6 on each rank) at B=32 through ``cli.train``'s
            build with ``--model_parallel 2``, against the card alone's
            step on the same batch, the ranks replaying its choices (a
            split layer's masks at the rank's columns): loss rtol 1e-4, BN
            statistics rtol 1e-4 atol 2e-5 (JAX's
            test_tp_matches_single_device), the gradients gathered over
            the model group within 1e-5 of the largest element or twice
            the card alone's f32 floor (its batch rows swapped in pairs);
            the replicated leaves' gradients bit-equal across the ranks;
            per-rank launches K3 = K4 = K1 = K2 = 1 (``model_emd``: K6 = 1,
            no K2). The split leaves of ``model_hierachy`` and
            ``model_fc_upconv``. ``cli.train --model_parallel 2
            --bf16_params``, 2 bf16 epochs of device input: per-rank
            launches the path's, the replicated leaves bit-equal across
            the model group, eval pcloss falling; each rank's step host
            median, trace and peak memory. The run's best checkpoint (the
            one-card format) in a one-card session against
            ``InferenceSession(model_parallel=2)`` on cuda:0 twice
            (captured: its two devices are one card), within
            rtol and atol 1e-5. ``model`` captured beside eager as in
            phase 13.
18. pipeline_parallel: ``PipelinedSession`` on ["cuda:0", "cuda:0"]
            (a stream per stage), B=32 in 4 microbatches, f32 and bf16:
            reconstruct, embed and decode against the unpipelined session
            at rtol 1e-5, atol 1e-6 (JAX's
            test_pipelined_session_matches_unpipelined); K5 4 launches per
            batch; one batch's host time pipelined and unpipelined, and a
            trace of the pipelined one (device busy, idle share); both
            stages captured (the default on a card).
19. dp_sp:  4 ranks sharing the card over gloo, 2 data x 2 point
            (``parallel/sp.py``'s ``make_sp_step_fns(..., batch_axis=
            DATA_AXIS)``): each rank holds 16 rows and 1024 points of every
            shape. One f32 step of ``model`` and of ``model_emd`` against
            the card alone's (its EMD in the dense form, the ranks'
            per-shard form): loss and pcloss rtol 1e-5, BN statistics rtol
            1e-4 atol 2e-5 (JAX's
            test_dp_sp_train_step_matches_single_device); per-rank
            launches K3 = K4 = K1 = 1, K2 = 1 (``model_emd`` 0), K6 = 0;
            the combined Chamfer indices equal to K1's on the card alone.
            The step functions of ``model`` captured
            (``make_sp_step_fns(compiled=True)``, the default) beside
            eager, 2 epochs of 5 steps on batches made on the card, held
            as in phase 13. No time in phases 17-19 is a multi-card
            time.
20. hwcheck: the port's ``ops/hwcheck.py`` in this process (``main`` with
            --device cuda and a fuzz draw for every shape of its pool):
            K1, K2, K3 (f32 and bf16), K5 (f32 and bf16, N = 64, 63, 65,
            255, 257), K6, the point-sharded Chamfer in a one-rank gloo
            group and the EMD's streaming form, each against the numpy
            oracles of ``ops/oracles.py`` at the JAX package's tolerances
            (bf16 at the derived ones). rc 0, no failure, and the launch
            counters of K1, K2, K3, K5 and K6 risen inside the phase (no
            contract differentiates through the head, so K4 is left to
            the phases above); the largest error of each contract
            against its tolerance, the checks' count and seconds.
21. profile: ``cli.train --profile_dir`` as phase 6 runs it (bf16, 2
            epochs, device input, background saves): launches exactly
            the path's, one Chrome trace, of the first epoch only, whose
            device events name K1 ``nn_distance_kernel``, K2
            ``nn_distance_grad_kernel``, K3 ``head_fwd_mma_kernel``, K4
            ``head_bwd_dx_kernel`` and ``head_bwd_dw_kernel`` and K5
            ``encoder_mma_kernel`` as often as one epoch launches them,
            and the log line, then the line of the step phases' medians
            (printed); each epoch's wall clock, profiled and not,
            and whether TensorBoard writers were made. Then ``StepTimer``
            around 10 bf16 steps: its p50 within the spread of
            ``step_timing``'s 10 host samples of its median.
22. compiled: the captured programs (``utils/graphs.py``; on a card the
            default of ``Trainer`` and ``InferenceSession``, so phases 4-10
            and 21 run them) against the eager reference
            (``compiled=False``). Each of the six families in bf16, and
            ``model`` in f32, with device input at log_every 3 (chunks of
            3, 3, 3 and 1 steps: the first chunk is the warm-up, eager,
            then a program of 3 steps replayed twice and one of 1), and
            ``model`` bf16 with host input (the first step eager, then a
            one-step program), ``model_cpu`` under torch's deterministic
            algorithms (its dense Chamfer's index_add_ adds with atomics
            in arrival order otherwise): one train epoch and two eval
            epochs (the
            second a replay of the whole eval epoch), weights, optimizer
            slots and counts, BN statistics, the data generators' states,
            every logged metric and the launches bit-equal to the eager
            Trainer's from the same seed (the upconv families under
            ``cudnn_deterministic()``). Then each Trainer's step on a batch
            on the card: host median of 10, and a trace: device busy,
            idle share, the operations the host issued (one graph launch
            per replayed step), and a traced device-input epoch (one graph
            launch per chunk); in each trace, graphed and eager, the port's
            kernels as the launch counters count that call (a trace that
            lost events, or a graphed one whose kernels, memsets
            included, are not the eager one's, is taken again), the same
            both ways. A checkpoint
            in a CPU Trainer's form (Adam not capturable, a float learning
            rate) and the same state as a card writes it, each resumed by
            a captured card Trainer: 3 steps from each bit-equal.
            ``model`` with ``--bf16_params --bf16_moments``, and with
            ``--bf16_params`` alone, 2 epochs at log_every 3 beside eager
            as above, the noise generator's offset equal too (K1-K5
            launched as the default path), the graphed Trainer holding
            its train programs of 3 steps and of 1, the device-input
            epoch traced for the first of the two, and the
            graphed step's host median against its device busy time plus
            0.5 ms, its host operations against 6 and its busy time
            against eager's within 5%, each reported held or missed; 5
            captured steps, a checkpoint, ``resume`` and 5 more bit-equal
            to 10 steps alone. Serving at B=32 and B=1 in f32, B=32 in bf16, and a
            TP-split session (``model_parallel=2`` on cuda:0 twice,
            captured whole) at B=32 and B=1 in f32: reconstruct, embed,
            decode, chamfer and fscore bit-equal to the eager session
            with equal launches (K5 once per forward call, K1 once per
            metric call); a reconstruct's host median and trace both
            ways. ``PipelinedSession`` on ["cuda:0", "cuda:0"], B=32
            f32 in 4 microbatches: reconstruct, embed and decode graphed
            bit-equal to the eager pipeline with equal launches (K5 4 a
            batch), and so is reconstruct after an embed as a session's
            first call, within rtol 1e-5, atol 1e-6 of the session, 8 graph
            launches a batch; host median and trace both ways. Last
            ``ops.benchmarks --quick`` through its ``main``: K1 and K2 21
            launches, K6 6, nothing else, and each run's final loss equal
            to the same loop's run eagerly on the card.
            The roofline (``utils/roofline.py``) of each family's bf16
            step, ``model`` f32, both master steps and the served
            reconstructs (B=32 f32 and bf16, B=1 f32): a ``StepCost`` of
            one eager call on the card and of the same call on the CPU
            (the Trainer's state moved there first; the head's argmax and
            the EMD's outputs taken from the card's call, inside the
            kernels' charges), equal op by op outside the parts the two
            run differently by design (the optimizer's update; a served
            call's copies between the host and the card), with the
            difference printed, and ``roofline_report`` against the
            graphed host median and against the trace's device busy
            time: floor, memory bound, bound, pct_of_bound and mfu. Then
            the encoder's training forward and backward at B=32, N=2048
            with ``moment_stats`` True and False from the same weights:
            in f32 features within rtol/atol 2e-3 and BN moving
            statistics within rtol 1e-3, atol 1e-4 of each other (the JAX
            package's tolerances), in bf16 both within the bf16 tolerance
            (one flipped bf16 rounding of a folded BN scale moves a whole
            channel by a bf16 step), and each one's device busy time per
            call, the median of 10 traced calls.
23. bench: the port's benchmark script as a user runs it, ``python -m
            pointnet_autoencoder_tpu_torch.bench`` in a subprocess with
            its self-record in the run's tmp dir and BENCH_BUDGET_S=120:
            rc 0, every stdout line JSON, the self-record the last line,
            the metric ``train_throughput_model_b32_n2048``, nothing
            skipped, ``model_step_ms`` between 0.9 x phase 22's graphed
            ``model`` step's device busy time and 1.1 x its host median;
            every row (the train steps of the six families, the served
            forwards at B=32, 1 and 512, the dispatch probe) timed on
            graph replays, one a call by its ``ProgramCache``, and each
            kernel launched during a row as often as the row's eager call
            times its calls. Then the script again under SLURM's
            variables (a job id whose port is free), which make it an
            NCCL group of one rank, headline only (BENCH_BUDGET_S=0); the
            two headlines printed.

The f32 step checks of phases 6, 7 and 9 take the first step of a fresh
Trainer, which is its warm-up and runs eagerly, so the choices that
``shared_choices`` records are the step's own.

The last three lines are the kernels JSON line, the nvidia-smi line and
the device JSON line.
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
import types

import numpy as np

NUM_POINT = 2048
BATCH = 32
SEED = 0
EPS = 1e-3
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
# Head backward (K4) given the same argmax: dx is held bit-equal to the
# plain version on the CPU (both add each row's products in ascending
# channel, index_add_'s order there) and over two calls; dw sums over b in
# order, the plain version on the card by another product's order.
HEAD_DW_TOL = (1e-5, 1e-6)
# Chamfer gradient (K2) against its plain version on the card, whose
# index_add_ adds with f32 atomics in a varying order. (On the CPU the plain
# version adds in index order, the kernel's order, and is held bit-equal.)
CHAMFER_GRAD_TOL = (1e-5, 1e-6)
# One f32 train step, card against CPU with the same argmin/argmax
# choices and ReLU masks: each leaf's relative gradient error norm. The
# two differ in every product's and reduction's summation order (cuBLAS
# against the CPU's BLAS, the kernels' atomics); the largest reading on an
# H100 was 4.3e-4 (fc1's BN gamma).
GRAD_REL_TOL = 1e-3
TRAIN_EPOCHS = 2
# EMD (K6) against its plain version, same inputs, same card: the JAX
# package's hardware tolerances (ops/hwcheck.py:95-102), cost within 2e-3
# of the largest cost, gradients within 5e-3 -- here by each batch
# element's relative error norm, not by the largest entry: the f32 function
# is ill-conditioned at a few points, where any two f32 evaluations differ
# by up to a few percent of the largest gradient. The kernel's exp2 flushes
# results under 2^-126 to 0 and takes K of a level from the next level's K
# squared twice: rounding of the same class. The kernels phase prints how
# far the kernel and the plain version each sit from the plain version
# evaluated in float64, by both measures, and holds the kernel's cost and
# gradient error norm there within EMD_F64_FACTOR of the plain version's.
EMD_COST_TOL = 2e-3
EMD_GRAD_TOL = 5e-3
EMD_F64_FACTOR = 2.0
EMD_STEP_BATCH = 8
# model_hierachy's first stage: 64 centers, held against the label by the
# Chamfer kernels.
HIER_CENTERS = 64
# PCN (--model pcn_emd, the cell train.pcn_emd.b32): 2048 input points,
# 1024 coarse points held to the target's first 1024 by K6, 16,384 fine
# points held to the 16,384-point target by K1 and K2, at B=32.
PCN_COARSE = 1024
PCN_FINE = 16384


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


def nn_plain_chunked(torch, ch, a, b, rows=4096):
    """``nn_distance_plain`` over row chunks of ``a``, one (B, rows, M) d2
    at a time: the same d2 bits; each column's first minimum over the
    chunks in order (strict '<', so an earlier chunk keeps a tie)."""
    parts1, best2, arg2 = [], None, None
    for r0 in range(0, a.shape[1], rows):
        d1, i1, d2, i2 = ch.nn_distance_plain(a[:, r0:r0 + rows], b)
        parts1.append((d1, i1))
        i2 = i2 + r0
        if best2 is None:
            best2, arg2 = d2, i2
        else:
            take = d2 < best2
            best2 = torch.where(take, d2, best2)
            arg2 = torch.where(take, i2, arg2)
    return (torch.cat([d for d, _ in parts1], dim=1),
            torch.cat([i for _, i in parts1], dim=1), best2, arg2)


def emd_gaps(got, want):
    """(cost error over the largest cost (at least 1), the largest of each
    batch element's relative gradient error norm, the largest gradient
    entry's error over the largest gradient) of two (cost, grad1, grad2)."""
    cost = max_err(got[0], want[0]) / max(float(np.abs(want[0]).max()), 1.0)
    diff = [np.asarray(g, np.float64) - np.asarray(w, np.float64)
            for g, w in zip(got[1:], want[1:])]
    num = np.sqrt(sum((d * d).sum(axis=(1, 2)) for d in diff))
    den = np.sqrt(sum((np.asarray(w, np.float64) ** 2).sum(axis=(1, 2))
                      for w in want[1:]))
    scale = max(float(np.abs(w).max()) for w in want[1:])
    entry = max(float(np.abs(d).max()) for d in diff) / scale
    return cost, float(np.max(num / den)), entry


def phase_kernels(torch, fe, ch, fh, rng) -> dict:
    dev = torch.device("cuda")
    errs = {}

    def encoder_case(b, n, dtype_name, gen=rng):
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        layers = [tuple(torch.from_numpy(x).to(dev) for x in layer)
                  for layer in random_layers(gen)]
        chain = fe.fold_layers(layers, eps=EPS, dtype=dtype)
        pts = torch.from_numpy(clouds(gen, b, n)).to(dev)
        kmax, kmin = fe.encoder_extrema_cuda(pts, chain)
        pmax, pmin = fe.encoder_extrema_plain(pts, chain)
        if dtype_name == "bf16":  # the tensor-core route
            again = fe.encoder_extrema_cuda(pts, chain)
            require(torch.equal(kmax, again[0]) and torch.equal(kmin, again[1]),
                    f"fused encoder B={b} N={n} bf16: two calls differ")
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
        twice = ", two calls bit-equal" if dtype_name == "bf16" else ""
        say("kernels", f"fused_encoder B={b} N={n} {dtype_name}: max_abs_err "
            f"{err:.3e} (rtol {rtol}, atol {atol}){twice} ok")
        return err

    errs["fused_encoder"] = encoder_case(BATCH, NUM_POINT, "f32")
    encoder_case(BATCH, NUM_POINT, "bf16")
    encoder_case(BATCH, NUM_POINT - 1, "f32")
    encoder_case(BATCH, 100, "f32")
    encoder_case(3, 37, "bf16")
    # A ragged last 256-point tile of the bf16 route; its own seed, so the
    # cases after it keep their inputs.
    encoder_case(BATCH, NUM_POINT - 1, "bf16",
                 gen=np.random.RandomState(SEED + 7))

    def chamfer_case(x1, x2, label, plain=None):
        a = torch.from_numpy(x1).to(dev)
        b = torch.from_numpy(x2).to(dev)
        k = [t.cpu().numpy() for t in ch.nn_distance_cuda(a, b)]
        again = [t.cpu().numpy() for t in ch.nn_distance_cuda(a, b)]
        require(all(np.array_equal(t, u) for t, u in zip(k, again)),
                f"nn_distance {label}: two calls differ")
        p = [t.cpu().numpy() for t in (plain or ch.nn_distance_plain)(a, b)]
        err = max(max_err(k[0], p[0]), max_err(k[2], p[2]))
        # The kernel computes each pair's d2 as the plain version does.
        differ = sum(int((kk.view(np.int32) != pp.view(np.int32)).sum())
                     for kk, pp in zip(k, p))
        require(differ == 0, f"nn_distance {label}: {differ} distances or "
                f"indices differ from the plain version (max abs err "
                f"{err:.3e})")
        say("kernels", f"nn_distance {label}: distances and indices "
            f"bit-equal to the plain version and over two calls ok")
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
    # Many query tiles combined per column (256 here); the plain version in
    # row chunks of xyz1. Its own seed, so the cases after it keep theirs.
    big = np.random.RandomState(SEED + 5)
    chamfer_case(clouds(big, 1, 65536), clouds(big, 1, 65536),
                 "B=1 N=M=65536", plain=lambda a, b: nn_plain_chunked(
                     torch, ch, a, b))

    def head_case(b, n, dtype_name, x=None, shift=None, label="",
                  gen=rng):
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        x0, w, scale, shift0 = head_inputs(torch, gen, b, n, dtype)
        x = x0 if x is None else x
        shift = shift0 if shift is None else shift
        kmax, karg = fh.head_max_cuda(x, w, scale, shift)
        kmax2, karg2 = fh.head_max_cuda(x, w, scale, shift)
        pmax, parg = fh.head_max_plain(x, w, scale, shift)
        what = f"B={b} N={n} {dtype_name}{label}"
        require(torch.equal(kmax, kmax2) and torch.equal(karg, karg2),
                f"head forward {what}: two calls differ")
        # The plain version's best and second-best value per channel.
        o = torch.clamp_min(torch.matmul(x.float(), w.float()) * scale
                            + shift, 0.0)
        top2 = o.topk(2, dim=1).values
        torch.cuda.synchronize()
        rtol, atol = HEAD_FWD_TOL
        k, p = kmax.cpu().numpy(), pmax.cpu().numpy()
        err = max_err(k, p)
        require(np.all(np.isfinite(k)) and close(k, p, rtol, atol),
                f"head forward {what}: max abs err "
                f"{err:.3e} over rtol {rtol} atol {atol}")
        v1, v2 = top2[:, 0].cpu().numpy(), top2[:, 1].cpu().numpy()
        clear = (v1 - v2) > atol + rtol * np.abs(v1)
        wrong = (karg.cpu().numpy() != parg.cpu().numpy()) & clear
        require(not wrong.any(), f"head forward {what}: argmax "
                f"differs at {int(wrong.sum())} clear maxima")
        berr = head_bwd_case(x, w, parg, what, gen)
        say("kernels", f"fused_head {what}: forward max_abs_err {err:.3e}, "
            f"argmax equal at {int(clear.sum())} clear maxima, two calls "
            f"bit-equal ok")
        return err, berr, karg, kmax

    def head_bwd_case(x, w, arg, what, gen):
        """K4 given ``arg``; gvals at the scale of a training step's (loss
        x100 over B*F outputs). dx bit-equal over two calls and to the
        plain version on the CPU; dw within HEAD_DW_TOL of the plain
        version on the card. Returns the max abs error against the plain
        version on the card."""
        b = x.shape[0]
        gvals = torch.from_numpy(
            (1e-3 * gen.randn(b, 1024)).astype(np.float32)).to(dev)
        kdx, kdw = fh.head_bwd_cuda(x, w, gvals, arg)
        kdx2, kdw2 = fh.head_bwd_cuda(x, w, gvals, arg)
        pdx, pdw = fh.head_bwd_plain(x, w, gvals, arg)
        cdx, _ = fh.head_bwd_plain(*(t.cpu() for t in (x, w, gvals, arg)))
        torch.cuda.synchronize()
        require(kdx.dtype == x.dtype and torch.equal(kdx, kdx2)
                and torch.equal(kdw, kdw2),
                f"head backward {what}: two calls differ")
        bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        differ = int((kdx.cpu().view(bits) != cdx.view(bits)).sum())
        require(differ == 0, f"head backward dx {what}: {differ} entries "
                f"differ from the plain version on the CPU")
        kdx, pdx = kdx.float().cpu().numpy(), pdx.float().cpu().numpy()
        kdw, pdw = kdw.cpu().numpy(), pdw.cpu().numpy()
        require(close(kdw, pdw, *HEAD_DW_TOL),
                f"head backward dw {what}: max abs err "
                f"{max_err(kdw, pdw):.3e}")
        rows = arg.long() + x.shape[1] * torch.arange(b, device=dev)[:, None]
        most = int(torch.bincount(rows.reshape(-1)).max())
        berr = max(max_err(kdx, pdx), max_err(kdw, pdw))
        say("kernels", f"fused_head backward {what}: dx bit-equal to the "
            f"plain version on the CPU and over two calls (up to {most} "
            f"channels on one row); dw max_abs_err {max_err(kdw, pdw):.3e} "
            f"(rtol {HEAD_DW_TOL[0]}, atol {HEAD_DW_TOL[1]}) ok")
        return berr

    errs["head_f32"] = head_case(BATCH, NUM_POINT, "f32")[:2]
    errs["head_bf16"] = head_case(BATCH, NUM_POINT, "bf16")[:2]
    head_case(BATCH, NUM_POINT - 1, "f32")
    head_case(BATCH, 100, "bf16")
    head_case(3, 37, "f32")
    # The cases below draw from a seed of their own, so the phases after
    # them see the inputs they saw before these cases.
    extra = np.random.RandomState(SEED + 6)
    head_case(BATCH, NUM_POINT - 1, "bf16", gen=extra)
    # Exact ties: the second half of the points copies the first, so the
    # lower copy must win every channel; and channels whose every output
    # is 0 (shift far below zero), where the first point wins.
    half = head_inputs(torch, extra, BATCH, NUM_POINT // 2,
                       torch.bfloat16)[0]
    shift = 0.1 * extra.randn(1024)
    shift[::8] = -1e4
    shift = torch.from_numpy(shift.astype(np.float32)).to(dev)
    _, _, karg, kmax = head_case(BATCH, NUM_POINT, "bf16",
                                 x=torch.cat([half, half], dim=1),
                                 shift=shift, label=" ties", gen=extra)
    require(bool((karg < NUM_POINT // 2).all()),
            "head forward bf16 ties: a later copy won a tie")
    require(bool((kmax[:, ::8] == 0).all() and (karg[:, ::8] == 0).all()),
            "head forward bf16: an all-zero channel did not pick point 0")
    say("kernels", "fused_head bf16 ties: the lower copy won every channel; "
        "all-zero channels picked point 0 ok")
    head_case(3, 37, "bf16", gen=extra)
    # Many channels on one row: four points of a large norm take the
    # argmax of most channels whose scaled product grows with them, so K4's
    # dx sums many products into each of those rows.
    for dtype_name in ("f32", "bf16"):
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        x = head_inputs(torch, extra, BATCH, NUM_POINT, dtype)[0]
        x[:, :4] *= 30.0
        karg = head_case(BATCH, NUM_POINT, dtype_name, x=x,
                         label=" shared rows", gen=extra)[2]
        most = int(torch.bincount(karg[0].long()).max())
        require(most >= 64, f"head shared rows {dtype_name}: at most {most} "
                f"channels share a row")

    def chamfer_grad_case(x1, x2, label, gen=rng, long_segments=False):
        a = torch.from_numpy(x1).to(dev)
        b = torch.from_numpy(x2).to(dev)
        _, i1, _, i2 = ch.nn_distance_cuda(a, b)
        g1 = torch.from_numpy(gen.randn(*x1.shape[:2]).astype(
            np.float32)).to(dev)
        g2 = torch.from_numpy(gen.randn(*x2.shape[:2]).astype(
            np.float32)).to(dev)
        args = (a, b, i1, i2, g1, g2)
        k = [t.cpu().numpy() for t in ch.nn_distance_grad_cuda(*args)]
        again = [t.cpu().numpy() for t in ch.nn_distance_grad_cuda(*args)]
        require(all(np.array_equal(t, u) for t, u in zip(k, again)),
                f"nn_distance_grad {label}: two calls differ")
        # The kernel adds each row's terms in ascending index, as
        # index_add_ does on the CPU: the plain version there gives the
        # same bits.
        cpu = [t.numpy() for t in ch.nn_distance_grad_plain(
            *(t.cpu() for t in args))]
        differ = sum(int((kk != cc).sum()) for kk, cc in zip(k, cpu))
        require(differ == 0, f"nn_distance_grad {label}: {differ} entries "
                f"differ from the plain version on the CPU")
        p = [t.cpu().numpy() for t in ch.nn_distance_grad_plain(*args)]
        err = max(max_err(k[0], p[0]), max_err(k[1], p[1]))
        rtol, atol = CHAMFER_GRAD_TOL
        if long_segments:
            # Rows that take tens of terms: the plain version's atomics add
            # them in any order, which moves a row by a few ulp of the sum
            # of its terms' magnitudes, not of its (cancelling) result.
            scale = [t.cpu().numpy() for t in grad_term_magnitudes(
                torch, *args)]
            ok = all(bool(np.all(np.abs(kk - pp) <= atol + rtol * ss))
                     for kk, pp, ss in zip(k, p, scale))
            what = "of the sum of each entry's term magnitudes"
        else:
            ok = all(close(kk, pp, rtol, atol) for kk, pp in zip(k, p))
            what = "of the entry"
        require(ok, f"nn_distance_grad {label}: max abs err {err:.3e}")
        say("kernels", f"nn_distance_grad {label}: max_abs_err {err:.3e} "
            f"against the plain version on the card (rtol {rtol} {what}, "
            f"atol {atol}); bit-equal to the plain version on the CPU and "
            f"over two calls ok")
        return err

    errs["nn_distance_grad"] = chamfer_grad_case(
        clouds(rng, BATCH, NUM_POINT), clouds(rng, BATCH, NUM_POINT),
        f"B={BATCH} N=M={NUM_POINT}")
    chamfer_grad_case(clouds(rng, BATCH, NUM_POINT), clouds(rng, BATCH, 1000),
                      f"B={BATCH} N={NUM_POINT} M=1000")
    chamfer_grad_case(x1, x2, "ties B=4 N=467 M=1000")
    # Past one block's shared memory: the workspace goes to a scratch
    # buffer. Its own seed, so the cases above keep their inputs.
    big = np.random.RandomState(SEED + 4)
    words = ch.nn_distance_grad_scratch_words(1, 65536, 65536)
    require(words > 0, "B=1 N=M=65536 should need the scratch buffer")
    chamfer_grad_case(clouds(big, 1, 65536), clouds(big, 1, 65536),
                      f"B=1 N=M=65536 ({words} scratch words)", gen=big)
    # model_hierachy's center term: 64 centers against the label's points,
    # and the mirror image; one 256-query tile mostly masked, and long
    # segments in K2's sums (about 32 label points per center). Own seed.
    hier = np.random.RandomState(SEED + 8)
    for n, m in ((HIER_CENTERS, NUM_POINT), (NUM_POINT, HIER_CENTERS)):
        x1, x2 = clouds(hier, BATCH, n), clouds(hier, BATCH, m)
        chamfer_case(x1, x2, f"B={BATCH} N={n} M={m}")
        chamfer_grad_case(x1, x2, f"B={BATCH} N={n} M={m}", gen=hier,
                          long_segments=True)
    # PCN's fine Chamfer: B=32, N=M=16384, K1's query tiles combined over
    # many shapes and K2's workspace in its scratch buffer for each of
    # them; the plain version in row chunks of 512 (about 1 GiB a chunk).
    # Own seed.
    pcn = np.random.RandomState(SEED + 13)
    x1, x2 = clouds(pcn, BATCH, PCN_FINE), clouds(pcn, BATCH, PCN_FINE)
    chamfer_case(x1, x2, f"B={BATCH} N=M={PCN_FINE}",
                 plain=lambda a, b: nn_plain_chunked(torch, ch, a, b,
                                                     rows=512))
    words = ch.nn_distance_grad_scratch_words(BATCH, PCN_FINE, PCN_FINE)
    require(words > 0, f"B={BATCH} N=M={PCN_FINE} should need the scratch "
            f"buffer")
    chamfer_grad_case(x1, x2, f"B={BATCH} N=M={PCN_FINE} ({words} scratch "
                      f"words)", gen=pcn)
    return errs


def grad_term_magnitudes(torch, x1, x2, idx1, idx2, g1, g2):
    """Per entry of K2's (gx1, gx2), the sum of the magnitudes of the
    terms added into it: |t1[n]| + sum over m with idx2[m] = n of |t2[m]|,
    and the mirror image, for t1 = 2 g1 (x1 - x2[idx1]) and t2 = 2 g2 (x2 -
    x1[idx2])."""
    def rows(idx):
        return idx.long()[..., None].expand(-1, -1, 3)

    t1 = (2.0 * g1[..., None] * (x1 - torch.gather(x2, 1, rows(idx1)))).abs()
    t2 = (2.0 * g2[..., None] * (x2 - torch.gather(x1, 1, rows(idx2)))).abs()
    return (t1 + torch.zeros_like(x1).scatter_add_(1, rows(idx2), t2),
            t2 + torch.zeros_like(x2).scatter_add_(1, rows(idx1), t1))


def phase_emd_kernel(torch, em, rng) -> float:
    """K6 against its plain version at the EMD training path's shape and
    at N != M, ragged and coincident-point shapes; returns the main shape's
    max abs error."""
    dev = torch.device("cuda")

    def emd_case(x1, x2, label, f64=False):
        a = torch.from_numpy(x1).to(dev)
        b = torch.from_numpy(x2).to(dev)
        k = [t.cpu().numpy() for t in em.emd_forward_cuda(a, b)]
        again = [t.cpu().numpy() for t in em.emd_forward_cuda(a, b)]
        p = [t.cpu().numpy() for t in em.emd_forward_plain(a, b)]
        torch.cuda.synchronize()
        require(all(np.all(np.isfinite(t)) for t in k),
                f"emd {label}: non-finite output")
        require(all(np.array_equal(t, u) for t, u in zip(k, again)),
                f"emd {label}: two calls differ")
        cost_err, grad_err, entry = emd_gaps(k, p)
        require(cost_err <= EMD_COST_TOL and grad_err <= EMD_GRAD_TOL,
                f"emd {label}: cost error {cost_err:.3e} (tolerance "
                f"{EMD_COST_TOL}), gradient error norm {grad_err:.3e} "
                f"(tolerance {EMD_GRAD_TOL})")
        err = max(max_err(kk, pp) for kk, pp in zip(k, p))
        say("kernels", f"emd {label}: cost error {cost_err:.3e} of the "
            f"largest cost, gradient error norm {grad_err:.3e} (largest "
            f"entry {entry:.3e} of the largest gradient), max_abs_err "
            f"{err:.3e}; two calls bit-equal ok")
        if f64:
            # Both f32 evaluations against the plain version in float64.
            q = [t.cpu().numpy() for t in em.emd_forward_plain(
                a.double(), b.double())]
            kq, pq = emd_gaps(k, q), emd_gaps(p, q)
            say("kernels", f"emd {label} against the plain version in "
                f"float64 (cost, gradient error norm, largest entry): "
                f"kernel {kq[0]:.3e}, {kq[1]:.3e}, {kq[2]:.3e}; plain f32 "
                f"{pq[0]:.3e}, {pq[1]:.3e}, {pq[2]:.3e}")
            # The kernel's shortcuts (K from the next level's K squared
            # twice, exp2 flushing under 2^-126) may cost no more accuracy
            # than a plain f32 evaluation has.
            require(kq[0] <= EMD_F64_FACTOR * pq[0]
                    and kq[1] <= EMD_F64_FACTOR * pq[1],
                    f"emd {label}: the kernel is further from float64 than "
                    f"{EMD_F64_FACTOR}x the plain f32 version")
        return err

    err = emd_case(
        clouds(rng, BATCH, NUM_POINT), clouds(rng, BATCH, NUM_POINT),
        f"B={BATCH} N=M={NUM_POINT}", f64=True)
    emd_case(clouds(rng, BATCH, NUM_POINT), clouds(rng, BATCH, 1000),
             f"B={BATCH} N={NUM_POINT} M=1000")
    emd_case(clouds(rng, BATCH, 1000), clouds(rng, BATCH, NUM_POINT),
             f"B={BATCH} N=1000 M={NUM_POINT}")
    emd_case(clouds(rng, BATCH, NUM_POINT - 1), clouds(rng, BATCH, NUM_POINT),
             f"B={BATCH} N={NUM_POINT - 1} M={NUM_POINT}")
    emd_case(clouds(rng, 4, 37), clouds(rng, 4, 50), "B=4 N=37 M=50")
    # Coincident points (d2 = 0): half of xyz2 copies points of xyz1.
    x1 = clouds(rng, 4, 500)
    x2 = np.concatenate([x1[:, rng.permutation(500)[:250]],
                         clouds(rng, 4, 250)], axis=1)
    emd_case(x1, x2, "coincident B=4 N=M=500")

    # Large clouds: the kernel allocates its outputs and O(B (N + M))
    # scratch, whatever N * M is (the dense plain version holds about six
    # 1 GiB buffers here).
    b, n = 1, 16384
    x1, x2 = clouds(rng, b, n), clouds(rng, b, n)
    a, c = torch.from_numpy(x1).to(dev), torch.from_numpy(x2).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    em.emd_forward_cuda(a, c)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # cost (b), grads (3n + 3m), scratch (4n + 2m), here with m = n.
    want = 4 * b * (1 + 6 * n + 6 * n)
    require(peak <= want + 65536,
            f"emd B={b} N=M={n}: {peak} bytes allocated, outputs and "
            f"scratch are {want}")
    say("kernels", f"emd B={b} N=M={n}: {peak} bytes allocated during the "
        f"call (outputs and scratch {want})")
    emd_case(x1, x2, f"B={b} N=M={n}")
    # PCN's coarse EMD: the coarse cloud against the target's first 1024
    # points, B=32. Own seed.
    pcn = np.random.RandomState(SEED + 14)
    emd_case(clouds(pcn, BATCH, PCN_COARSE), clouds(pcn, BATCH, PCN_COARSE),
             f"B={BATCH} N=M={PCN_COARSE}")
    return err


# K7 at the training path's shapes: conv1-conv3 and conv4 at B=32 and
# B=128 (rows B·2048, C 64 and 128) and fc1/fc2 (B rows, C 1024).
BN_MAIN_SHAPES = ((65536, 64), (65536, 128), (262144, 64), (262144, 128),
                  (32, 1024), (128, 1024))
# K7 against its plain version in f32 on the card (a bf16 input upcast,
# exactly): (rtol, atol as a share of the plain version's largest
# element). The statistics sum in another order, and K7's output and dx
# round once to bf16 (at most 2^-8 of the value) or stay f32; the plain
# version, the autograd chain, rounds its f32 operations one by one.
BN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-4)}
BN_STAT_TOL = (1e-5, 1e-6)


def bn_inputs(torch, rng, rows, c, dtype):
    """y (rows, c) with per-channel offsets and scales, the output's
    cotangent g, gamma (a quarter negative), beta, moving statistics and a
    0-dim momentum, on the card."""
    dev = torch.device("cuda")
    y = (rng.randn(rows, c) * rng.uniform(0.2, 3.0, c)
         + rng.randn(c)).astype(np.float32)
    g = rng.randn(rows, c).astype(np.float32)
    gamma = ((1 + 0.5 * rng.rand(c))
             * np.where(rng.rand(c) < 0.25, -1, 1)).astype(np.float32)
    vec = [torch.from_numpy(a).to(dev) for a in (
        gamma, (0.1 * rng.randn(c)).astype(np.float32),
        (0.1 * rng.randn(c)).astype(np.float32),
        (1 + rng.rand(c)).astype(np.float32))]
    return (torch.from_numpy(y).to(dev, dtype),
            torch.from_numpy(g).to(dev, dtype), *vec,
            torch.full((), 0.7, device=dev))


def bn_close(torch, got, want, tol) -> float:
    """The largest |got - want| over (rtol |want| + atol max |want|);
    at most 1 within ``tol``."""
    got, want = got.detach().double(), want.detach().double()
    rtol, atol = tol
    scale = rtol * want.abs() + atol * float(want.abs().max()) + 1e-30
    return float(((got - want).abs() / scale).max())


def phase_batch_norm_kernel(torch, rng):
    """K7 (ops/batch_norm.py over csrc/batch_norm.cu) against its plain
    version in f32 on the card, bit-equal over two calls and under graph
    capture to eager. See the module docstring, phase 3b."""
    from pointnet_autoencoder_tpu_torch.ops import batch_norm as bn

    def run(y, g, gamma, beta, mov_mean, mov_var, mom, relu):
        mb, vb = mov_mean.clone(), mov_var.clone()
        out, moments = bn.batch_norm_fwd_cuda(y, gamma, beta, mb, vb, mom,
                                              EPS, relu)
        dy, dgamma, dbeta = bn.batch_norm_bwd_cuda(g, y, moments, gamma,
                                                   beta, EPS, relu)
        return out, moments, mb, vb, dy, dgamma, dbeta

    def case(rows, c, dtype, relu, graph=False, label=""):
        y, g, gamma, beta, mov_mean, mov_var, mom = bn_inputs(
            torch, rng, rows, c, dtype)
        got = run(y, g, gamma, beta, mov_mean, mov_var, mom, relu)
        again = run(y, g, gamma, beta, mov_mean, mov_var, mom, relu)
        tag = (f"K7 ({rows}, {c}) {str(dtype).split('.')[-1]} "
               f"{'relu' if relu else 'linear'}{label}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{tag}: two calls differ")
        pm, pv = mov_mean.clone(), mov_var.clone()
        yf = y.float()
        out_p, mom_p = bn.batch_norm_fwd_plain(yf, gamma, beta, pm, pv, mom,
                                               EPS, relu)
        out, moments, mb, vb, dy, dgamma, dbeta = got
        # The backward held on the kernel's ReLU mask (the plain backward
        # without the ReLU, on g behind that mask): a mask that the
        # kernel's backward recomputed otherwise would move whole elements
        # of dx.
        mask = out > 0 if relu else torch.ones_like(out, dtype=torch.bool)
        dy_p, dgamma_p, dbeta_p = bn.batch_norm_bwd_plain(
            torch.where(mask, g, torch.zeros_like(g)).float(), yf, mom_p,
            gamma, beta, EPS, False)
        torch.cuda.synchronize()
        tol = BN_TOL[str(dtype).split(".")[-1]]
        gaps = {"moments": bn_close(torch, moments, mom_p, BN_STAT_TOL),
                "moving mean": bn_close(torch, mb, pm, BN_STAT_TOL),
                "moving var": bn_close(torch, vb, pv, BN_STAT_TOL),
                "out": bn_close(torch, out, out_p, tol),
                "dx": bn_close(torch, dy, dy_p, tol),
                "dgamma": bn_close(torch, dgamma, dgamma_p, (1e-4, 1e-5)),
                "dbeta": bn_close(torch, dbeta, dbeta_p, (1e-4, 1e-5))}
        worst = max(gaps, key=gaps.get)
        require(gaps[worst] <= 1.0, f"{tag}: {worst} off by "
                f"{gaps[worst]:.3f} of its tolerance ({gaps})")
        flips = int(((out > 0) != (out_p > 0)).sum()) if relu else 0
        require(flips <= 1e-4 * out.numel(), f"{tag}: the plain version's "
                f"ReLU mask differs at {flips} of {out.numel()}")
        note = ""
        if graph:
            # Captured fwd + bwd on static inputs, replayed from the same
            # moving statistics: bit-equal to eager.
            static_mb, static_vb = mov_mean.clone(), mov_var.clone()

            def step():
                out, moments = bn.batch_norm_fwd_cuda(
                    y, gamma, beta, static_mb, static_vb, mom, EPS, relu)
                return (out, moments) + bn.batch_norm_bwd_cuda(
                    g, y, moments, gamma, beta, EPS, relu)

            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream().wait_stream(side)
            graph_ = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph_):
                outs = step()
            static_mb.copy_(mov_mean)
            static_vb.copy_(mov_var)
            graph_.replay()
            torch.cuda.synchronize()
            replayed = (outs[0], outs[1], static_mb, static_vb) + outs[2:]
            require(all(torch.equal(a, b) for a, b in zip(replayed, got)),
                    f"{tag}: the graph's replay differs from eager")
            note = ", a graph replay bit-equal to eager"
        say("batch_norm_kernel", f"{tag}: within its tolerances (largest "
            f"share {gaps[worst]:.3f}, {worst}), ReLU masks of the plain "
            f"version differing {flips}; two calls bit-equal{note} ok")

    for i, (rows, c) in enumerate(BN_MAIN_SHAPES):
        case(rows, c, torch.bfloat16, True, graph=i in (0, 4))
    case(65536, 64, torch.float32, True, graph=True)
    case(128, 1024, torch.float32, False)
    # Ragged rows, and channel counts that take one element a thread.
    case(65533, 64, torch.bfloat16, True, label=" (ragged rows)")
    case(1001, 36, torch.float32, True, label=" (ragged rows)")
    case(1001, 37, torch.float32, True, label=" (one element a thread)")
    case(517, 20, torch.bfloat16, False, label=" (one element a thread)")

    # An UpConv stage's channels-last 4-D activation (model_upconv's
    # upconv3 at B=32), a permuted view as ConvTranspose gives it, through
    # the autograd Function.
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.randn(32, 256, 10, 20).astype(np.float32)).to(
        dev, torch.bfloat16).permute(0, 2, 3, 1).requires_grad_()
    _, g, gamma, beta, mov_mean, mov_var, mom = bn_inputs(
        torch, rng, 32 * 10 * 20, 256, torch.bfloat16)
    gamma.requires_grad_()
    beta.requires_grad_()
    mb, vb = mov_mean.clone(), mov_var.clone()
    out = bn.batch_norm_train(x, gamma, beta, mb, vb, mom, EPS, relu=True)
    out.backward(g.reshape(out.shape))
    y2 = x.detach().contiguous().reshape(-1, 256).float()
    out_p, mom_p = bn.batch_norm_fwd_plain(y2, gamma.detach(), beta.detach(),
                                           mov_mean.clone(), mov_var.clone(),
                                           mom, EPS, True)
    mask = out.reshape(-1, 256) > 0
    dy_p, dgamma_p, dbeta_p = bn.batch_norm_bwd_plain(
        torch.where(mask, g, torch.zeros_like(g)).float(), y2, mom_p,
        gamma.detach(), beta.detach(), EPS, False)
    gaps = [bn_close(torch, out.reshape(-1, 256), out_p,
                     BN_TOL["bfloat16"]),
            bn_close(torch, x.grad.reshape(-1, 256), dy_p,
                     BN_TOL["bfloat16"]),
            bn_close(torch, gamma.grad, dgamma_p, (1e-4, 1e-5)),
            bn_close(torch, beta.grad, dbeta_p, (1e-4, 1e-5))]
    require(out.shape == x.shape and max(gaps) <= 1.0,
            f"K7 UpConv (32, 10, 20, 256) bf16: out, dx, dgamma, dbeta at "
            f"{gaps} of their tolerances")
    say("batch_norm_kernel", f"K7 UpConv (32, 10, 20, 256) bf16 relu, a "
        f"permuted view through the autograd Function: out, dx, dgamma, "
        f"dbeta within their tolerances (largest share {max(gaps):.3f}) ok")
    torch.cuda.empty_cache()


def batch_norm_timings(torch, rng):
    """K7's times at the main shapes, bf16 with the ReLU: each direction
    by CUDA events and by device time a call, beside its bound, the plain
    version's and F.batch_norm with F.relu's (the library yardstick, which
    the port never calls). Run after phase timings, so that its traces
    come first in the process (with K7's twelve traces first, K5's f32
    trace there lost two events in each of its six takes)."""
    from torch.nn import functional as F

    from pointnet_autoencoder_tpu_torch.ops import batch_norm as bn

    for rows, c in BN_MAIN_SHAPES:
        y, g, gamma, beta, mov_mean, mov_var, mom = bn_inputs(
            torch, rng, rows, c, torch.bfloat16)
        out, moments = bn.batch_norm_fwd_cuda(y, gamma, beta, mov_mean,
                                              mov_var, mom, EPS, True)

        def fwd():
            bn.batch_norm_fwd_cuda(y, gamma, beta, mov_mean, mov_var, mom,
                                   EPS, True)

        def bwd():
            bn.batch_norm_bwd_cuda(g, y, moments, gamma, beta, EPS, True)

        def plain():
            o, m = bn.batch_norm_fwd_plain(y, gamma, beta, mov_mean, mov_var,
                                           mom, EPS, True)
            bn.batch_norm_bwd_plain(g, y, m, gamma, beta, EPS, True)

        xl = y.detach().clone().requires_grad_()
        rm, rv = mov_mean.clone(), mov_var.clone()

        def library():
            o = F.relu(F.batch_norm(xl, rm, rv, gamma, beta, training=True,
                                    momentum=0.3, eps=EPS))
            torch.autograd.grad(o, xl, g)

        times = {}
        for name, fn in (("fwd", fwd), ("bwd", bwd)):
            dev_ms, counts = median_device_ms(torch, fn)
            require(len(counts) == 3, f"K7 {name} ({rows}, {c}): kernels "
                    f"{counts}, not 3")
            times[name] = (cuda_ms(torch, fn), dev_ms)
        try:
            lib = f"{cuda_ms(torch, library):.4f}"
        except RuntimeError as e:  # the library's own refusal
            lib = f"not measured ({type(e).__name__}: {str(e)[:80]})"
        kb = {k: bound(f"batch_norm_{k}", rows=rows, c=c, dtype="bf16")
              for k in ("fwd", "bwd")}
        say("batch_norm_kernel", f"K7 ({rows}, {c}) bf16 relu: fwd "
            f"{times['fwd'][0]:.4f} ms, dev {times['fwd'][1]:.5f}, bound "
            f"{kb['fwd']['bound_ms']:.5f} ({kb['fwd']['bound_by']}); bwd "
            f"{times['bwd'][0]:.4f} ms, dev {times['bwd'][1]:.5f}, bound "
            f"{kb['bwd']['bound_ms']:.5f} ({kb['bwd']['bound_by']}); plain "
            f"fwd + bwd {cuda_ms(torch, plain):.4f} ms; F.batch_norm + "
            f"F.relu fwd + bwd {lib} ms")
    torch.cuda.empty_cache()


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


def kernel_counters(ch, fe, fh, em):
    """Name -> the wrapper whose ``launches`` counts that kernel."""
    from pointnet_autoencoder_tpu_torch.ops import batch_norm as bn

    return {"fused_encoder_eval": fe.encoder_extrema_cuda,
            "nn_distance": ch.nn_distance_cuda,
            "fused_head_fwd": fh.head_max_cuda,
            "fused_head_bwd": fh.head_bwd_cuda,
            "nn_distance_grad": ch.nn_distance_grad_cuda,
            "emd_forward": em.emd_forward_cuda,
            "batch_norm_fwd": bn.batch_norm_fwd_cuda,
            "batch_norm_bwd": bn.batch_norm_bwd_cuda}


# The kernels each training path must launch (its eval epoch included):
# --model model trains on Chamfer (K1, K2) and --model model_emd on EMD
# (K6), reporting Chamfer without its gradient; both through K7.
MODEL_PATH_KERNELS = ("fused_encoder_eval", "nn_distance", "fused_head_fwd",
                      "fused_head_bwd", "nn_distance_grad", "batch_norm_fwd",
                      "batch_norm_bwd")
EMD_PATH_KERNELS = ("emd_forward", "fused_head_fwd", "fused_head_bwd",
                    "nn_distance", "fused_encoder_eval", "batch_norm_fwd",
                    "batch_norm_bwd")
# Each family's training BatchNorms a step: K7 forward and backward calls
# (conv1-conv4, the neck's and the decoder's; conv5's is K3/K4's).
TRAIN_BN_LAYERS = {"model": 6, "model_emd": 6, "model_cpu": 6,
                   "model_hierachy": 8, "model_upconv": 9,
                   "model_fc_upconv": 11}


def with_bn(want: dict, model: str, steps: int) -> dict:
    """``want`` with K7's launches in ``steps`` train steps of ``model``."""
    n = TRAIN_BN_LAYERS[model] * steps
    return dict(want, batch_norm_fwd=n, batch_norm_bwd=n)


def write_chair_fixture(tmp):
    """A fixture of 384 Chair shapes, 320 trainval (10 batches of 32) and
    64 test (2 batches); returns (its path, seconds to write it)."""
    from pointnet_autoencoder_tpu_torch.data import synthetic

    data = os.path.join(tmp, "chair")
    t0 = time.perf_counter()
    synthetic.write_fixture(data, shapes_per_category=384,
                            points_per_shape=NUM_POINT, seed=SEED,
                            categories=["Chair"])
    return data, time.perf_counter() - t0


def train_argv(model, data, log_dir):
    return ["--model", model, "--category", "Chair", "--num_point",
            str(NUM_POINT), "--batch_size", str(BATCH), "--no_rotation",
            "--device", "cuda", "--data_path", data, "--log_dir", log_dir,
            "--log_every", "5"]


def train_run(torch, counters, argv, required):
    """``TRAIN_EPOCHS`` epochs through ``cli.train``'s own build, with the
    launch counters zeroed before and read after. Requires every kernel in
    ``required`` to have launched, every step taken, finite losses and a
    best checkpoint. Returns a dict: trainer, logger (both left open),
    launches, train records, best loss, steps, seconds, best checkpoint."""
    from pointnet_autoencoder_tpu_torch.cli import train as cli_train

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer, logger = cli_train.build_trainer(cli_train.build_parser(
    ).parse_args(argv + ["--max_epoch", str(TRAIN_EPOCHS)]))
    best = trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: counters[name].launches for name in required}
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the training path never launched: {launches}")
    steps = trainer.state.step
    require(len(trainer.train_pipe) >= 10
            and steps == TRAIN_EPOCHS * len(trainer.train_pipe),
            f"{steps} steps in {TRAIN_EPOCHS} epochs of "
            f"{len(trainer.train_pipe)} batches")
    log_dir = trainer.config.log_dir
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["split"] == "train"]
    require(len(train) == steps // 5 and all(
        np.isfinite(r["loss"]) for r in recs), f"train records {recs}")
    bests = sorted(n for n in os.listdir(log_dir)
                   if n.startswith("best_model_epoch_"))
    require(bool(bests), f"no best checkpoint in {os.listdir(log_dir)}")
    return dict(trainer=trainer, logger=logger, launches=launches,
                train=train, test=[r for r in recs if r["split"] == "test"],
                best=best, steps=steps, seconds=seconds,
                best_path=os.path.join(log_dir, bests[-1]))


def phase_train(torch, counters, data, fixture_s, tmp, rng):
    """Train ``--model model`` through ``cli.train``'s own build; returns
    (trainer, logger, launches). The trainer stays open for the timings."""
    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.train import checkpoint

    log_dir = os.path.join(tmp, "train_log")
    argv = train_argv("model", data, log_dir)
    run = train_run(torch, counters, argv, MODEL_PATH_KERNELS)
    steps, launches = run["steps"], run["launches"]
    require(run["trainer"].input_mode == "device"
            and run["trainer"]._saver is not None,
            "the default run is not device input with background saves")
    pcloss = [r["pcloss"] for r in run["train"]]
    require(pcloss[-1] < pcloss[0], f"pcloss did not fall: {pcloss}")
    latest = checkpoint.CheckpointManager(log_dir).latest()
    stored = checkpoint.load(latest)

    resumed, rlogger = cli_train.build_trainer(cli_train.build_parser(
    ).parse_args(argv + ["--max_epoch", str(TRAIN_EPOCHS + 1), "--resume"]))
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
    session = InferenceSession("model", run["best_path"], NUM_POINT,
                               batch_size=BATCH, bf16=True, device="cuda")
    x = clouds(rng, BATCH, NUM_POINT)
    rec = session.reconstruct(x)
    require(rec.shape == x.shape and np.all(np.isfinite(rec)),
            "session on the best checkpoint")
    say("train", f"fixture of 384 Chair shapes written in {fixture_s:.1f} s; "
        f"{TRAIN_EPOCHS} epochs, {steps} steps in {run['seconds']:.1f} s "
        f"(data loading included); train pcloss by 5-step window "
        f"{[round(v, 6) for v in pcloss]}; best eval loss {run['best']:.6f} "
        f"in {os.path.basename(run['best_path'])}; resumed from "
        f"{os.path.basename(latest)} at epoch {resumed.start_epoch}, step "
        f"{resumed.state.step}; a session on the best reconstructs (chamfer "
        f"to input {float(session.chamfer(rec, x).mean()):.4f})")
    say("train", f"main-path launches {launches}")
    # Besides loss and pcloss (the forward), each leaf's gradient (the
    # backward through K2, K3's closed form and K4) and the new BN moving
    # statistics; on two batches, the second one where the CPU's own ReLU
    # masks fall otherwise at near-zero inputs.
    step_card_vs_cpu(torch, argv, tmp, x, "train")
    step_card_vs_cpu(torch, argv, tmp, clouds(
        np.random.RandomState(SEED + 3), BATCH, NUM_POINT), "train")
    assemble_card_vs_cpu(torch, run["trainer"])
    return run["trainer"], run["logger"], launches, run["best_path"]


def assemble_card_vs_cpu(torch, trainer):
    """Device input's batch assembly (gather, resample, rotation about Y)
    on the card against the CPU's, on the same (idxs, u, angles) from the
    trained trainer's dataset on the card: bit for bit, at B=32, N=2048."""
    from pointnet_autoencoder_tpu_torch.data import device_pipeline as dp

    dd = trainer.train_device
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    idxs = torch.randint(0, dd.num_shapes, (BATCH,), generator=gen,
                         device="cuda")
    u, angles = dp.draw(gen, BATCH, NUM_POINT, rotate=True)
    card = dp.assemble_from(dd.data, dd.lengths, idxs, u, angles)
    cpu = dp.assemble_from(dd.data.cpu(), dd.lengths.cpu(), idxs.cpu(),
                           u.cpu(), angles.cpu())
    require(card.shape == (BATCH, NUM_POINT, 3)
            and torch.equal(card.cpu(), cpu),
            f"assemble_from card vs CPU: max abs err "
            f"{max_err(card.cpu().numpy(), cpu.numpy()):.3e}")
    say("train", f"device input: {dd.num_shapes} shapes on the card "
        f"({dd.nbytes() / 1e6:.2f} MB); assemble_from at B={BATCH} "
        f"N={NUM_POINT} with rotation equals the CPU's bit for bit ok")


def phase_train_emd(torch, counters, data, tmp, rng):
    """Train ``--model model_emd`` through ``cli.train``'s own build on the
    same fixture; returns (trainer, logger, launches). The trainer stays
    open for the timings."""
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession

    argv = train_argv("model_emd", data, os.path.join(tmp, "emd_log"))
    run = train_run(torch, counters, argv, EMD_PATH_KERNELS)
    loss = [r["loss"] for r in run["train"]]
    require(loss[-1] < loss[0], f"the EMD loss did not fall: {loss}")
    session = InferenceSession("model_emd", run["best_path"], NUM_POINT,
                               batch_size=BATCH, bf16=True, device="cuda")
    x = clouds(rng, BATCH, NUM_POINT)
    rec = session.reconstruct(x)
    require(rec.shape == x.shape and np.all(np.isfinite(rec)),
            "model_emd session on the best checkpoint")
    say("train_emd", f"{TRAIN_EPOCHS} epochs, {run['steps']} steps in "
        f"{run['seconds']:.1f} s (data loading included); train EMD loss "
        f"by 5-step window {[round(v, 4) for v in loss]}, pcloss "
        f"{[round(r['pcloss'], 6) for r in run['train']]}; best eval loss "
        f"{run['best']:.4f} in {os.path.basename(run['best_path'])}; a "
        f"model_emd session on the best reconstructs (chamfer to input "
        f"{float(session.chamfer(rec, x).mean()):.4f})")
    say("train_emd", f"main-path launches {run['launches']}")
    # The CPU's dense EMD keeps about six (B, N, M) buffers: B=8 keeps its
    # step to seconds. Besides loss and pcloss, each leaf's gradient (the
    # backward from K6's gradients through K3's closed form and K4) and
    # the new BN moving statistics.
    step_card_vs_cpu(torch, argv, tmp, x[:EMD_STEP_BATCH], "train_emd")
    return run["trainer"], run["logger"], run["launches"]


# The other --model families and the Chamfer kernel calls each one's loss
# makes per batch: model_cpu's loss is the dense Chamfer on every device
# (no kernel), model_hierachy's adds its 64 centers against the label.
FAMILY_CHAMFER_CALLS = {"model_cpu": 0, "model_hierachy": 2,
                        "model_upconv": 1, "model_fc_upconv": 1}
# The batch of a family's f32 card-vs-CPU step, as model_emd's
# (EMD_STEP_BATCH): it keeps the two CPU steps short.
FAMILY_STEP_BATCH = 8


# The launches of one pcn_emd train step: K6 on the coarse cloud, K1 and
# K2 on the fine one, none of PointNet's kernels.
PCN_STEP_LAUNCHES = {"nn_distance": 1, "nn_distance_grad": 1,
                     "emd_forward": 1}


def phase_pcn_emd(torch, counters):
    """``--model pcn_emd`` at its published widths and the cell's shapes,
    bf16, through ``make_step_fns``' captured step: each call's launches
    (the eager first call, the capturing call, a replay) and a traced
    replay's kernels. See the module docstring, phase 9b."""
    from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
    from pointnet_autoencoder_tpu_torch.train import schedules
    from pointnet_autoencoder_tpu_torch.train.loop import make_step_fns
    from pointnet_autoencoder_tpu_torch.train.state import (PairedBatch,
                                                            TrainState,
                                                            make_optimizer)

    dev = torch.device("cuda")
    model = get_model_spec("pcn_emd").make(
        NUM_POINT, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(SEED + 15)).to(dev)
    state = TrainState(model, make_optimizer("adam", model.parameters()),
                       schedules.Staircase(1e-4, 0.7, 1, 50000, floor=1e-6),
                       step=50001)
    step, _ = make_step_fns(state, "pcn_emd",
                            schedules.bn_momentum_schedule(BATCH, 50000))
    gen = torch.Generator(dev).manual_seed(SEED + 15)
    pairs = []
    for _ in range(3):
        target = 0.5 * torch.randn(BATCH, PCN_FINE, 3, generator=gen,
                                   device=dev)
        pairs.append(PairedBatch(target[:, :NUM_POINT].contiguous(), target))

    def launches(pair):
        for c in counters.values():
            c.launches = 0
        loss = float(step(pair)["loss"])
        require(np.isfinite(loss), f"pcn_emd: loss {loss}")
        return {k: c.launches for k, c in counters.items() if c.launches}

    # A replay counts its program's launches, as captured.
    for label, pair in zip(("eager", "capturing", "replayed"), pairs):
        got = launches(pair)
        require(got == PCN_STEP_LAUNCHES, f"pcn_emd {label} call: "
                f"launches {got}, the step's are {PCN_STEP_LAUNCHES}")
    want = dict(dict.fromkeys(COUNTER_KERNELS, 0), **PCN_STEP_LAUNCHES)

    def replay():
        step(pairs[2])["loss"].item()

    t = overhead_trace(torch, replay, "pcn_emd_step",
                       accept=lambda t: trace_launches(t["own"]) == want)
    seen = trace_launches(t["own"])
    require(seen == want and t["graph_launches"] == 1,
            f"pcn_emd traced replay: kernels {seen}, graph launches "
            f"{t['graph_launches']}; the step's are {want} in one graph")
    require(step.programs.replays == 2 + 3, f"pcn_emd: "
            f"{step.programs.replays} replays of the captured step, not 5")
    step.programs.close()
    say("pcn_emd", f"B={BATCH} {NUM_POINT} -> {PCN_COARSE} + {PCN_FINE} "
        f"points: one K1, K2 and K6 launch each in the eager, the "
        f"capturing and a replayed call; a traced replay "
        f"{_overhead_str(t)}, its kernels {seen} ok")


def phase_families(torch, counters, data, tmp, gen):
    """Each of the other --model families through ``cli.train``'s own
    build on the Chair fixture, bf16: finite losses, a falling eval
    pcloss, a best checkpoint, and every kernel launched exactly as often
    as its path needs (K3 and K4 once per step, K5 once per eval batch,
    K1 per Chamfer call of each batch, K2 per Chamfer call of each step,
    K6 never). Then a bf16 session on the best checkpoint (reconstruct,
    embed and decode at B=32), the host median and a trace of one bf16
    train step, and, but for model_cpu, which has no kernel in its loss,
    one f32 step on the card against the CPU's."""
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
    from pointnet_autoencoder_tpu_torch.train.loop import cudnn_deterministic

    x = clouds(gen, BATCH, NUM_POINT)
    tb = torch.from_numpy(clouds(gen, BATCH, NUM_POINT)).to("cuda")
    for name, calls in FAMILY_CHAMFER_CALLS.items():
        # Host input (the pipeline thread and pinned copies): the card's
        # one run of that mode; phases 6 and 7 run the default, device
        # input.
        argv = train_argv(name, data, os.path.join(tmp, f"{name}_log")) + [
            "--input_mode", "host"]
        required = ("fused_head_fwd", "fused_head_bwd", "fused_encoder_eval")
        if calls:
            required += ("nn_distance", "nn_distance_grad")
        run = train_run(torch, counters, argv, required)
        launches = {k: fn.launches for k, fn in counters.items()}
        trainer, logger = run["trainer"], run["logger"]
        require(trainer.input_mode == "host", f"{name}: not host input")
        try:
            steps = run["steps"]
            evals = TRAIN_EPOCHS * len(trainer.eval_pipe)
            want = with_bn(dict(
                fused_encoder_eval=evals, nn_distance=calls * (steps + evals),
                fused_head_fwd=steps, fused_head_bwd=steps,
                nn_distance_grad=calls * steps, emd_forward=0), name, steps)
            require(launches == want, f"{name}: launches {launches}, the "
                    f"path needs {want}")
            pcloss = [r["pcloss"] for r in run["test"]]
            require(len(pcloss) == TRAIN_EPOCHS and pcloss[-1] < pcloss[0],
                    f"{name}: eval pcloss did not fall: {pcloss}")
            session = InferenceSession(name, run["best_path"], NUM_POINT,
                                       batch_size=BATCH, bf16=True,
                                       device="cuda")
            rec, emb = session.reconstruct(x), session.embed(x)
            dec = session.decode(emb)
            neck = get_model_spec(name).neck
            require(rec.shape == x.shape and emb.shape == (
                BATCH, neck[-1] if neck else 1024) and bool(
                    np.all(np.isfinite(rec)) and np.all(np.isfinite(emb))),
                    f"{name} session: shapes {rec.shape} {emb.shape}")
            require(close(dec, rec, 1e-6, 1e-6), f"{name} session: "
                    f"decode(embed(x)) != reconstruct(x): "
                    f"{max_err(dec, rec):.3e}")
            extra = (f", pc1loss {[round(r['pc1loss'], 6) for r in run['test']]}"
                     if name == "model_hierachy" else "")
            say("families", f"{name}: {TRAIN_EPOCHS} epochs, {steps} steps "
                f"in {run['seconds']:.1f} s (data loading included); eval "
                f"pcloss by epoch {[round(v, 6) for v in pcloss]}{extra}; "
                f"best eval loss {run['best']:.4f} in "
                f"{os.path.basename(run['best_path'])}; a bf16 session on it "
                f"reconstructs, embeds ({emb.shape[1]}-d) and decodes "
                f"{BATCH} shapes, decode(embed(x)) == reconstruct(x) "
                f"(chamfer to input "
                f"{float(session.chamfer(rec, x).mean()):.4f})")
            say("families", f"{name}: main-path launches {launches} "
                f"({steps} steps, {evals} eval batches, {calls} Chamfer "
                f"calls per batch) ok")

            med, lo, hi, trace = step_timing(
                torch, trainer, tb, f"chip_smoke.{name}.train_step")
            say("families", f"{name} train step, bf16, B={BATCH} "
                f"N={NUM_POINT} (host clock, to the loss on the host): median "
                f"{med:.3f} ms, min {lo:.3f}, max {hi:.3f}")
            say("families", f"{name} train step traced: {trace}")
            if "upconv" in name:
                # What the point-parallel step's setting costs the
                # transposed convolutions.
                with cudnn_deterministic():
                    med, lo, hi, trace = step_timing(
                        torch, trainer, tb,
                        f"chip_smoke.{name}.train_step_deterministic")
                say("families", f"{name} train step with cuDNN "
                    f"deterministic (as under --point_parallel): median "
                    f"{med:.3f} ms, min {lo:.3f}, max {hi:.3f}; traced: "
                    f"{trace}")
        finally:
            trainer.close()
            logger.close()
        if calls:
            step_card_vs_cpu(torch, argv, os.path.join(tmp, name),
                             x[:FAMILY_STEP_BATCH], "families")


def step_card_vs_cpu(torch, argv, tmp, x, phase):
    """One f32 step on the card and the same step on the CPU: same seed, so
    the same initial weights, and the same batch ``x``. Holds loss, pcloss,
    each leaf's gradient and the new BN moving statistics. The CPU step
    takes the card's discrete choices (see shared_choices), so the two
    differ in rounding only. A third step, on the CPU with its own ReLU
    masks, is reported and not held: it shows what the shared masks
    remove."""
    from pointnet_autoencoder_tpu_torch.cli import train as cli_train

    parser = cli_train.build_parser()
    steps_out, choices = [], {}
    for run, device, masks in ((0, "cuda", True), (1, "cpu", True),
                               (2, "cpu", False)):
        # Host input: the step is fed x, and a host-input Trainer decodes
        # no shape until a batch is asked for.
        tr, lg = cli_train.build_trainer(parser.parse_args(
            argv + ["--no-bf16", "--input_mode", "host", "--device", device,
                    "--log_dir",
                    os.path.join(tmp, f"{phase}_step_{run}")]))
        store = choices if run < 2 else dict(
            choices, differed=0, made=0, relu_differed=0, relu_made=0)
        try:
            with shared_choices(store, replay=run > 0, masks=masks):
                m = tr.train_step(torch.from_numpy(x).to(tr.device))
            steps_out.append((
                {k: float(v) for k, v in m.items()},
                {n: p.grad.double().cpu().numpy()
                 for n, p in tr.model.named_parameters()},
                {n: b.cpu().numpy() for n, b in tr.model.named_buffers()}))
        finally:
            tr.close()
            lg.close()
    (gpu, ggrads, gbufs), (cpu, cgrads, cbufs), (_, ograds, _) = steps_out
    for key in ("loss", "pcloss"):
        require(close(np.float64(gpu[key]), np.float64(cpu[key]), 1e-4, 0.0),
                f"train step {key}: card {gpu[key]} vs CPU {cpu[key]}")
    # A choice differs only at a near-tie; the kernels' own checks above
    # hold the choices at clear margins.
    for what, key in (("argmin/argmax", "differed"), ("ReLU", "relu_differed")):
        made = choices[key.replace("differed", "made")]
        require(choices[key] <= 1e-3 * made,
                f"train step: the CPU chose otherwise at {choices[key]} of "
                f"{made} {what} choices")
    emd_note = ""
    if "emd_gaps" in choices:
        # K6 against its plain version on the card, on the step's own
        # (label, prediction): the kernel's error on these inputs. The
        # CPU's own EMD, on its own rounding of the prediction, adds what
        # that rounding moves.
        for what, (cost_err, grad_err, entry) in (
                ("K6 against the plain version on the card's inputs",
                 choices["emd_kernel_gaps"]),
                ("the CPU's own EMD against K6 (replaced by K6's)",
                 choices["emd_gaps"])):
            require(cost_err <= EMD_COST_TOL and grad_err <= EMD_GRAD_TOL,
                    f"train step EMD, {what}: cost error {cost_err:.3e} "
                    f"(tolerance {EMD_COST_TOL}), gradient error norm "
                    f"{grad_err:.3e} (tolerance {EMD_GRAD_TOL})")
            emd_note += (f"; {what}: cost error {cost_err:.3e}, gradient "
                         f"error norm {grad_err:.3e}, largest entry "
                         f"{entry:.3e}")
        emd_note += f" (tolerances {EMD_COST_TOL}, {EMD_GRAD_TOL})"
    gaps, noise = grad_gaps(ggrads, cgrads)
    worst, worst_name = gaps[0]
    require(worst < GRAD_REL_TOL,
            f"train step gradient of {worst_name}: relative error norm "
            f"{worst:.3e} over {GRAD_REL_TOL}")
    own, _ = grad_gaps(ggrads, ograds, hold=False)
    # A BN beta's gradient is a batch sum that the next training BN makes
    # zero in exact arithmetic on a channel whose ReLU passes every row (of
    # a (B, C), (B, N, C) or (B, H, W, C) activation).
    rows = [m.reshape(-1, m.shape[-1]) for m in choices["relu"]]
    all_on = sum(int(m.all(dim=0).sum()) for m in rows)
    buf_err = max(max_err(gbufs[n], cbufs[n]) for n in cbufs)
    require(all(close(gbufs[n], cbufs[n], 1e-4, 1e-5) for n in cbufs),
            f"train step BN moving statistics: max abs err {buf_err:.3e}")
    say(phase, f"one f32 step at B={len(x)}, card vs CPU: loss "
        f"{gpu['loss']:.6f} vs {cpu['loss']:.6f} (rtol 1e-4); the CPU's own "
        f"argmin/argmax differed at {choices['differed']} of "
        f"{choices['made']} choices and its own ReLU masks at "
        f"{choices['relu_differed']} of {choices['relu_made']} (replaced by "
        f"the card's); relative gradient error norm, largest three: "
        + ", ".join(f"{n} {r:.3e}" for r, n in gaps[:3])
        + f" (tolerance {GRAD_REL_TOL}); with the CPU's own ReLU masks "
        f"(not held): " + ", ".join(f"{n} {r:.3e}" for r, n in own[:3])
        + f"; ReLU channels active on every row: {all_on} of "
        f"{sum(m.shape[1] for m in rows)}; {len(noise)} leaves zero in "
        f"exact arithmetic read under 1e-5 "
        f"of the gradient's norm on both sides; BN moving statistics max "
        f"abs err {buf_err:.3e} (rtol 1e-4, atol 1e-5){emd_note} ok")


@contextlib.contextmanager
def shared_choices(store: dict, replay: bool, masks: bool = True):
    """Within the block, the discrete choices of a train step's forward
    (the Chamfer argmins, the head's argmax, every ReLU mask) are recorded
    from the card's run into ``store``; with ``replay``, the CPU's run
    takes the recorded choices in place of its own, counting in
    ``store["differed"]`` (``store["relu_differed"]`` for the masks) where
    its own differed. A near-tie can fall either way under different
    rounding, and one changed choice moves a whole row of a gradient: a
    ReLU input within a few 1e-6 of zero that falls the other way moves
    the batch sums of every BN beta and gamma behind it by up to a few
    percent. Sharing the choices leaves rounding as the only difference
    between the two steps' gradients. ``masks=False`` replays the argmins
    and argmaxes but lets the CPU keep its own ReLU masks (still counted).

    The EMD's outputs (cost, grad1, grad2) are shared the same way:
    ``store["emd_kernel_gaps"]`` gets K6 against its plain version on the
    card's own inputs, and ``store["emd_gaps"]`` the CPU's own EMD against
    K6's (see emd_gaps): at level -4^7 the matching turns on differences
    of d2 in the last bits, so the two forwards' rounding of the
    prediction moves the plan itself."""
    from pointnet_autoencoder_tpu_torch.nn import layers
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    nn_name = "nn_distance_plain" if replay else "nn_distance_cuda"
    head_name = "head_max_plain" if replay else "head_max_cuda"
    emd_name = "emd_forward_plain" if replay else "emd_forward_cuda"
    nn_fn, head_fn = getattr(ch, nn_name), getattr(fh, head_name)
    emd_fn, emd_plain = getattr(em, emd_name), em.emd_forward_plain
    functional = layers.F
    for key in ("differed", "made", "relu_differed", "relu_made"):
        store.setdefault(key, 0)
    if not replay:
        store["relu"] = []
        store["taken"] = {}
    relu_calls = []
    taken = {}

    def take(key, own):
        """The card's choice at this call of ``key`` (a loss may call the
        Chamfer more than once per step): recorded, or replayed in call
        order."""
        if not replay:
            store["taken"].setdefault(key, []).append(own.cpu())
            return own
        calls = taken.setdefault(key, [])
        card = store["taken"][key][len(calls)].to(own.device, own.dtype)
        calls.append(None)
        store["differed"] += int((own != card).sum())
        store["made"] += own.numel()
        return card

    def nn(a, b):
        d1, i1, d2, i2 = nn_fn(a, b)
        return d1, take("idx1", i1), d2, take("idx2", i2)

    def head(x, w, scale, shift):
        maxout, argmax = head_fn(x, w, scale, shift)
        return maxout, take("argmax", argmax)

    def emd(x1, x2):
        own = emd_fn(x1, x2)
        if not replay:
            store["emd"] = [t.cpu() for t in own]
            plain = emd_plain(x1, x2)
            store["emd_kernel_gaps"] = emd_gaps(
                [t.cpu().numpy() for t in own],
                [t.cpu().numpy() for t in plain])
            return own
        store["emd_gaps"] = emd_gaps([t.numpy() for t in own],
                                     [t.numpy() for t in store["emd"]])
        return tuple(t.to(own[0].device) for t in store["emd"])

    def relu(x):
        mask = x > 0
        if not replay:
            store["relu"].append(mask.cpu())
            return functional.relu(x)
        card = store["relu"][len(relu_calls)].to(x.device)
        relu_calls.append(None)
        store["relu_differed"] += int((mask != card).sum())
        store["relu_made"] += mask.numel()
        return x * card.to(x.dtype) if masks else functional.relu(x)

    # A kernel wrapper counts its launches on the function its module's
    # name holds: the stand-in carries the count meanwhile.
    patched = ((ch, nn_name, nn_fn, nn), (fh, head_name, head_fn, head),
               (em, emd_name, emd_fn, emd))
    for mod, name, fn, stand_in in patched:
        stand_in.launches = getattr(fn, "launches", 0)
        setattr(mod, name, stand_in)
    try:
        with relu_through(relu):
            yield
    finally:
        for mod, name, fn, stand_in in patched:
            setattr(mod, name, fn)
            if hasattr(fn, "launches"):
                fn.launches = stand_in.launches


@contextlib.contextmanager
def relu_through(relu):
    """Within the block, every ReLU of the layers is ``relu``: the one a
    training BatchNorm fuses (``ops/batch_norm.batch_norm_train`` runs
    without it, K7 on the card, then ``relu`` takes its output; in f32
    the same values as the fused ReLU) and ``nn/layers``' ``F.relu`` (a
    layer without BN, and eval)."""
    from pointnet_autoencoder_tpu_torch.nn import layers
    from pointnet_autoencoder_tpu_torch.ops import batch_norm as bn_op

    functional, real = layers.F, bn_op.batch_norm_train

    def bn(x, *args, relu_on=False, **kw):
        y = real(x, *args, relu=False, **kw)
        return relu(y) if relu_on else y

    stand_in_f = types.SimpleNamespace(**vars(functional))
    stand_in_f.relu = relu
    layers.F = stand_in_f
    bn_op.batch_norm_train = (
        lambda x, *args, relu=False, **kw: bn(x, *args, relu_on=relu, **kw))
    try:
        yield
    finally:
        layers.F = functional
        bn_op.batch_norm_train = real


def grad_gaps(got: dict, want: dict, hold: bool = True):
    """Each leaf's ||got - want|| / ||want||, as a list of (value, leaf),
    largest first, and the leaves left out. The biases before a training
    BN (and conv5's beta, which fc1's BN cancels) have a gradient that is
    zero in exact arithmetic: with ``hold``, both sides must read under
    1e-5 of the whole gradient's norm, and they are not held by a relative
    error."""
    total = np.sqrt(sum(float(np.sum(g * g)) for g in want.values()))
    gaps, noise = [], []
    for name, w in want.items():
        g = got[name]
        if np.linalg.norm(w) < 1e-5 * total:
            require(not hold or np.linalg.norm(g) < 1e-5 * total,
                    f"train step gradient of {name}: norm "
                    f"{np.linalg.norm(g):.3e} where the CPU's is rounding "
                    f"noise ({np.linalg.norm(w):.3e})")
            noise.append(name)
            continue
        gaps.append((float(np.linalg.norm(g - w) / np.linalg.norm(w)), name))
    return sorted(gaps, reverse=True), noise


# cli.test: 16 shapes, 4 decoder groups, F-score on: three renders per
# shape. K1 launches per shape: one for ``chamfer`` and one for ``fscore``
# (each calls nn_distance once on its (1, N, 3) pair); K5 one per
# ``reconstruct`` (the session's eval encoder at B=1).
CLI_TEST_SHAPES = 16
CLI_TEST_GROUPS = 4
CLI_TEST_K1_PER_SHAPE = 2


def phase_cli_test(torch, counters, fe, ch, data, best_path, tmp, rng):
    """``cli.test.main`` on the card on the train phase's best checkpoint:
    exact K5 and K1 launch counts, each shape's Chamfer held to the same
    command on the CPU (rtol 1e-5), 48 renders, the native image of the
    first shape against ``_render_numpy`` (fewer than 1% of pixels off by
    more than 2, tests/test_viz.py's tolerance), shapes per second; then
    the device time per call of K5 f32 and K1 at B=1, this path's shape."""
    import io

    from pointnet_autoencoder_tpu_torch.cli import test as cli_test
    from pointnet_autoencoder_tpu_torch.data.shapenet_part import PartDataset
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.viz import render

    t_phase = time.perf_counter()
    argv = ["--model", "model", "--model_path", best_path, "--category",
            "Chair", "--num_point", str(NUM_POINT), "--data_path", data,
            "--num_shapes", str(CLI_TEST_SHAPES), "--num_group",
            str(CLI_TEST_GROUPS), "--fscore_threshold", "0.01"]
    out = {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            for fn in counters.values():
                fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            out[device] = cli_test.main(argv + [
                "--out_dir", os.path.join(tmp, f"renders_{device}"),
                "--device", device])
        out[device]["seconds"] = time.perf_counter() - t0
        out[device]["text"] = text.getvalue()
        if device == "cuda":
            launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: 0 for k in counters}
    want.update(fused_encoder_eval=CLI_TEST_SHAPES,
                nn_distance=CLI_TEST_K1_PER_SHAPE * CLI_TEST_SHAPES)
    require(launches == want, f"cli_test launches {launches}, the path "
            f"needs {want}")
    card, cpu = out["cuda"], out["cpu"]
    require(card["indices"] == cpu["indices"]
            and len(card["chamfer"]) == CLI_TEST_SHAPES,
            f"shape orders {card['indices']} vs {cpu['indices']}")
    cd, cd_cpu = np.array(card["chamfer"]), np.array(cpu["chamfer"])
    require(bool(np.all(np.isfinite(cd))) and close(cd, cd_cpu, 1e-5, 0.0),
            f"cli_test chamfer card vs CPU: {cd} vs {cd_cpu}")
    files = sorted(os.listdir(card["out_dir"]))
    require(len(files) == 3 * CLI_TEST_SHAPES
            and files == sorted(os.listdir(cpu["out_dir"])),
            f"{len(files)} renders: {files[:6]}")
    # The first shape's ground truth, drawn again by the plain version: a
    # fresh test split of the same seed resamples it the same way.
    dataset = PartDataset(data, npoints=NUM_POINT, class_choice=["Chair"],
                          split="test", seed=0)
    first, _ = dataset[card["indices"][0]]
    plain = render._render_numpy(
        np.zeros((800, 800, 3), np.uint8), render.project(first, 800),
        np.full((NUM_POINT, 3), 255.0, np.float32), 8)
    path = os.path.join(card["out_dir"], files[0])
    try:
        from PIL import Image

        native = np.asarray(Image.open(path))
    except ImportError:
        native = render.render_points(first, ballradius=8)
    off = float((np.abs(native.astype(int) - plain.astype(int)) > 2).mean())
    require(native.shape == plain.shape and off < 0.01,
            f"native render vs _render_numpy: {off:.4f} of pixels off by "
            f"more than 2")
    say("cli_test", f"{CLI_TEST_SHAPES} shapes on the card in "
        f"{card['seconds']:.2f} s ({CLI_TEST_SHAPES / card['seconds']:.2f} "
        f"shapes/s: session load, dataset, reconstruct, chamfer, fscore and "
        f"{len(files)} 800x800 renders), on the CPU in {cpu['seconds']:.2f} "
        f"s; launches {launches} (K5 1 and K1 {CLI_TEST_K1_PER_SHAPE} per "
        f"shape) ok; chamfer mean {cd.mean():.6f}, max rel err vs CPU "
        f"{float(np.max(np.abs(cd - cd_cpu) / np.abs(cd_cpu))):.2e} (rtol "
        f"1e-5); {files[0]} native vs _render_numpy: {off:.5f} of pixels off "
        f"by more than 2 (under 0.01) ok")
    say("cli_test", "last lines: " + " | ".join(
        card["text"].strip().splitlines()[-3:]))

    # K5 f32 and K1 at B=1, N=M=2048: device time per call, each with its
    # bound (K5's is its B=32 bound over 32; K1's as in phase timings).
    session = InferenceSession("model", best_path, NUM_POINT, batch_size=1,
                               device="cuda")
    chain = session.model.encoder.fold()
    p1 = torch.from_numpy(clouds(rng, 1, NUM_POINT)).to("cuda")
    p2 = torch.from_numpy(clouds(rng, 1, NUM_POINT)).to("cuda")
    k5_bound = bound("fused_encoder_eval", b=1, n=NUM_POINT, dtype="f32")
    k1_bound = bound("nn_distance", b=1, n=NUM_POINT, m=NUM_POINT)
    for what, fn, b in (
            ("fused_encoder_eval f32", lambda: fe.encoder_extrema_cuda(
                p1, chain), k5_bound),
            ("nn_distance", lambda: ch.nn_distance_cuda(p1, p2), k1_bound)):
        dev_ms, counts = median_device_ms(torch, fn)
        say("cli_test", f"{what} B=1 N={NUM_POINT} (cli.test's shape): "
            f"device time per call, median of 50 traced calls: "
            f"{dev_ms:.5f} ms ({_event_counts(counts)}); bound "
            f"{b['bound_ms']:.5f} ms ({b['bound_by']})")
    say("cli_test", f"phase took {time.perf_counter() - t_phase:.1f} s")


def phase_export_import(torch, best_path, tmp, rng):
    """``cli.export --format reference_npz`` of the best checkpoint, then
    ``cli.import_tf`` on it (a dry run reading ``unmapped: []``, then
    ``--out``), and ``cli.export --format bundle``: a session opened from
    each bundle on the card reconstructs a B=32 batch bit-equal to the
    session opened on the checkpoint."""
    import io

    from pointnet_autoencoder_tpu_torch.cli import export as cli_export
    from pointnet_autoencoder_tpu_torch.cli import import_tf as cli_import
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession

    t0 = time.perf_counter()
    base = ["--model", "model", "--model_path", best_path, "--num_point",
            str(NUM_POINT), "--device", "cuda"]
    imp = ["--model", "model", "--num_point", str(NUM_POINT)]
    with contextlib.redirect_stdout(io.StringIO()):
        npz = cli_export.main(base + ["--out", os.path.join(tmp, "ref"),
                                      "--format", "reference_npz"])
        dry = cli_import.main(imp + ["--tf_checkpoint", npz])
        report = cli_import.main(imp + ["--tf_checkpoint", npz, "--out",
                                        os.path.join(tmp, "imported")])
        bundle = cli_export.main(base + ["--out", os.path.join(tmp,
                                                               "bundle")])
    require(dry["unmapped"] == [] and "bundle" not in dry,
            f"dry run report {dry}")
    x = clouds(rng, BATCH, NUM_POINT)
    want = InferenceSession("model", best_path, NUM_POINT, batch_size=BATCH,
                            device="cuda").reconstruct(x)
    for what, path in (("cli.import_tf --out", report["bundle"]),
                       ("cli.export --format bundle", bundle)):
        got = InferenceSession.from_bundle(path, batch_size=BATCH,
                                           device="cuda").reconstruct(x)
        require(np.array_equal(got, want),
                f"{what}: reconstruction differs from the checkpoint's: "
                f"{max_err(got, want):.3e}")
    say("export_import", f"reference_npz ({os.path.getsize(npz) / 1e6:.1f} "
        f"MB), dry run mapped {dry['mapped']} unmapped {dry['unmapped']}, "
        f"both bundles reconstruct {BATCH} shapes bit-equal to the "
        f"checkpoint's session ok; {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase data_parallel: 2 ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_STEP_MODELS = ("model", "model_emd")
# The all-reduces of one data-parallel `model` step: conv1-4's BN, the
# head's statistics, fc1's and fc2's BN, forward and backward, and the
# gradients.
DP_MODEL_COLLECTIVES = 15


@contextlib.contextmanager
def dp_choices(store: dict, replay: bool, rows=slice(None), cols=None):
    """Within the block, a train step's discrete choices on the card (the
    Chamfer argmins, the head's argmax, every ReLU mask) and K6's outputs
    are recorded into ``store`` (the one-device step on the global batch)
    or, with ``replay``, replayed from it on ``rows`` of that batch (a
    rank's step, or the same batch in another order), counting in
    ``store["differed"]`` and ``store["made"]`` where the replaying run's
    own choices differed. ``cols`` (index, parts): a tensor-parallel
    rank, whose masks of a split layer are its index's slice of the last
    axis. The kernels run on both sides; a wrapper's launches go to its
    counter as in ``shared_choices``."""
    from pointnet_autoencoder_tpu_torch.nn import layers
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    nn_fn, head_fn, emd_fn = (ch.nn_distance_cuda, fh.head_max_cuda,
                              em.emd_forward_cuda)
    functional = layers.F
    store.setdefault("differed", 0)
    store.setdefault("made", 0)
    seen = {}

    def take(key, own):
        calls = seen.get(key, 0)
        seen[key] = calls + 1
        if not replay:
            store.setdefault(key, []).append(own.cpu())
            return own
        want = store[key][calls][rows].to(own.device, own.dtype)
        if cols is not None and want.shape[-1] != own.shape[-1]:
            width = own.shape[-1]
            want = want[..., cols[0] * width:(cols[0] + 1) * width]
        store["differed"] += int((own != want).sum())
        store["made"] += own.numel()
        return want

    def nn(a, b):
        d1, i1, d2, i2 = nn_fn(a, b)
        return d1, take("idx1", i1), d2, take("idx2", i2)

    def head(x, w, scale, shift):
        maxout, argmax = head_fn(x, w, scale, shift)
        return maxout, take("argmax", argmax)

    def emd(x1, x2):
        own = emd_fn(x1, x2)
        if not replay:
            store["emd"] = [t.cpu() for t in own]
            return own
        return tuple(t[rows].to(own[0].device) for t in store["emd"])

    def relu(x):
        mask = take("relu", x > 0)
        return functional.relu(x) if not replay else x * mask.to(x.dtype)

    patched = ((ch, "nn_distance_cuda", nn_fn, nn),
               (fh, "head_max_cuda", head_fn, head),
               (em, "emd_forward_cuda", emd_fn, emd))
    for mod, name, fn, stand_in in patched:
        stand_in.launches = fn.launches
        setattr(mod, name, stand_in)
    try:
        with relu_through(relu):
            yield
    finally:
        for mod, name, fn, stand_in in patched:
            setattr(mod, name, fn)
            fn.launches = stand_in.launches


def dp_step_argv(model, data, log_dir):
    """One f32 train step of ``model`` on host input (the batch is fed)."""
    return train_argv(model, data, log_dir) + ["--no-bf16", "--input_mode",
                                               "host"]


def dp_step_result(torch, trainer, metrics, counters, flips=(0, 0)):
    return dict(
        scalars={k: float(metrics[k]) for k in ("loss", "pcloss")},
        grads={n: p.grad.detach().cpu() for n, p in
               trainer.model.named_parameters()},
        buffers={n: b.detach().cpu() for n, b in
                 trainer.model.named_buffers()},
        launches={n: fn.launches for n, fn in counters.items()},
        flips=flips)


def dp_rank_steps(device, out_dir, data, preempt_argv):
    """A rank of phase data_parallel's 2-rank checks: for each model of
    DP_STEP_MODELS, one f32 train step through ``cli.train``'s build on
    this rank's rows of the one-device step's batch, replaying its
    choices, with the launches counted, and the bf16 Trainer captured
    beside eager (``grouped_captured``); then device-input training of
    ``model`` where rank 1 alone sends itself SIGTERM after its first
    chunk, and a resume at 2 ranks. Writes ``<out_dir>/dp_rank<r>.pt``."""
    import signal

    import torch
    import torch.distributed as dist

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    rank = dist.get_rank()
    per = BATCH // DP_RANKS
    rows = slice(rank * per, (rank + 1) * per)
    counters = kernel_counters(ch, fe, fh, em)
    parse = cli_train.build_parser().parse_args
    out = {}
    for model in DP_STEP_MODELS:
        case = torch.load(os.path.join(out_dir, f"{model}_case.pt"))
        tr, lg = cli_train.build_trainer(parse(dp_step_argv(
            model, data, os.path.join(out_dir, f"{model}_dp_log"))))
        x = case["x"][rows].to(tr.device)
        store = dict(case["choices"], differed=0, made=0)
        for fn in counters.values():
            fn.launches = 0
        with dp_choices(store, replay=True, rows=rows):
            m = tr.train_step(x)
        torch.cuda.synchronize()
        out[model] = dp_step_result(torch, tr, m, counters,
                                    (store["differed"], store["made"]))
        tr.close()
        lg.close()
    out["captured"] = {model: grouped_captured(
        torch, counters, train_argv(model, data, os.path.join(
            out_dir, f"{model}_captured_log")),
        torch.from_numpy(clouds(np.random.RandomState(SEED + 22), BATCH,
                                NUM_POINT)[rows]).cuda(),
        f"chip_smoke.dp.{model}") for model in DP_STEP_MODELS}

    tr, lg = cli_train.build_trainer(parse(preempt_argv))
    chunk_fn = tr._chunk

    def chunk(kind, idxs, metrics):
        # A captured chunk runs no train_step: the signal follows a chunk.
        chunk_fn(kind, idxs, metrics)
        if rank == 1 and kind == "train" and not tr._preempted:
            os.kill(os.getpid(), signal.SIGTERM)

    tr._chunk = chunk
    tr.train()
    stopped = (tr.state.step, tree_bytes_hash(torch, tr.model.state_dict()))
    tr.close()
    lg.close()
    again, lg = cli_train.build_trainer(parse(preempt_argv + ["--resume"]))
    resumed_at = (again.start_epoch, again.state.step)
    again.train()
    out["preempt"] = dict(stopped=stopped, resumed_at=resumed_at,
                          resumed=(again.state.step, tree_bytes_hash(
                              torch, again.model.state_dict())))
    again.close()
    lg.close()
    torch.save(out, os.path.join(out_dir, f"dp_rank{rank}.pt"))


def dp_nccl_step(device, out_dir, data):
    """The world-size-1 rank over NCCL: phase data_parallel's f32 `model`
    step on the whole batch, choices its own; then ``nccl_captured``."""
    import torch

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    counters = kernel_counters(ch, fe, fh, em)
    case = torch.load(os.path.join(out_dir, "model_case.pt"))
    tr, lg = cli_train.build_trainer(cli_train.build_parser().parse_args(
        dp_step_argv("model", data, os.path.join(out_dir, "nccl_log"))))
    require(tr.group is not None and tr.group.world_size == 1,
            "the NCCL rank is not in a group of 1")
    m = tr.train_step(case["x"].to(tr.device))
    torch.cuda.synchronize()
    torch.save(dp_step_result(torch, tr, m, counters),
               os.path.join(out_dir, "nccl_rank0.pt"))
    tr.close()
    lg.close()
    torch.save(nccl_captured(torch, counters, data, out_dir),
               os.path.join(out_dir, "nccl_captured.pt"))


def nccl_captured(torch, counters, data, out_dir) -> dict:
    """The bf16 `model` Trainer captured (the default), in an NCCL group of
    one rank or in none: ``TRAIN_EPOCHS`` device-input epochs at log_every
    ``GROUPED_LOG_EVERY`` and an eval epoch after each (launches, train
    state, eval losses, its programs' graphs and collectives), then a
    traced epoch (its graph launches) and the step's timing on a batch on
    the card."""
    import torch.distributed as dist

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    tag = "nccl" if dist.is_initialized() else "alone"
    cfg = cli_train.config_from_args(cli_train.build_parser().parse_args(
        train_argv("model", data, os.path.join(out_dir, f"{tag}_cap_log"))
        + ["--log_every", str(GROUPED_LOG_EVERY)]))
    tr = Trainer(cfg, device="cuda")
    try:
        out = grouped_epochs(torch, counters, tr)
        epoch = overhead_trace(torch, lambda: tr.train_one_epoch(
            TRAIN_EPOCHS), f"chip_smoke.{tag}.epoch", reps=1)
        out["epoch_graph_launches"] = epoch["graph_launches"]
        out["chunks"] = -(-len(tr.train_pipe) // GROUPED_LOG_EVERY)
        x = torch.from_numpy(clouds(np.random.RandomState(SEED + 22), BATCH,
                                    NUM_POINT)).cuda()
        out["timing"] = grouped_step_timing(
            torch, {True: lambda: tr.train_step(x)["loss"].item()},
            f"chip_smoke.{tag}.step")[True]
        return out
    finally:
        tr.close()


def dp_train_report(out_dir, trainer):
    """``after`` of phase data_parallel's ``cli.train`` run, in each rank:
    the launches of the whole run, the weights' hash, then the host median
    of 10 bf16 steps on this rank's rows of a batch already on the card and
    a trace of one; the peak device memory. Writes
    ``<out_dir>/train_rank<r>.json``."""
    import torch

    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    launches = {n: fn.launches for n, fn in
                kernel_counters(ch, fe, fh, em).items()}
    digest = tree_bytes_hash(torch, trainer.model.state_dict())
    per = BATCH // trainer.group.world_size
    x = torch.from_numpy(clouds(np.random.RandomState(SEED + 22), BATCH,
                                NUM_POINT)[trainer.rank * per:
                                           (trainer.rank + 1) * per]).to(
        trainer.device)
    *host, trace = step_timing(torch, trainer, x, "chip_smoke.dp_train_step")
    with open(os.path.join(out_dir, f"train_rank{trainer.rank}.json"),
              "w") as f:
        json.dump(dict(launches=launches, hash=digest,
                       step_host_ms=host, trace=trace,
                       peak_mb=torch.cuda.max_memory_allocated(
                           trainer.device) / 2**20), f)


def dp_gaps(got: dict, want: dict):
    """(the largest |got - want| of a leaf over that leaf's largest entry,
    the same over the whole gradient's largest entry, and the whole
    gradient's relative error norm), leaves that are zero in exact
    arithmetic (a bias before a training BN) left out of the first: they
    read as rounding noise on both sides (``grad_gaps``)."""
    _, noise = grad_gaps({n: g.double().numpy() for n, g in got.items()},
                         {n: w.double().numpy() for n, w in want.items()})
    largest = max(float(w.abs().max()) for w in want.values())
    leaf = whole = num = den = 0.0
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        whole = max(whole, err / largest)
        num += float((got[n] - w).double().square().sum())
        den += float(w.double().square().sum())
        if n not in noise:
            leaf = max(leaf, err / float(w.abs().max()))
    return leaf, whole, (num / den) ** 0.5


# The captured runs of the grouped ranks beside their eager runs: device
# input at log_every 3, so each epoch's 10 steps run as chunks of 3, 3, 3
# and 1 (the first chunk of the first epoch is the warm-up, eager; the
# first eval epoch too).
GROUPED_LOG_EVERY = 3


def counting_all_reduces(torch, fn) -> int:
    """The all-reduces ``fn()`` issues from the host (an eager step's or a
    tape's; an NCCL collective captured in a graph issues none)."""
    import torch.distributed as dist

    real, seen = dist.all_reduce, [0]

    def all_reduce(*args, **kwargs):
        seen[0] += 1
        return real(*args, **kwargs)

    dist.all_reduce = all_reduce
    try:
        fn()
    finally:
        dist.all_reduce = real
    return seen[0]


def grouped_step_timing(torch, steps, label) -> dict:
    """Each step of ``steps`` ({captured: step()}, each ending with the
    loss on the host) on a rank: after two calls each, 10 host-clock
    samples each, the steps taken in turns (the order swapped every
    round); the all-reduces one step issues; and the fuller of two traces
    of 3 steps (a trace may lose device events; the last step read: host
    operations, graph launches, device busy and idle share). The ranks
    run the same calls, so their all-reduces pair up. Returns {captured:
    timing}."""
    for step in steps.values():
        step()
        step()
    host = {c: [] for c in steps}
    order = sorted(steps)
    for i in range(10):
        for c in order if i % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            steps[c]()
            host[c].append(1e3 * (time.perf_counter() - t0))
    out = {}
    for c in order:
        trace = max((overhead_trace(torch, steps[c], f"{label}.{c}", reps=3)
                     for _ in range(2)), key=lambda t: t["device_events"])
        out[c] = dict(host_ms=statistics.median(host[c]),
                      host_spread=(min(host[c]), max(host[c])),
                      collectives=counting_all_reduces(torch, steps[c]),
                      host_ops=trace["host_ops"],
                      graph_launches=trace["graph_launches"],
                      busy_ms=trace["busy_ms"], idle=trace["idle"],
                      device_events=trace["device_events"])
    return out


def grouped_epochs(torch, counters, tr) -> dict:
    """``TRAIN_EPOCHS`` train epochs of the Trainer ``tr``, an eval epoch
    after each: its launches, its train state on the host, the eval
    losses, its step count and its programs' (graphs, collectives)."""
    for fn in counters.values():
        fn.launches = 0
    evals = []
    for epoch in range(TRAIN_EPOCHS):
        tr.train_one_epoch(epoch)
        evals.append(tr.eval_one_epoch(epoch))
    torch.cuda.synchronize()
    return dict(launches={k: fn.launches for k, fn in counters.items()},
                state=_host_state(torch, tr), evals=evals,
                step=tr.state.step,
                programs=None if tr._steps is None else {
                    k: (p.graphs, p.collectives)
                    for k, p in tr._steps.programs._programs.items()})


def grouped_captured(torch, counters, argv, x, label) -> dict:
    """In a rank of a group: the Trainer of ``cli.train`` flags ``argv``
    captured (the default: a tape over gloo, one graph per chunk over
    NCCL) and eager (``compiled=False``), from one seed, each
    ``TRAIN_EPOCHS`` device-input epochs at log_every
    ``GROUPED_LOG_EVERY`` with an eval epoch after each: its launches, its
    train state on the host, the eval losses and step count; its programs'
    graphs and collectives (captured); then its step on ``x``, this rank's
    part of a batch on the card (``grouped_step_timing``). Returns
    {True: captured, False: eager}."""
    import dataclasses

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    base = cli_train.config_from_args(cli_train.build_parser().parse_args(
        argv + ["--log_every", str(GROUPED_LOG_EVERY)]))
    trainers = {}
    try:
        for compiled in (True, False):
            trainers[compiled] = Trainer(dataclasses.replace(
                base, log_dir=f"{base.log_dir}_{compiled}"), device="cuda",
                compiled=compiled)
        out = {c: grouped_epochs(torch, counters, tr)
               for c, tr in trainers.items()}
        timing = grouped_step_timing(torch, {
            c: (lambda tr=tr: tr.train_step(x)["loss"].item())
            for c, tr in trainers.items()}, label)
        for c in out:
            out[c]["timing"] = timing[c]
        return out
    finally:
        for tr in trainers.values():
            tr.close()


def grouped_held(torch, tag, ranks, want_collectives=None,
                 what=f"{TRAIN_EPOCHS} device-input epochs at log_every "
                      f"{GROUPED_LOG_EVERY}") -> str:
    """Require each rank's captured run (``grouped_captured``) bit-equal to
    its eager run (train state, eval losses, steps) with equal launches,
    the same all-reduces per step both ways (``want_collectives`` if
    given), and its traced step within collectives + 1 graph launches;
    returns the report of rank 0 (and the ranks' spread of host ms)."""
    for r, runs in enumerate(ranks):
        cap, eager = runs[True], runs[False]
        bad = tree_mismatch(torch, cap["state"], eager["state"])
        require(bad is None, f"{tag} rank {r}: captured and eager train "
                f"states differ at {bad}")
        require(cap["evals"] == eager["evals"]
                and cap["step"] == eager["step"],
                f"{tag} rank {r}: eval losses {cap['evals']} captured, "
                f"{eager['evals']} eager; steps {cap['step']}, "
                f"{eager['step']}")
        require(cap["launches"] == eager["launches"],
                f"{tag} rank {r}: launches {cap['launches']} captured, "
                f"{eager['launches']} eager")
        ct, et = cap["timing"], eager["timing"]
        require(ct["collectives"] == et["collectives"]
                and (want_collectives is None
                     or ct["collectives"] == want_collectives),
                f"{tag} rank {r}: {ct['collectives']} all-reduces a captured "
                f"step, {et['collectives']} eager (want {want_collectives})")
        require(1 <= ct["graph_launches"] <= ct["collectives"] + 1
                and et["graph_launches"] == 0,
                f"{tag} rank {r}: {ct['graph_launches']} graph launches a "
                f"captured step with {ct['collectives']} collectives")
    cap, eager = ranks[0][True], ranks[0][False]
    ct, et = cap["timing"], eager["timing"]
    spread = [round(rk[c]["timing"]["host_ms"], 3) for rk in ranks
              for c in (True, False)]
    def steps(t):
        lo, hi = t["host_spread"]
        return (f"host median {t['host_ms']:.3f} ms (min {lo:.3f}, max "
                f"{hi:.3f}), {t['host_ops']} host operations, "
                f"{t['graph_launches']} graph launches, {t['collectives']} "
                f"collectives, {t['device_events']} device events, busy "
                f"{t['busy_ms']:.4f} ms, idle share {t['idle']:.4f}")

    return (f"{tag}: {what}, captured bit-equal to eager on every rank "
            f"(weights, optimizer slots and counts, BN statistics, eval "
            f"losses {cap['evals']}), launches {cap['launches']} both ways; "
            f"programs (graphs, collectives) {cap['programs']}. One step on "
            f"a batch on the card, rank 0, captured and eager in turns: "
            f"captured {steps(ct)}; eager {steps(et)} (host ms per rank, "
            f"captured and eager: {spread})")


def phase_data_parallel(torch, counters, session, weights, data, tmp, rng):
    """Data parallelism on the one card: 2 ranks over gloo on cuda:0 (NCCL
    refuses two ranks on one device) and one rank over NCCL. See the
    module docstring, phase 13."""
    import functools

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.parallel import mesh
    from pointnet_autoencoder_tpu_torch.serve import PointClient, PointServer
    from pointnet_autoencoder_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp, "dp")
    os.makedirs(out_dir)
    parse = cli_train.build_parser().parse_args
    cards = ["cuda:0"] * DP_RANKS
    say("data_parallel", f"2 ranks sharing one H100 over gloo "
        f"({nvidia_smi_line()}); nothing here is a multi-card time or a "
        f"speedup")

    # 1. One f32 step on the card alone, its choices recorded; the same
    # step on the batch with its rows swapped in pairs (the choices
    # replayed), which changes only the order of the batch sums: the f32
    # floor the ranks are held to beside 1e-5.
    x = clouds(np.random.RandomState(SEED + 21), BATCH, NUM_POINT)
    pairs = torch.from_numpy(
        np.arange(BATCH).reshape(-1, 2)[:, ::-1].reshape(-1).copy())
    single, floor = {}, {}
    for model in DP_STEP_MODELS:
        choices = {}
        for run, (replay, rows) in enumerate(((False, slice(None)),
                                              (True, pairs))):
            tr, lg = cli_train.build_trainer(parse(dp_step_argv(
                model, data, os.path.join(out_dir, f"{model}_{run}_log"))))
            store = dict(choices, differed=0, made=0) if replay else choices
            for fn in counters.values():
                fn.launches = 0
            with dp_choices(store, replay=replay, rows=rows):
                m = tr.train_step(torch.from_numpy(x)[rows].to(tr.device))
            torch.cuda.synchronize()
            (floor if replay else single)[model] = dp_step_result(
                torch, tr, m, counters)
            tr.close()
            lg.close()
        torch.save({"x": torch.from_numpy(x), "choices": choices},
                   os.path.join(out_dir, f"{model}_case.pt"))

    preempt_log = os.path.join(out_dir, "preempt_log")
    preempt_argv = train_argv("model", data, preempt_log) + [
        "--max_epoch", str(TRAIN_EPOCHS)]
    t0 = time.perf_counter()
    mesh.launch(dp_rank_steps, devices=cards, backend="gloo",
                args=(out_dir, data, preempt_argv))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"dp_rank{r}.pt"))
             for r in range(DP_RANKS)]
    want_launches = {
        "model": with_bn({"fused_head_fwd": 1, "fused_head_bwd": 1,
                          "nn_distance": 1, "nn_distance_grad": 1,
                          "emd_forward": 0, "fused_encoder_eval": 0},
                         "model", 1),
        "model_emd": with_bn({"fused_head_fwd": 1, "fused_head_bwd": 1,
                              "nn_distance": 1, "nn_distance_grad": 0,
                              "emd_forward": 1, "fused_encoder_eval": 0},
                             "model_emd", 1)}
    for model in DP_STEP_MODELS:
        one, fl = single[model], floor[model]
        got = [r[model] for r in ranks]
        for r, g in enumerate(got):
            require(g["launches"] == want_launches[model],
                    f"{model} DP step rank {r} launches {g['launches']}")
            differed, made = g["flips"]
            require(made > 0 and differed <= 1e-3 * made,
                    f"{model} DP step rank {r}: its own choices differed at "
                    f"{differed} of {made}")
        require(all(torch.equal(t, got[1]["grads"][n])
                    for n, t in got[0]["grads"].items())
                and all(torch.equal(t, got[1]["buffers"][n])
                        for n, t in got[0]["buffers"].items()),
                f"{model} DP step: the ranks' gradients or BN statistics "
                f"differ after the all-reduce")
        loss = np.mean([g["scalars"]["loss"] for g in got])
        require(close(loss, one["scalars"]["loss"], 1e-5, 0.0),
                f"{model} DP loss {loss} vs one card "
                f"{one['scalars']['loss']} (rtol 1e-5)")
        # BN statistics at rtol 1e-4, atol 1e-6, the atol raised to twice
        # the largest gap of the same statistic on the reordered batch (a
        # batch mean that cancels to near zero carries the rounding of
        # its terms).
        floored, buf_err = 0, (0.0, "", 0.0)
        for n, b in one["buffers"].items():
            b = b.numpy()
            err = np.abs(got[0]["buffers"][n].numpy() - b)
            bound = 1e-6 + 1e-4 * np.abs(b)
            reorder = float(np.abs(fl["buffers"][n].numpy() - b).max())
            floored += int((err > bound).sum())
            require(bool(np.all(err <= np.maximum(bound, 2 * reorder))),
                    f"{model} DP BN statistic {n}: max abs err "
                    f"{float(err.max()):.3e} past rtol 1e-4, atol 1e-6 and "
                    f"twice the reordered batch's largest gap {reorder:.3e}")
            i = int(np.argmax(err - bound))
            if err[i] - bound[i] > buf_err[0] - 1e-6 - 1e-4 * abs(buf_err[2]):
                buf_err = (float(err[i]), f"{n}[{i}]", float(b[i]))
        dp_leaf, dp_whole, dp_norm = dp_gaps(got[0]["grads"], one["grads"])
        fl_leaf, fl_whole, fl_norm = dp_gaps(fl["grads"], one["grads"])
        require(dp_whole <= max(1e-5, 2 * fl_whole)
                and dp_norm <= max(1e-5, 2 * fl_norm),
                f"{model} DP gradients: {dp_whole:.3e} of the largest "
                f"element, relative norm {dp_norm:.3e}; the reordered batch "
                f"on one card {fl_whole:.3e}, {fl_norm:.3e}")
        say("data_parallel", f"{model} f32 step, global B={BATCH} N="
            f"{NUM_POINT}, 2 ranks of {BATCH // DP_RANKS} on cuda:0 (gloo) "
            f"vs one card: loss {loss:.6f} vs {one['scalars']['loss']:.6f} "
            f"(rtol 1e-5); BN statistics: {floored} entries past rtol 1e-4, "
            f"atol 1e-6 (held within twice the reordered batch's gap), the "
            f"furthest {buf_err[1]} = {buf_err[2]:.4e} off by "
            f"{buf_err[0]:.3e}; gradient gap {dp_whole:.3e} of its largest "
            f"element ({'within' if dp_whole <= 1e-5 else 'past'} 1e-5), "
            f"largest leaf gap over the leaf's largest {dp_leaf:.3e}, "
            f"relative norm {dp_norm:.3e}; the same step on one card with "
            f"the batch's rows swapped in pairs (f32 floor): {fl_whole:.3e}, "
            f"{fl_leaf:.3e}, {fl_norm:.3e}; the ranks' own choices differed "
            f"at {got[0]['flips'][0]} + {got[1]['flips'][0]} of "
            f"{got[0]['flips'][1] + got[1]['flips'][1]} (replaced by the "
            f"one card's); per-rank launches {got[0]['launches']} ok")

    # The ranks' bf16 Trainers captured (tapes over gloo) beside eager.
    for model in DP_STEP_MODELS:
        say("data_parallel", grouped_held(
            torch, f"{model} DP 2 ranks over gloo (tape)",
            [r["captured"][model] for r in ranks],
            DP_MODEL_COLLECTIVES if model == "model" else None) + " ok")

    # 3. NCCL at world size 1: the step without a group, bit for bit.
    mesh.launch(dp_nccl_step, devices=["cuda:0"], backend="nccl",
                args=(out_dir, data))
    nccl = torch.load(os.path.join(out_dir, "nccl_rank0.pt"))
    one = single["model"]
    require(nccl["scalars"] == one["scalars"]
            and all(torch.equal(t, one["grads"][n])
                    for n, t in nccl["grads"].items())
            and all(torch.equal(t, one["buffers"][n])
                    for n, t in nccl["buffers"].items()),
            "the NCCL world-size-1 step differs from the step without a "
            "group")
    say("data_parallel", f"model f32 step in an NCCL group of 1: loss, "
        f"every gradient and BN statistic bit-equal to the step without a "
        f"group; launches {nccl['launches']} ok")
    grouped, alone = (torch.load(os.path.join(out_dir, "nccl_captured.pt")),
                      nccl_captured(torch, counters, data, out_dir))
    bad = tree_mismatch(torch, grouped["state"], alone["state"])
    require(bad is None and grouped["evals"] == alone["evals"]
            and grouped["launches"] == alone["launches"],
            f"the captured NCCL group of 1 differs from the graphed step "
            f"without a group: state at {bad}, evals {grouped['evals']} vs "
            f"{alone['evals']}, launches {grouped['launches']} vs "
            f"{alone['launches']}")
    require(all(g == 1 and c == 0 for g, c in grouped["programs"].values())
            and grouped["epoch_graph_launches"] == grouped["chunks"]
            and grouped["timing"]["graph_launches"] == 1
            and grouped["timing"]["collectives"] == 0,
            f"the NCCL group of 1 is not one graph a chunk: programs "
            f"{grouped['programs']}, {grouped['epoch_graph_launches']} graph "
            f"launches an epoch of {grouped['chunks']} chunks, a step "
            f"{grouped['timing']}")
    with open(os.path.join(out_dir, "nccl_cap_log", "log_train.txt")) as f:
        path_line = f.readline().strip()
    require(path_line.startswith("step path: captured CUDA graphs on cuda:0 "
                                 "of a nccl group of 1 ranks (the "
                                 "collectives inside each graph"),
            f"the NCCL rank's log names another path: {path_line}")
    gt, at = grouped["timing"], alone["timing"]
    say("data_parallel", f"model bf16 in an NCCL group of 1, captured (its "
        f"collectives inside the graphs): {TRAIN_EPOCHS} device-input "
        f"epochs bit-equal to the graphed Trainer without a group (state, "
        f"eval losses {grouped['evals']}, launches); programs "
        f"{grouped['programs']}, an epoch {grouped['epoch_graph_launches']} "
        f"graph launches for {grouped['chunks']} chunks; one step host "
        f"median {gt['host_ms']:.3f} ms ({gt['host_ops']} host operations, "
        f"{gt['device_events']} device events, busy {gt['busy_ms']:.4f} "
        f"ms) against {at['host_ms']:.3f} ms without a group "
        f"({at['host_ops']} host operations, {at['device_events']} device "
        f"events, busy {at['busy_ms']:.4f} ms); its log: {path_line!r} ok")

    # 4. Preemption: SIGTERM to rank 1 only, device input. The ranks agree
    # at the epoch's end (where the host waits for the epoch's metrics).
    p0, p1 = (r["preempt"] for r in ranks)
    steps_per_epoch = 320 // BATCH
    require(p0["stopped"] == p1["stopped"]
            and p0["stopped"][0] == steps_per_epoch,
            f"preemption: ranks stopped at {p0['stopped'][0]} and "
            f"{p1['stopped'][0]} (hashes equal: "
            f"{p0['stopped'][1] == p1['stopped'][1]}), expected both at "
            f"{steps_per_epoch}")
    with open(os.path.join(preempt_log, "log_train.txt")) as f:
        text = f.read()
    require(text.count("preemption checkpoint saved") == 1
            and "a signal on another rank" in text,
            "preemption: not one checkpoint from rank 0")
    require(p0["resumed_at"] == p1["resumed_at"] == (1, steps_per_epoch)
            and p0["resumed"] == p1["resumed"]
            and p0["resumed"][0] == TRAIN_EPOCHS * steps_per_epoch,
            f"preemption resume: {p0['resumed_at']} -> {p0['resumed'][0]}, "
            f"{p1['resumed_at']} -> {p1['resumed'][0]}")
    say("data_parallel", f"SIGTERM to rank 1 alone after its first chunk: "
        f"both ranks stopped at step {p0['stopped'][0]} (the epoch's end, "
        f"where they agree), weights bit-equal, one preemption checkpoint "
        f"by rank 0; a resume at 2 ranks started at epoch "
        f"{p0['resumed_at'][0]} step {p0['resumed_at'][1]} and ended at "
        f"step {p0['resumed'][0]} bit-equal across ranks; the 2-rank run "
        f"took {ranks_s:.1f} s ok")

    # 2. Training 2 epochs through cli.train's launch path, bf16, device
    # input and background saves (the defaults).
    log_dir = os.path.join(out_dir, "train_log")
    t0 = time.perf_counter()
    cli_train.main(train_argv("model", data, log_dir)
                   + ["--max_epoch", str(TRAIN_EPOCHS)], devices=cards,
                   backend="gloo",
                   after=functools.partial(dp_train_report, out_dir))
    train_s = time.perf_counter() - t0
    reports = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"train_rank{r}.json")) as f:
            reports.append(json.load(f))
    eval_batches = 64 // BATCH
    want = with_bn({"fused_head_fwd": TRAIN_EPOCHS * steps_per_epoch,
                    "fused_head_bwd": TRAIN_EPOCHS * steps_per_epoch,
                    "nn_distance_grad": TRAIN_EPOCHS * steps_per_epoch,
                    "nn_distance": TRAIN_EPOCHS * (steps_per_epoch
                                                   + eval_batches),
                    "fused_encoder_eval": TRAIN_EPOCHS * eval_batches,
                    "emd_forward": 0}, "model", TRAIN_EPOCHS * steps_per_epoch)
    for r, rep in enumerate(reports):
        require(rep["launches"] == want,
                f"DP training rank {r} launches {rep['launches']}, the path "
                f"needs {want}")
    require(reports[0]["hash"] == reports[1]["hash"],
            "DP training: the ranks' weights differ after 2 epochs")
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    evals = [r["pcloss"] for r in recs if r["split"] == "test"]
    require(len(evals) == TRAIN_EPOCHS and all(np.isfinite(evals))
            and evals[-1] < evals[0], f"DP eval pcloss {evals}")
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        text = f.read()
    path_line = next(line for line in text.splitlines()
                     if line.startswith("step path:"))
    require(path_line.startswith("step path: captured tape on cuda:0 of a "
                                 "gloo group of 2 ranks")
            and "tape ('train', 5): 76 graphs and 75 collectives" in text,
            f"DP training's log names another path: {path_line}")
    bests = sorted(n for n in os.listdir(log_dir)
                   if n.startswith("best_model_epoch_"))
    require(bool(bests) and checkpoint.CheckpointManager(log_dir).latest()
            is not None, f"DP training checkpoints: {os.listdir(log_dir)}")
    restored = InferenceSession("model", os.path.join(log_dir, bests[-1]),
                                NUM_POINT, batch_size=BATCH, device="cuda")
    rec = restored.reconstruct(x)
    require(rec.shape == x.shape and np.all(np.isfinite(rec)),
            "a one-card session on the DP checkpoint")
    say("data_parallel", f"cli.train --data_parallel 2 on cuda:0 twice "
        f"(gloo), bf16, device input, its log: {path_line!r}: "
        f"{TRAIN_EPOCHS} epochs in "
        f"{train_s:.1f} s (rank start and data loading included); eval "
        f"pcloss {[round(v, 6) for v in evals]}; weights bit-equal across "
        f"ranks (sha256 {reports[0]['hash'][:16]}); checkpoints by rank 0 "
        f"{bests} restore into a one-card session; per-rank launches "
        f"{reports[0]['launches']} (K3 = K4 = K2 = 20 steps, K5 = "
        f"{TRAIN_EPOCHS * eval_batches} eval batches, K1 20 + "
        f"{TRAIN_EPOCHS * eval_batches}) ok")
    for r, rep in enumerate(reports):
        med, lo, hi = rep["step_host_ms"]
        say("data_parallel", f"rank {r}: bf16 step on its {BATCH // DP_RANKS}"
            f" rows (2 ranks on one H100 over gloo; host clock to the loss): "
            f"median {med:.3f} ms, min {lo:.3f}, max {hi:.3f}; traced: "
            f"{rep['trace']}; peak device "
            f"memory {rep['peak_mb']:.1f} MiB")

    # 5. Serving: one process, a replica per entry of the mesh.
    dp = InferenceSession("model", weights, NUM_POINT, batch_size=BATCH,
                          data_parallel=DP_RANKS, devices=cards)
    gaps = {}
    for what, batch in (("B=32", clouds(rng, BATCH, NUM_POINT)),
                        ("ragged 45", clouds(rng, 45, NUM_POINT))):
        rec_dp, rec_one = dp.reconstruct(batch), session.reconstruct(batch)
        emb_dp, emb_one = dp.embed(batch), session.embed(batch)
        pairs_out = [("reconstruct", rec_dp, rec_one),
                     ("embed", emb_dp, emb_one),
                     ("decode", dp.decode(emb_one), session.decode(emb_one)),
                     ("chamfer", dp.chamfer(rec_one, batch),
                      session.chamfer(rec_one, batch)),
                     ("fscore", dp.fscore(rec_one, batch),
                      session.fscore(rec_one, batch))]
        for name, a, b in pairs_out:
            require(close(a, b, 1e-5, 1e-5),
                    f"DP serving {name} ({what}): max abs err "
                    f"{max_err(a, b):.3e}")
            gaps[f"{name} {what}"] = max_err(a, b)
    fe.encoder_extrema_cuda.launches = 0
    dp.reconstruct(x)
    require(fe.encoder_extrema_cuda.launches == DP_RANKS,
            f"DP serving: K5 launched {fe.encoder_extrema_cuda.launches} "
            f"times for one batch, not once per replica")
    host_dp, host_one = [], []
    for _ in range(10):
        for s, into in ((dp, host_dp), (session, host_one)):
            t0 = time.perf_counter()
            s.reconstruct(x)
            into.append(1e3 * (time.perf_counter() - t0))
    server = PointServer(dp, host="127.0.0.1", port=0, max_delay_ms=5.0)
    server.start()
    try:
        with PointClient("127.0.0.1", server.port, timeout=120) as c:
            for n in (3, 32, 7):
                req = clouds(rng, n, NUM_POINT)
                got = c.reconstruct(req)
                require(close(got, session.reconstruct(req), 1e-5, 1e-5),
                        f"DP PointServer reconstruct of {n}")
    finally:
        server.stop()
    say("data_parallel", f"serving, 2 replicas on cuda:0, f32 B={BATCH}: "
        f"reconstruct, embed, decode, chamfer and fscore against the "
        f"one-card session, max abs err "
        + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
        + f" (rtol, atol 1e-5); K5 {DP_RANKS} launches per batch; a "
        f"PointServer over it answered 3 requests; reconstruct host median "
        f"{statistics.median(host_dp):.3f} ms with 2 replicas on one H100 "
        f"vs {statistics.median(host_one):.3f} ms on one replica, same call "
        f"(not a speedup measurement) ok")
    say("data_parallel", f"phase took {time.perf_counter() - t_phase:.1f} s")


def tree_bytes_hash(torch, tree) -> str:
    """sha256 of every tensor's raw bytes (bf16 included) in a nested
    state dict, in key order."""
    import hashlib

    h = hashlib.sha256()

    def walk(node, path):
        if torch.is_tensor(node):
            t = node.detach().cpu().contiguous().reshape(-1)
            h.update(f"{path}:{t.dtype}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        elif isinstance(node, dict):
            for k in node:
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            h.update(f"{path}={node!r}".encode())

    walk(tree, "")
    return h.hexdigest()


def step_timing(torch, trainer, x, label):
    """The host clock of one train step on ``x`` (a batch already on the
    card) to the loss on the host: (median, min, max) ms of 10 after one,
    then one trace of a step (``device_trace`` with the port's kernels)."""
    def step():
        trainer.train_step(x)["loss"].item()

    step()
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        host.append(1e3 * (time.perf_counter() - t0))
    trace = device_trace(torch, step, label, top=10, own=True)
    return statistics.median(host), min(host), max(host), trace


def rank_report(out_dir, tag, trainer):
    """``after`` of a ``cli.train`` run on ranks: this rank's launches of
    the whole run, whether it ran the point-parallel step, and a hash of
    its whole train state (weights, optimizer slots, step). Writes
    ``<out_dir>/<tag>_rank<r>.json``."""
    import torch

    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    with open(os.path.join(out_dir, f"{tag}_rank{trainer.rank}.json"),
              "w") as f:
        json.dump(dict(
            launches={n: fn.launches for n, fn in
                      kernel_counters(ch, fe, fh, em).items()},
            hash=tree_bytes_hash(torch, trainer.state.state_dict()),
            sp=trainer.sp_active, step=trainer.state.step), f)


def path_launches(steps, eval_batches, chamfer_grad=True):
    """Each kernel's launches on a `model` training path of ``steps``
    steps and ``eval_batches`` eval batches: K3, K4 (and K2) per step, K7
    six times a step each way, K5 per eval batch, K1 per step and eval
    batch."""
    return with_bn({"fused_head_fwd": steps, "fused_head_bwd": steps,
                    "nn_distance_grad": steps if chamfer_grad else 0,
                    "nn_distance": steps + eval_batches,
                    "fused_encoder_eval": eval_batches, "emd_forward": 0},
                   "model", steps)


# ---------------------------------------------------------------------------
# Phase master: bf16 master weights and moments
# ---------------------------------------------------------------------------

MASTER_FLAGS = ["--bf16_params", "--bf16_moments"]
SR_VALUES = 1 << 20
SR_SPECIAL = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38,
     np.finfo(np.float32).max, -np.finfo(np.float32).max, np.inf, -np.inf,
     1.0, -2.5]
    + list(np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF],
                    np.uint32).view(np.float32)), np.float32)
# The train state of the default `model` run, f32 weights with Adam's two
# f32 slots, as PERF.md §5 records it.
DEFAULT_STATE_MB = 102.7


def phase_master(torch, counters, data, tmp, rng):
    """bf16 master weights and moments (``train/master.py``) on the card.
    See the module docstring, phase 14."""
    import functools

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.train import checkpoint, master

    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp, "master")
    os.makedirs(out_dir)
    parse = cli_train.build_parser().parse_args
    dev = torch.device("cuda")

    # 1. Stochastic rounding on the card against the CPU on one injected
    # noise tensor (the two generators draw different bits from a seed).
    x = np.concatenate([SR_SPECIAL, (rng.randn(SR_VALUES - len(SR_SPECIAL))
                                     * 10.0 ** rng.uniform(
                                         -40, 38, SR_VALUES
                                         - len(SR_SPECIAL))).astype(
        np.float32)])
    noise = rng.randint(0, 1 << 16, SR_VALUES).astype(np.int32)
    xt, nt = torch.from_numpy(x), torch.from_numpy(noise)
    card = master.stochastic_round_bf16(xt.to(dev), nt.to(dev)).cpu()
    cpu = master.stochastic_round_bf16(xt, nt)
    require(torch.equal(card.view(torch.int16), cpu.view(torch.int16)),
            f"stochastic rounding on the card differs from the CPU's at "
            f"{int((card.view(torch.int16) != cpu.view(torch.int16)).sum())}"
            f" of {SR_VALUES}")
    say("master", f"stochastic rounding of {SR_VALUES} f32 values (zeros, "
        f"subnormals, the largest finite, infs and NaNs among them) on the "
        f"card bit-equal to the CPU's on the same noise ok")

    # 2. Two epochs of `model`, default and with bf16 weights and moments.
    steps = TRAIN_EPOCHS * (320 // BATCH)
    evals = TRAIN_EPOCHS * (64 // BATCH)
    runs = {}
    for name, flags in (("default", []), ("master", MASTER_FLAGS)):
        argv = train_argv("model", data, os.path.join(out_dir, name)) + flags
        runs[name] = train_run(torch, counters, argv, MODEL_PATH_KERNELS)
        got = {k: counters[k].launches for k in counters}
        require(got == path_launches(steps, evals),
                f"{name} run launches {got}, the path needs "
                f"{path_launches(steps, evals)}")
    tr = runs["master"]["trainer"]
    opt = tr.state.optimizer
    require(isinstance(opt, master.MasterOptimizer),
            f"the master run's optimizer is {type(opt).__name__}")
    for n, p in tr.model.named_parameters():
        want = (torch.bfloat16 if master.is_matmul_param(n)
                else torch.float32)
        require(p.dtype == want
                and all(s.dtype == want for s in opt.slots[n].values()),
                f"{n}: parameter {p.dtype}, slots "
                f"{[s.dtype for s in opt.slots[n].values()]}, expected {want}")
    require(all(b.dtype == torch.float32 for b in tr.model.buffers()),
            "a BN statistic is not f32")
    pc = {name: [r["pcloss"] for r in run["test"]]
          for name, run in runs.items()}
    require(len(pc["master"]) == TRAIN_EPOCHS
            and pc["master"][-1] < pc["master"][0]
            and pc["master"][-1] < 2.0 * pc["default"][-1],
            f"eval pcloss with bf16 weights and moments {pc['master']}, "
            f"default {pc['default']}")
    mb = {name: state_mb(torch, run["trainer"].state.state_dict())
          for name, run in runs.items()}
    say("master", f"cli.train --bf16_params --bf16_moments, {TRAIN_EPOCHS} "
        f"epochs ({steps} steps) in {runs['master']['seconds']:.1f} s: "
        f"matmul weights and their Adam slots bf16, BN parameters, slots "
        f"and statistics f32; eval pcloss "
        f"{[round(v, 6) for v in pc['master']]} vs the default run's {[round(v, 6) for v in pc['default']]} (held "
        f"under 2x); launches {path_launches(steps, evals)} as the default "
        f"path's; train state {mb['master']:.1f} MB vs the default "
        f"{mb['default']:.1f} MB (PERF.md's record: {DEFAULT_STATE_MB})")
    xb = torch.from_numpy(clouds(np.random.RandomState(SEED + 30), BATCH,
                                 NUM_POINT)).to(dev)
    for name, run in runs.items():
        med, lo, hi, trace = step_timing(torch, run["trainer"], xb,
                                         f"chip_smoke.master.{name}_step")
        say("master", f"{name} model train step, bf16 matmuls, B={BATCH} "
            f"N={NUM_POINT} (host clock to the loss on the host): median "
            f"{med:.3f} ms, min {lo:.3f}, max {hi:.3f}; traced: {trace}")
    best_path = runs["master"]["best_path"]
    for run in runs.values():
        run["trainer"].close()
        run["logger"].close()

    # 3. A run stopped after step 10 and resumed equals 20 steps alone.
    batches = [torch.from_numpy(clouds(np.random.RandomState(SEED + 40 + i),
                                       BATCH, NUM_POINT)).to(dev)
               for i in range(20)]
    trees = []
    for stop in (None, 10):
        log = os.path.join(out_dir, f"resume{stop}")
        t, lg = cli_train.build_trainer(parse(
            train_argv("model", data, log) + MASTER_FLAGS
            + ["--sync_checkpoints"]))
        for xi in batches[:stop]:
            t.train_step(xi)
        if stop is not None:
            t._save("periodic", 0)
            t.close()
            lg.close()
            t, lg = cli_train.build_trainer(parse(
                train_argv("model", data, log) + MASTER_FLAGS
                + ["--sync_checkpoints", "--resume"]))
            require(t.state.step == stop and t.state.optimizer.steps == stop,
                    f"resumed at step {t.state.step}")
            for xi in batches[stop:]:
                t.train_step(xi)
        torch.cuda.synchronize()
        trees.append(checkpoint.to_host(t.state.state_dict()))
        t.close()
        lg.close()
    where = tree_mismatch(torch, trees[0], trees[1])
    require(where is None, f"the resumed run differs from the uninterrupted "
            f"one at {where}")
    say("master", "20 bf16-master steps on fixed batches, and 10 steps, a "
        "checkpoint, --resume and 10 more: weights, slots and step "
        "bit-equal ok")

    # 4. model_emd with bf16 weights: one step through K6.
    t, lg = cli_train.build_trainer(parse(train_argv(
        "model_emd", data, os.path.join(out_dir, "emd")) + ["--bf16_params"]))
    for fn in counters.values():
        fn.launches = 0
    loss = float(t.train_step(batches[0])["loss"])
    k6 = counters["emd_forward"].launches
    require(k6 == 1 and np.isfinite(loss),
            f"model_emd --bf16_params step: K6 launched {k6}, loss {loss}")
    t.close()
    lg.close()
    say("master", f"model_emd --bf16_params: one step, K6 launched once, "
        f"loss {loss:.4f} ok")

    # 5. Two ranks on the card over gloo: the replicas stay bit-equal.
    log = os.path.join(out_dir, "dp")
    cli_train.main(train_argv("model", data, log) + MASTER_FLAGS
                   + ["--max_epoch", str(TRAIN_EPOCHS), "--data_parallel",
                      str(DP_RANKS)],
                   devices=["cuda:0"] * DP_RANKS, backend="gloo",
                   after=functools.partial(rank_report, out_dir, "dp"))
    reps = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"dp_rank{r}.json")) as f:
            reps.append(json.load(f))
    require(reps[0]["hash"] == reps[1]["hash"]
            and reps[0]["step"] == steps,
            "bf16-master data parallel: the ranks' train states differ")
    say("master", f"cli.train --bf16_params --bf16_moments --data_parallel "
        f"2 on cuda:0 (gloo), {TRAIN_EPOCHS} epochs: the ranks' weights, "
        f"slots and step bit-equal (sha256 {reps[0]['hash'][:16]}) ok")

    # 6. Serving the bf16-master checkpoint: an f32 session equals one on
    # its explicit f32 upcast.
    stored = checkpoint.load(best_path)["model"]
    upcast = os.path.join(out_dir, "upcast.pt")
    torch.save({k: v.float() for k, v in stored.items()}, upcast)
    xs = clouds(rng, BATCH, NUM_POINT)
    a = InferenceSession("model", best_path, NUM_POINT, batch_size=BATCH,
                         device="cuda").reconstruct(xs)
    b = InferenceSession("model", upcast, NUM_POINT, batch_size=BATCH,
                         device="cuda").reconstruct(xs)
    require(np.array_equal(a, b) and np.isfinite(a).all(),
            f"the bf16-master checkpoint's session vs its f32 upcast: max "
            f"abs err {max_err(a, b):.3e}")
    say("master", f"an f32 session on the bf16-master checkpoint "
        f"reconstructs B={BATCH} bit-equal to one on its explicit f32 "
        f"upcast ok")
    say("master", f"phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase point_parallel
# ---------------------------------------------------------------------------

SP_RANKS = 2
SP_STEP_MODELS = ("model", "model_emd")
SP_FAMILIES = ("model_cpu", "model_hierachy", "model_upconv",
               "model_fc_upconv")
SP_FAMILY_BATCH = 8


@contextlib.contextmanager
def sp_choices(store: dict, replay: bool, num_points: int = NUM_POINT,
               points=slice(None), label_first: bool = False):
    """Within the block, a train step's ReLU masks and Chamfer argmins are
    recorded into ``store`` (the card alone's step), or, with ``replay``,
    taken from it at the points ``points`` (a slice or an index tensor) of
    the ``num_points``-point label: a point-parallel rank's shard
    (``label_first``: its per-shard call is (label shard, cloud)) or the
    card alone's label reordered (its call is (cloud, label)). A Chamfer
    call then takes the recorded nearest point of the cloud for each of
    its label points, and for each point of the cloud the recorded nearest
    label point if it is among them, its distance +inf elsewhere, so that
    the ranks' combine picks the recorded shard. A replay counts in
    ``store["differed"]`` and ``store["made"]`` where the run's own
    choices differed. The head's argmax stays each run's own. Launches go
    to each wrapper's counter."""
    import torch

    from pointnet_autoencoder_tpu_torch.nn import layers
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch

    functional = layers.F
    store.setdefault("differed", 0)
    store.setdefault("made", 0)
    calls = {"relu": 0, "nn": 0}
    order = torch.arange(num_points)[points]
    position = torch.full((num_points,), -1, dtype=torch.long)
    position[order] = torch.arange(len(order))

    def relu(x):
        if not replay:
            store.setdefault("relu", []).append((x > 0).cpu())
            return functional.relu(x)
        want = store["relu"][calls["relu"]]
        calls["relu"] += 1
        if want.dim() == 3 and want.shape[1] == num_points:
            want = want[:, points]
        want = want.to(x.device)
        store["differed"] += int(((x > 0) != want).sum())
        store["made"] += want.numel()
        return x * want.to(x.dtype)

    def make_nn(fn):
        def nn(a, b):
            own = fn(a, b)
            if not replay:
                store.setdefault("idx1", []).append(own[1].cpu())
                store.setdefault("idx2", []).append(own[3].cpu())
                return own
            label, cloud = (a, b) if label_first else (b, a)
            c = calls["nn"]
            calls["nn"] += 1
            to_cloud = store["idx2"][c][:, points].to(a.device)
            local = position.to(a.device)[store["idx1"][c].to(a.device)
                                          .long()]
            won = local >= 0
            to_label = torch.where(won, local, 0)
            near = label.gather(1, to_label[..., None].expand(-1, -1, 3))
            sq = (cloud - near) ** 2
            dist = torch.where(won, (sq[..., 0] + sq[..., 1]) + sq[..., 2],
                               float("inf"))
            mine = own[1] if label_first else own[3]
            store["differed"] += int((mine != to_cloud).sum())
            store["made"] += to_cloud.numel()
            if label_first:
                return own[0], to_cloud.int(), dist, to_label.int()
            return dist, to_label.int(), own[2], to_cloud.int()

        return nn

    patched = [(name, getattr(ch, name)) for name in ("nn_distance_cuda",
                                                      "nn_distance_plain")]
    for name, fn in patched:
        stand_in = make_nn(fn)
        stand_in.launches = getattr(fn, "launches", 0)
        setattr(ch, name, stand_in)
    try:
        with relu_through(relu):
            yield
    finally:
        for name, fn in patched:
            if hasattr(fn, "launches"):
                fn.launches = getattr(ch, name).launches
            setattr(ch, name, fn)


@contextlib.contextmanager
def plain_emd_on_the_card(inputs: dict):
    """Within the block the EMD runs its plain dense form on the card in
    place of K6: the formulation of the point-sharded EMD, whose per-level
    collective no single kernel spans (the JAX package's design). The
    inputs of the last call go to ``inputs``."""
    from pointnet_autoencoder_tpu_torch.ops import emd as em

    kernel = em.emd_forward_cuda

    def plain(x1, x2):
        inputs["xyz"] = (x1.detach(), x2.detach())
        return em.emd_forward_plain(x1, x2)

    em.emd_forward_cuda = plain
    try:
        yield
    finally:
        em.emd_forward_cuda = kernel


def sp_step_argv(model, data, log_dir, batch, ranks=True):
    """One f32 train step of ``model`` at ``batch`` on host input, as
    point-parallel ranks (or the card alone)."""
    argv = dp_step_argv(model, data, log_dir) + ["--batch_size", str(batch)]
    if ranks:
        argv += ["--point_parallel", "--data_parallel", str(SP_RANKS)]
    return argv


def sp_rank_steps(device, out_dir, data):
    """A rank of phase point_parallel: for each model, an f32 step through
    ``cli.train``'s build (``--point_parallel``) on this rank's points of
    the card alone's batch, replaying its choices, with the launches
    counted; `model` and `model_emd` also their combined Chamfer indices
    on (label, a random cloud) by their own choices, and `model` its eval
    embedding before the step (K5 counted); 3 steps with --bf16_params;
    the bf16 step's host median, trace and peak memory of `model` and
    `model_emd`. Writes ``<out_dir>/sp_rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
    from pointnet_autoencoder_tpu_torch.parallel import sp

    rank = dist.get_rank()
    pts = sp.point_slice(NUM_POINT, rank, SP_RANKS)
    counters = kernel_counters(ch, fe, fh, em)
    parse = cli_train.build_parser().parse_args
    out = {}
    for model in SP_STEP_MODELS + SP_FAMILIES:
        case = torch.load(os.path.join(out_dir, f"{model}_sp_case.pt"))
        x = case["x"]
        tr, lg = cli_train.build_trainer(parse(sp_step_argv(
            model, data, os.path.join(out_dir, f"{model}_sp_log"),
            x.shape[0])))
        require(tr.sp_active, "the point-parallel step is not active")
        xl = x[:, pts].contiguous().to(tr.device)
        res = {}
        if model in SP_STEP_MODELS:
            with torch.no_grad():
                _, i1, _, i2 = sp.nn_distance_point_sharded(
                    xl, case["y"].to(tr.device), tr.group)
            res["nn"] = (i1.cpu(), i2.cpu())
        if model == "model":
            fe.encoder_extrema_cuda.launches = 0
            with torch.no_grad():
                emb = tr.model.encoder(xl, train=False)
            torch.cuda.synchronize()
            res["eval"] = (emb.cpu(), fe.encoder_extrema_cuda.launches)
        store = dict(case["choices"], differed=0, made=0)
        for fn in counters.values():
            fn.launches = 0
        with sp_choices(store, replay=True, points=pts, label_first=True):
            m = tr.train_step(xl)
        torch.cuda.synchronize()
        res.update(dp_step_result(torch, tr, m, counters,
                                  (store["differed"], store["made"])))
        out[model] = res
        tr.close()
        lg.close()

    # bf16 weights under point parallelism: 3 steps.
    x = torch.load(os.path.join(out_dir, "model_sp_case.pt"))["x"]
    tr, lg = cli_train.build_trainer(parse(
        train_argv("model", data, os.path.join(out_dir, "bf16_sp_log"))
        + ["--input_mode", "host", "--point_parallel", "--data_parallel",
           str(SP_RANKS), "--bf16_params"]))
    xl = x[:, pts].contiguous().to(tr.device)
    for _ in range(3):
        tr.train_step(xl)
    torch.cuda.synchronize()
    out["bf16"] = tree_bytes_hash(torch, tr.state.state_dict())
    tr.close()
    lg.close()

    # The bf16 step of each (and of model_upconv, whose transposed
    # convolutions run deterministic here) on this rank's points: host
    # clock, a trace and the peak device memory.
    out["timing"] = {}
    for model in SP_STEP_MODELS + ("model_upconv",):
        tr, lg = cli_train.build_trainer(parse(
            train_argv(model, data, os.path.join(out_dir, f"t_{model}"))
            + ["--input_mode", "host", "--point_parallel",
               "--data_parallel", str(SP_RANKS)]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(tr.device)
        timing = step_timing(torch, tr, xl, f"chip_smoke.sp.{model}_step")
        out["timing"][model] = timing + (
            torch.cuda.max_memory_allocated(tr.device) / 2**20,)
        tr.close()
        lg.close()
    # The bf16 Trainers captured (tapes over gloo) beside eager.
    out["captured"] = {model: grouped_captured(
        torch, counters, train_argv(model, data, os.path.join(
            out_dir, f"{model}_sp_captured_log"))
        + ["--point_parallel", "--data_parallel", str(SP_RANKS)], xl,
        f"chip_smoke.sp.{model}") for model in SP_STEP_MODELS}
    torch.save(out, os.path.join(out_dir, f"sp_rank{rank}.pt"))


def sp_kernel_times(torch, ch, fe, fh, rng):
    """K1, K3, K4 and K5 on one rank's shard of the training shapes
    (N/2 = 1024 points of the label; K1 also against model_hierachy's 64
    centers): the device time per call, median of 50 traced calls, beside
    each bound (bf16 for K3, K4 and K5, the training type), and K1's
    library yardstick."""
    from pointnet_autoencoder_tpu_torch.utils import roofline

    dev = torch.device("cuda")
    n = NUM_POINT // SP_RANKS
    a = torch.from_numpy(clouds(rng, BATCH, n)).to(dev)
    b = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    c = torch.from_numpy(clouds(rng, BATCH, HIER_CENTERS)).to(dev)
    lines = []
    for m, other in ((NUM_POINT, b), (HIER_CENTERS, c)):
        ms, counts = median_device_ms(
            torch, lambda o=other: ch.nn_distance_cuda(a, o))
        lib, lib_counts = median_device_ms(
            torch, lambda o=other: cdist_yardstick(torch, a, o),
            repeats=True)
        bd = bound("nn_distance", b=BATCH, n=n, m=m)
        lines.append(f"K1 B={BATCH} N={n} M={m}: {ms:.5f} ms "
                     f"({_event_counts(counts)}), bound {bd['bound_ms']:.5f} "
                     f"({bd['bound_by']}); library (torch.cdist + two min) "
                     f"{lib:.5f} ms ({_event_counts(lib_counts)})")
    x, w, scale, shift = head_inputs(torch, rng, BATCH, n, torch.bfloat16)
    _, arg = fh.head_max_cuda(x, w, scale, shift)
    f = w.shape[1]
    gvals = torch.from_numpy((1e-3 * rng.randn(BATCH, f)).astype(
        np.float32)).to(dev)
    rows_x = roofline.distinct_rows(arg, n)
    for what, fn, bd, note in (
            ("K3 bf16", lambda: fh.head_max_cuda(x, w, scale, shift),
             bound("fused_head_fwd", b=BATCH, n=n, f=f, dtype="bf16"), ""),
            ("K4 bf16", lambda: fh.head_bwd_cuda(x, w, gvals, arg),
             bound("fused_head_bwd", b=BATCH, n=n, f=f, dtype="bf16",
                   rows=rows_x), f"; {rows_x} argmax rows")):
        ms, counts = median_device_ms(torch, fn)
        lines.append(f"{what} B={BATCH} N={n}: {ms:.5f} ms "
                     f"({_event_counts(counts)}), bound {bd['bound_ms']:.5f} "
                     f"({bd['bound_by']}){note}")
    chain = fe.fold_layers(
        [tuple(torch.from_numpy(t).to(dev) for t in layer)
         for layer in random_layers(rng)], eps=EPS, dtype=torch.bfloat16)
    p16 = a.to(torch.bfloat16)
    bd = bound("fused_encoder_eval", b=BATCH, n=n, dtype="bf16")
    ms, counts = median_device_ms(torch, lambda: fe.encoder_extrema_cuda(
        p16, chain))
    lines.append(f"K5 bf16 B={BATCH} N={n}: {ms:.5f} ms "
                 f"({_event_counts(counts)}), bound {bd['bound_ms']:.5f} "
                 f"({bd['bound_by']})")
    return lines


def sp_kernel_rank(device, out_dir):
    """``sp_kernel_times`` in a process of its own; writes its lines to
    ``<out_dir>/kernel_times.json``."""
    import torch

    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    lines = sp_kernel_times(torch, ch, fe, fh,
                            np.random.RandomState(SEED + 61))
    with open(os.path.join(out_dir, "kernel_times.json"), "w") as f:
        json.dump(lines, f)


def phase_point_parallel(torch, counters, data, tmp, rng):
    """Point parallelism on the one card: 2 ranks over gloo on cuda:0.
    See the module docstring, phase 15."""
    import functools

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
    from pointnet_autoencoder_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp, "sp")
    os.makedirs(out_dir)
    parse = cli_train.build_parser().parse_args
    cards = ["cuda:0"] * SP_RANKS
    say("point_parallel", f"2 ranks sharing one H100 over gloo "
        f"({nvidia_smi_line()}), each with {NUM_POINT // SP_RANKS} of every "
        f"shape's {NUM_POINT} points; nothing here is a multi-card time or "
        f"a speedup")

    # 1. The card alone: each model's f32 step, its choices recorded, and
    # the same step with every shape's points rolled by N/2 (the choices
    # rolled with them): the f32 floor. model_emd's reference runs the
    # EMD's dense form, the per-shard formulation of the ranks.
    single, floor, k6_loss = {}, {}, None
    roll = torch.roll(torch.arange(NUM_POINT), NUM_POINT // 2)
    for model in SP_STEP_MODELS + SP_FAMILIES:
        b = BATCH if model in SP_STEP_MODELS else SP_FAMILY_BATCH
        x = torch.from_numpy(clouds(np.random.RandomState(SEED + 50), b,
                                    NUM_POINT))
        y = torch.from_numpy(clouds(np.random.RandomState(SEED + 51), b,
                                    NUM_POINT))
        choices = {}
        for run, (replay, points) in enumerate(((False, slice(None)),
                                                (True, roll))):
            tr, lg = cli_train.build_trainer(parse(sp_step_argv(
                model, data, os.path.join(out_dir, f"{model}_{run}"), b,
                ranks=False)))
            if model == "model" and run == 0:
                with torch.no_grad():
                    emb = tr.model.encoder(x.to(tr.device), train=False)
            store = dict(choices, differed=0, made=0) if replay else choices
            for fn in counters.values():
                fn.launches = 0
            emd_inputs = {}
            emd = (plain_emd_on_the_card(emd_inputs) if model == "model_emd"
                   else contextlib.nullcontext())
            with sp_choices(store, replay=replay, points=points), emd:
                m = tr.train_step(x[:, points].contiguous().to(tr.device))
            torch.cuda.synchronize()
            (floor if replay else single)[model] = dp_step_result(
                torch, tr, m, counters, (store["differed"], store["made"]))
            if emd_inputs and not replay:
                # The EMD's own f32 floor: the loss in float64 on the
                # step's inputs.
                x1, x2 = emd_inputs["xyz"]
                single[model]["loss_f64"] = float(em.emd_forward_plain(
                    x1.double(), x2.double())[0].mean())
            tr.close()
            lg.close()
        if model == "model_emd":
            tr, lg = cli_train.build_trainer(parse(sp_step_argv(
                model, data, os.path.join(out_dir, "k6"), b, ranks=False)))
            k6_loss = float(tr.train_step(x.to(tr.device))["loss"])
            tr.close()
            lg.close()
        if model in SP_STEP_MODELS:
            _, i1, _, i2 = ch.nn_distance_cuda(y.cuda(), x.cuda())
            single[model]["nn"] = (i2.cpu(), i1.cpu())
        if model == "model":
            single[model]["eval"] = emb.cpu()
        torch.save({"x": x, "y": y, "choices": choices},
                   os.path.join(out_dir, f"{model}_sp_case.pt"))

    t0 = time.perf_counter()
    mesh.launch(sp_rank_steps, devices=cards, backend="gloo",
                args=(out_dir, data))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"sp_rank{r}.pt"))
             for r in range(SP_RANKS)]
    for model in SP_STEP_MODELS:
        say("point_parallel", grouped_held(
            torch, f"{model} SP 2 ranks over gloo (tape)",
            [r["captured"][model] for r in ranks]) + " ok")
    chamfer_calls = {"model_cpu": 0, "model_hierachy": 2}
    for model in SP_STEP_MODELS + SP_FAMILIES:
        one, fl = single[model], floor[model]
        got = [r[model] for r in ranks]
        b = BATCH if model in SP_STEP_MODELS else SP_FAMILY_BATCH
        calls = chamfer_calls.get(model, 1)
        want = with_bn({"fused_head_fwd": 1, "fused_head_bwd": 1,
                        "nn_distance": calls,
                        "nn_distance_grad": 0 if model == "model_emd"
                        else calls,
                        "emd_forward": 0, "fused_encoder_eval": 0}, model, 1)
        for r, g in enumerate(got):
            require(g["launches"] == want,
                    f"{model} SP step rank {r} launches {g['launches']}, the "
                    f"path needs {want}")
        require(all(torch.equal(t, got[1]["grads"][n])
                    for n, t in got[0]["grads"].items())
                and all(torch.equal(t, got[1]["buffers"][n])
                        for n, t in got[0]["buffers"].items()),
                f"{model} SP step: the ranks' gradients or BN statistics "
                f"differ after the sum")
        # The loss at rtol 1e-5, raised to twice the rolled points' own
        # gap where that is larger, and for model_emd to twice the card
        # alone's f32 EMD's distance to its float64 value on the same
        # inputs (the ranks sum shorter column sums: the 10 annealing
        # levels amplify their rounding past the rolled points' gap).
        loss, want_loss = (sum(g["scalars"]["loss"] for g in got),
                           one["scalars"]["loss"])
        loss_floor = max(abs(fl["scalars"]["loss"] - want_loss),
                         abs(one.get("loss_f64", want_loss) - want_loss))
        require(abs(loss - want_loss) <= max(1e-5 * abs(want_loss),
                                             2 * loss_floor),
                f"{model} SP loss {loss} vs the card alone {want_loss} "
                f"(rtol 1e-5; the rolled points read "
                f"{fl['scalars']['loss']})")
        floored = 0
        for n, want_b in one["buffers"].items():
            want_b = want_b.numpy()
            err = np.abs(got[0]["buffers"][n].numpy() - want_b)
            bound_ = 1e-6 + 1e-4 * np.abs(want_b)
            reorder = float(np.abs(fl["buffers"][n].numpy() - want_b).max())
            floored += int((err > bound_).sum())
            require(bool(np.all(err <= np.maximum(bound_, 2 * reorder))),
                    f"{model} SP BN statistic {n}: max abs err "
                    f"{float(err.max()):.3e} past rtol 1e-4, atol 1e-6 and "
                    f"twice the rolled batch's largest gap {reorder:.3e}")
        sp_leaf, sp_whole, sp_norm = dp_gaps(got[0]["grads"], one["grads"])
        fl_leaf, fl_whole, fl_norm = dp_gaps(fl["grads"], one["grads"])
        require(sp_whole <= max(1e-5, 2 * fl_whole)
                and sp_norm <= max(1e-5, 2 * fl_norm),
                f"{model} SP gradients: {sp_whole:.3e} of the largest "
                f"element, relative norm {sp_norm:.3e}; the rolled points "
                f"on one card {fl_whole:.3e}, {fl_norm:.3e}")
        extra = ""
        if model in SP_STEP_MODELS:
            i1 = torch.cat([g["nn"][0] for g in got], dim=1)
            require(torch.equal(i1, one["nn"][0])
                    and all(torch.equal(g["nn"][1], one["nn"][1])
                            for g in got),
                    f"{model}: the combined Chamfer indices differ from "
                    f"K1's on the card alone")
            extra = "; combined Chamfer indices equal to K1's on one card"
        if model == "model_emd":
            # The SP EMD against the EMD the card trains on (K6): within
            # twice the larger of K6's gap to the dense form and the dense
            # form's own floor.
            k6_gap = 2 * max(abs(k6_loss - want_loss), loss_floor)
            require(abs(loss - k6_loss) <= k6_gap,
                    f"model_emd SP loss {loss} vs the card alone's step on "
                    f"K6 {k6_loss}: past {k6_gap:.3e}")
            extra += (f"; the card alone's step on K6 reads loss "
                      f"{k6_loss:.6f}, the SP loss within {k6_gap:.3e} of "
                      f"it")
        say("point_parallel", f"{model} f32 step, B={b} N={NUM_POINT}, 2 "
            f"ranks of {NUM_POINT // SP_RANKS} points vs one card: loss "
            f"{loss:.6f} vs {want_loss:.6f}, the rolled points "
            f"{fl['scalars']['loss']:.6f}"
            + (f", float64 {one['loss_f64']:.6f}" if "loss_f64" in one
               else "")
            + f" (held at rtol 1e-5 or twice the floor); BN statistics: "
            f"{floored} entries past rtol 1e-4, atol 1e-6 (held within twice the rolled batch's gap); gradient "
            f"gap {sp_whole:.3e} of its largest element, largest leaf gap "
            f"{sp_leaf:.3e}, relative norm {sp_norm:.3e}; the rolled points "
            f"on one card (f32 floor): {fl_whole:.3e}, {fl_leaf:.3e}, "
            f"{fl_norm:.3e}; the ranks' own choices differed at "
            f"{got[0]['flips'][0]} + {got[1]['flips'][0]} of "
            f"{got[0]['flips'][1] + got[1]['flips'][1]}; per-rank launches "
            f"{got[0]['launches']}{extra} ok")
    embs = [r["model"]["eval"] for r in ranks]
    require(all(torch.equal(e[0], single["model"]["eval"]) and e[1] == 1
                for e in embs),
            f"SP eval embedding vs one card: equal "
            f"{[torch.equal(e[0], single['model']['eval']) for e in embs]}, "
            f"K5 launches {[e[1] for e in embs]}")
    require(ranks[0]["bf16"] == ranks[1]["bf16"],
            "--point_parallel --bf16_params: the ranks' states differ after "
            "3 steps")
    say("point_parallel", f"f32 eval embedding of B={BATCH}, each rank's "
        f"K5 once on its points and the extrema combined: bit-equal to the "
        f"card alone's; --point_parallel --bf16_params, 3 steps: the ranks' "
        f"weights, slots and step bit-equal; the ranks' run took "
        f"{ranks_s:.1f} s ok")
    for r, rep in enumerate(ranks):
        for model, (med, lo, hi, trace, peak) in rep["timing"].items():
            say("point_parallel", f"rank {r}: {model} bf16 SP step on its "
                f"{NUM_POINT // SP_RANKS} points of B={BATCH} (2 ranks on "
                f"one H100 over gloo; host clock to the loss): median "
                f"{med:.3f} ms, min {lo:.3f}, max {hi:.3f}; traced: {trace}; "
                f"peak device memory {peak:.1f} MiB")

    # 2. cli.train --point_parallel: 2 bf16 epochs of device input.
    log_dir = os.path.join(out_dir, "train_log")
    t0 = time.perf_counter()
    cli_train.main(train_argv("model", data, log_dir)
                   + ["--max_epoch", str(TRAIN_EPOCHS), "--point_parallel",
                      "--data_parallel", str(SP_RANKS)],
                   devices=cards, backend="gloo",
                   after=functools.partial(rank_report, out_dir, "train"))
    train_s = time.perf_counter() - t0
    reps = []
    for r in range(SP_RANKS):
        with open(os.path.join(out_dir, f"train_rank{r}.json")) as f:
            reps.append(json.load(f))
    want = path_launches(TRAIN_EPOCHS * (320 // BATCH),
                         TRAIN_EPOCHS * (64 // BATCH))
    for r, rep in enumerate(reps):
        require(rep["sp"] and rep["launches"] == want,
                f"SP training rank {r}: point-parallel {rep['sp']}, launches "
                f"{rep['launches']}, the path needs {want}")
    require(reps[0]["hash"] == reps[1]["hash"],
            "SP training: the ranks' states differ after 2 epochs")
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    evals = [r["pcloss"] for r in recs if r["split"] == "test"]
    require(len(evals) == TRAIN_EPOCHS and all(np.isfinite(evals))
            and evals[-1] < evals[0], f"SP eval pcloss {evals}")
    say("point_parallel", f"cli.train --point_parallel --data_parallel 2 on "
        f"cuda:0 twice (gloo), bf16, device input: {TRAIN_EPOCHS} epochs in "
        f"{train_s:.1f} s (rank start and data loading included); eval "
        f"pcloss {[round(v, 6) for v in evals]}; the ranks' states "
        f"bit-equal (sha256 {reps[0]['hash'][:16]}); per-rank launches "
        f"{reps[0]['launches']} ok")

    # 3. The kernels at the shard shapes, traced in a process of their own
    # (a fresh profiler: in one run the parent's traces of K4, after
    # dozens of earlier traces, kept 45 of 50 events in each of 6
    # attempts).
    mesh.launch(sp_kernel_rank, devices=["cuda:0"], backend="gloo",
                args=(out_dir,))
    with open(os.path.join(out_dir, "kernel_times.json")) as f:
        for line in json.load(f):
            say("point_parallel", f"device time per call, median of 50 "
                f"traced calls, at one rank's shard: {line}")
    say("point_parallel", f"phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase fastio: the native loader
# ---------------------------------------------------------------------------


def phase_fastio(data, tmp):
    """The data loader's native parser (csrc/fastio.cpp, built with g++)
    against its numpy version on every file of the fixture, and both
    against the files the JAX package's loader rejects. See the module
    docstring, phase 16."""
    import glob

    from pointnet_autoencoder_tpu_torch.data import fastio

    pts = sorted(glob.glob(os.path.join(data, "*", "points", "*.pts")))
    segs = sorted(glob.glob(os.path.join(data, "*", "points_label",
                                         "*.seg")))
    require(len(pts) == len(segs) == 384, f"{len(pts)} .pts, {len(segs)} "
            f".seg files in the fixture")
    times = {}
    decoded = {}
    for path_kind, load in (("native", (fastio.load_pts, fastio.load_seg)),
                            ("numpy", (fastio.load_pts_numpy,
                                       fastio.load_seg_numpy))):
        t0 = time.perf_counter()
        decoded[path_kind] = ([load[0](p) for p in pts],
                              [load[1](p) for p in segs])
        times[path_kind] = time.perf_counter() - t0
    for a, b in zip(decoded["native"][0] + decoded["native"][1],
                    decoded["numpy"][0] + decoded["numpy"][1]):
        require(a.dtype == b.dtype and np.array_equal(a, b),
                "a native decode differs from np.loadtxt's")
    bad = os.path.join(tmp, "f1")
    os.makedirs(bad)
    files = {"normals.pts": ("1 2 3 0.1 0.2 0.3\n4 5 6 0.4 0.5 0.6\n",
                             "expected 3 columns, found 6"),
             "twocol.seg": ("1 0.9\n2 0.8\n", "expected 1 columns, found 2"),
             "ragged.pts": ("1 2 3\n4 5\n", "")}
    refused = []
    for name, (text, message) in files.items():
        path = os.path.join(bad, name)
        with open(path, "w") as f:
            f.write(text)
        kind = "pts" if name.endswith(".pts") else "seg"
        for load in (getattr(fastio, f"load_{kind}"),
                     getattr(fastio, f"load_{kind}_numpy")):
            try:
                load(path)
            except ValueError as e:
                require(message in str(e), f"{load.__name__}({name}): {e}")
                refused.append(f"{load.__name__}({name})")
                continue
            raise RuntimeError(f"{load.__name__} accepted {name}")
    npts = sum(len(p) for p in decoded["native"][0])
    say("fastio", f"{len(pts)} .pts and {len(segs)} .seg files "
        f"({npts} points): native decode bit-equal to np.loadtxt's; host "
        f"time native {times['native']:.3f} s, numpy {times['numpy']:.3f} s "
        f"(host clock, this machine's CPU); refused on both paths: "
        f"{', '.join(refused)} ok")


# ---------------------------------------------------------------------------
# Phase tensor_parallel: the decoder's FC layers over 2 ranks
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_STEP_MODELS = ("model", "model_emd")


def tp_rank_steps(device, out_dir, data):
    """A rank of phase tensor_parallel: for each model of TP_STEP_MODELS,
    one f32 train step through ``cli.train``'s build (``--model_parallel
    2``) on the card alone's batch, replaying its choices, with the
    launches counted, and the gradients and BN statistics gathered over
    the model group; the split leaves' shapes of `model_hierachy` and
    `model_fc_upconv`. Writes ``<out_dir>/tp_rank<r>.pt``."""
    import torch

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
    from pointnet_autoencoder_tpu_torch.parallel import tp

    counters = kernel_counters(ch, fe, fh, em)
    parse = cli_train.build_parser().parse_args
    out = {}
    for model in TP_STEP_MODELS:
        case = torch.load(os.path.join(out_dir, f"{model}_tp_case.pt"))
        tr, lg = cli_train.build_trainer(parse(dp_step_argv(
            model, data, os.path.join(out_dir, f"{model}_tp_log"))
            + ["--model_parallel", str(TP_RANKS)]))
        group = tr.model_group
        require(group is not None and group.world_size == TP_RANKS,
                "the Trainer holds no model group of 2")
        store = dict(case["choices"], differed=0, made=0)
        for fn in counters.values():
            fn.launches = 0
        with dp_choices(store, replay=True, cols=(group.rank, TP_RANKS)):
            m = tr.train_step(case["x"].to(tr.device))
        torch.cuda.synchronize()

        def full(name, t):
            dim = tp.spec_for_name(name)
            return (t if dim is None else tp.gather_tensor(t, dim, group)
                    ).detach().cpu()

        params = dict(tr.model.named_parameters())
        out[model] = dict(
            scalars={k: float(m[k]) for k in ("loss", "pcloss")},
            grads={n: full(n, p.grad) for n, p in params.items()},
            buffers={n: full(n, b) for n, b in tr.model.named_buffers()},
            replicated=tree_bytes_hash(torch, {
                n: params[n].grad for n in tp.replicated_names(tr.model)
                if n in params}),
            launches={n: fn.launches for n, fn in counters.items()},
            flips=(store["differed"], store["made"]),
            fc1=tuple(params["decoder.fc1.dense.weight"].shape))
        tr.close()
        lg.close()
    shapes = {}
    for model, n in (("model_hierachy", NUM_POINT),
                     ("model_fc_upconv", NUM_POINT)):
        net = get_model_spec(model).make(n).to(device)
        net.set_model_group(group)
        shapes[model] = {k: tuple(v.shape) for k, v in
                         net.state_dict().items()
                         if tp.spec_for_name(k) is not None}
    out["shapes"] = shapes
    # The bf16 Trainer captured (a tape over gloo) beside eager.
    out["captured"] = grouped_captured(
        torch, counters, train_argv("model", data, os.path.join(
            out_dir, "tp_captured_log"))
        + ["--model_parallel", str(TP_RANKS)],
        case["x"].cuda(), "chip_smoke.tp.model")
    torch.save(out, os.path.join(out_dir, f"tp_rank{group.rank}.pt"))


def phase_tensor_parallel(torch, counters, data, tmp, rng):
    """Tensor parallelism on the one card: 2 ranks over gloo on cuda:0.
    See the module docstring, phase 17."""
    import functools

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp, "tp")
    os.makedirs(out_dir)
    parse = cli_train.build_parser().parse_args
    cards = ["cuda:0"] * TP_RANKS
    say("tensor_parallel", f"2 ranks sharing one H100 over gloo "
        f"({nvidia_smi_line()}), each with half of the decoder's fc1, fc2 "
        f"and fc3 and every row; nothing here is a multi-card time or a "
        f"speedup")

    # 1. The card alone: each model's f32 step, its choices recorded, and
    # the same step with the batch's rows swapped in pairs (the f32
    # floor, PR 9's).
    x = clouds(np.random.RandomState(SEED + 70), BATCH, NUM_POINT)
    pairs = torch.from_numpy(
        np.arange(BATCH).reshape(-1, 2)[:, ::-1].reshape(-1).copy())
    single, floor = {}, {}
    for model in TP_STEP_MODELS:
        choices = {}
        for run, (replay, rows) in enumerate(((False, slice(None)),
                                              (True, pairs))):
            tr, lg = cli_train.build_trainer(parse(dp_step_argv(
                model, data, os.path.join(out_dir, f"{model}_{run}_log"))))
            store = dict(choices, differed=0, made=0) if replay else choices
            for fn in counters.values():
                fn.launches = 0
            with dp_choices(store, replay=replay, rows=rows):
                m = tr.train_step(torch.from_numpy(x)[rows].to(tr.device))
            torch.cuda.synchronize()
            (floor if replay else single)[model] = dp_step_result(
                torch, tr, m, counters)
            tr.close()
            lg.close()
        torch.save({"x": torch.from_numpy(x), "choices": choices},
                   os.path.join(out_dir, f"{model}_tp_case.pt"))

    t0 = time.perf_counter()
    mesh.launch(tp_rank_steps, devices=cards, backend="gloo",
                args=(out_dir, data))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"tp_rank{r}.pt"))
             for r in range(TP_RANKS)]
    say("tensor_parallel", grouped_held(
        torch, "model TP 1 x 2 ranks over gloo (tape)",
        [r["captured"] for r in ranks]) + " ok")
    want_launches = {
        "model": with_bn({"fused_head_fwd": 1, "fused_head_bwd": 1,
                          "nn_distance": 1, "nn_distance_grad": 1,
                          "emd_forward": 0, "fused_encoder_eval": 0},
                         "model", 1),
        "model_emd": with_bn({"fused_head_fwd": 1, "fused_head_bwd": 1,
                              "nn_distance": 1, "nn_distance_grad": 0,
                              "emd_forward": 1, "fused_encoder_eval": 0},
                             "model_emd", 1)}
    for model in TP_STEP_MODELS:
        one, fl = single[model], floor[model]
        got = [r[model] for r in ranks]
        for r, g in enumerate(got):
            require(g["launches"] == want_launches[model],
                    f"{model} TP step rank {r} launches {g['launches']}")
            require(g["fc1"] == (1024 // TP_RANKS, 1024),
                    f"{model} TP rank {r} fc1 weight {g['fc1']}")
        require(got[0]["replicated"] == got[1]["replicated"],
                f"{model} TP step: the replicated leaves' gradients differ "
                f"across the model group")
        require(all(torch.equal(t, got[1]["grads"][n])
                    for n, t in got[0]["grads"].items()),
                f"{model} TP step: the ranks' gathered gradients differ")
        loss = got[0]["scalars"]["loss"]
        want_loss = one["scalars"]["loss"]
        require(close(loss, want_loss, 1e-4, 0.0)
                and close(got[0]["scalars"]["pcloss"],
                          one["scalars"]["pcloss"], 1e-4, 0.0),
                f"{model} TP loss {loss} vs one card {want_loss} (rtol "
                f"1e-4)")
        buf_err = 0.0
        for n, b in one["buffers"].items():
            b = b.numpy()
            err = np.abs(got[0]["buffers"][n].numpy() - b)
            require(bool(np.all(err <= 2e-5 + 1e-4 * np.abs(b))),
                    f"{model} TP BN statistic {n}: max abs err "
                    f"{float(err.max()):.3e} past rtol 1e-4, atol 2e-5")
            buf_err = max(buf_err, float(err.max()))
        tp_leaf, tp_whole, tp_norm = dp_gaps(got[0]["grads"], one["grads"])
        fl_leaf, fl_whole, fl_norm = dp_gaps(fl["grads"], one["grads"])
        require(tp_whole <= max(1e-5, 2 * fl_whole)
                and tp_norm <= max(1e-5, 2 * fl_norm),
                f"{model} TP gradients: {tp_whole:.3e} of the largest "
                f"element, relative norm {tp_norm:.3e}; the reordered batch "
                f"on one card {fl_whole:.3e}, {fl_norm:.3e}")
        say("tensor_parallel", f"{model} f32 step, B={BATCH} N={NUM_POINT}, "
            f"1 data x 2 model ranks on cuda:0 (gloo) vs one card: loss "
            f"{loss:.6f} vs {want_loss:.6f} (rtol 1e-4); BN statistics "
            f"within rtol 1e-4, atol 2e-5 (largest abs gap {buf_err:.3e}); "
            f"gathered gradient gap {tp_whole:.3e} of its largest element, "
            f"largest leaf gap {tp_leaf:.3e}, relative norm {tp_norm:.3e}; "
            f"the same step on one card with the batch's rows swapped in "
            f"pairs (f32 floor): {fl_whole:.3e}, {fl_leaf:.3e}, "
            f"{fl_norm:.3e}; replicated leaves' gradients bit-equal across "
            f"the model group; the ranks' own choices differed at "
            f"{got[0]['flips'][0]} + {got[1]['flips'][0]} of "
            f"{got[0]['flips'][1] + got[1]['flips'][1]}; per-rank launches "
            f"{got[0]['launches']} ok")
    for model, shapes in ranks[0]["shapes"].items():
        say("tensor_parallel", f"{model} split leaves per rank: "
            + ", ".join(f"{k} {v}" for k, v in shapes.items()))
    say("tensor_parallel", f"the 2-rank step run took {ranks_s:.1f} s")

    # 2. cli.train --model_parallel 2 --bf16_params: 2 bf16 epochs.
    log_dir = os.path.join(out_dir, "train_log")
    t0 = time.perf_counter()
    cli_train.main(train_argv("model", data, log_dir)
                   + ["--max_epoch", str(TRAIN_EPOCHS), "--model_parallel",
                      str(TP_RANKS), "--bf16_params"],
                   devices=cards, backend="gloo",
                   after=functools.partial(tp_train_report, out_dir))
    train_s = time.perf_counter() - t0
    reps = []
    for r in range(TP_RANKS):
        with open(os.path.join(out_dir, f"tp_train_rank{r}.json")) as f:
            reps.append(json.load(f))
    want = path_launches(TRAIN_EPOCHS * (320 // BATCH),
                         TRAIN_EPOCHS * (64 // BATCH))
    for r, rep in enumerate(reps):
        require(rep["launches"] == want,
                f"TP training rank {r}: launches {rep['launches']}, the path "
                f"needs {want}")
    require(reps[0]["replicated"] == reps[1]["replicated"],
            "TP --bf16_params: the replicated leaves differ across the "
            "model group after 2 epochs")
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    evals = [r["pcloss"] for r in recs if r["split"] == "test"]
    require(len(evals) == TRAIN_EPOCHS and all(np.isfinite(evals))
            and evals[-1] < evals[0], f"TP eval pcloss {evals}")
    bests = sorted(n for n in os.listdir(log_dir)
                   if n.startswith("best_model_epoch_"))
    require(bool(bests), f"TP training checkpoints: {os.listdir(log_dir)}")
    say("tensor_parallel", f"cli.train --model_parallel 2 --bf16_params on "
        f"cuda:0 twice (gloo), bf16, device input: {TRAIN_EPOCHS} epochs in "
        f"{train_s:.1f} s (rank start and data loading included); eval "
        f"pcloss {[round(v, 6) for v in evals]}; the replicated leaves "
        f"bit-equal across the model group (sha256 "
        f"{reps[0]['replicated'][:16]}); per-rank launches "
        f"{reps[0]['launches']} ok")
    for r, rep in enumerate(reps):
        med, lo, hi = rep["step_host_ms"]
        say("tensor_parallel", f"rank {r}: bf16 TP step of B={BATCH} (2 "
            f"ranks on one H100 over gloo; host clock to the loss): median "
            f"{med:.3f} ms, min {lo:.3f}, max {hi:.3f}; traced: "
            f"{rep['trace']}; peak device memory {rep['peak_mb']:.1f} MiB")

    # 3. The gathered checkpoint on one card against the split session.
    best = os.path.join(log_dir, bests[-1])
    one = InferenceSession("model", best, NUM_POINT, batch_size=BATCH,
                           device="cuda")
    split = InferenceSession("model", best, NUM_POINT, batch_size=BATCH,
                             devices=cards, model_parallel=TP_RANKS)
    batch = clouds(rng, 45, NUM_POINT)
    emb = one.embed(batch)
    gaps = {}
    for what, a, b in (("reconstruct", split.reconstruct(batch),
                        one.reconstruct(batch)),
                       ("embed", split.embed(batch), emb),
                       ("decode", split.decode(emb), one.decode(emb))):
        require(close(a, b, 1e-5, 1e-5),
                f"TP serving {what}: max abs err {max_err(a, b):.3e}")
        gaps[what] = max_err(a, b)
    say("tensor_parallel", f"the TP run's best checkpoint "
        f"({os.path.basename(best)}, the one-card format) in a one-card "
        f"session and in InferenceSession(model_parallel=2) on cuda:0 "
        f"twice, f32, a ragged batch of 45: max abs gap "
        + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
        + " (rtol, atol 1e-5) ok")
    say("tensor_parallel", f"phase took {time.perf_counter() - t_phase:.1f} s")


def tp_train_report(out_dir, trainer):
    """``after`` of phase tensor_parallel's ``cli.train`` run, in each
    rank: the launches of the whole run, a hash of the replicated leaves,
    the host median of 10 bf16 steps on a batch already on the card and a
    trace of one, the peak device memory. Writes
    ``<out_dir>/tp_train_rank<r>.json``."""
    import torch

    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
    from pointnet_autoencoder_tpu_torch.parallel import tp

    launches = {n: fn.launches for n, fn in
                kernel_counters(ch, fe, fh, em).items()}
    sd = trainer.model.state_dict()
    replicated = tree_bytes_hash(torch, {
        n: sd[n] for n in tp.replicated_names(trainer.model)})
    x = torch.from_numpy(clouds(np.random.RandomState(SEED + 72), BATCH,
                                NUM_POINT)).to(trainer.device)
    torch.cuda.reset_peak_memory_stats(trainer.device)
    *host, trace = step_timing(torch, trainer, x, "chip_smoke.tp_step")
    with open(os.path.join(out_dir, f"tp_train_rank{trainer.rank}.json"),
              "w") as f:
        json.dump(dict(launches=launches, replicated=replicated,
                       step_host_ms=host, trace=trace,
                       peak_mb=torch.cuda.max_memory_allocated(
                           trainer.device) / 2**20), f)


# ---------------------------------------------------------------------------
# Phase pipeline_parallel: the encoder and the decoder as two stages
# ---------------------------------------------------------------------------

PP_MICROBATCHES = 4


def phase_pipeline_parallel(torch, fe, session, weights, rng):
    """Pipeline-parallel serving on the one card. See the module
    docstring, phase 18."""
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.parallel.pp import PipelinedSession

    t_phase = time.perf_counter()
    x = clouds(rng, BATCH, NUM_POINT)
    bf16 = InferenceSession("model", weights, NUM_POINT, batch_size=BATCH,
                            bf16=True, device="cuda")
    for kind, ref in (("f32", session), ("bf16", bf16)):
        pp = PipelinedSession(ref, devices=["cuda:0", "cuda:0"],
                              num_microbatches=PP_MICROBATCHES)
        emb = ref.embed(x)
        gaps, past = {}, {}
        for what, a, b in (("reconstruct", pp.reconstruct(x),
                            ref.reconstruct(x)),
                           ("embed", pp.embed(x), emb),
                           ("decode", pp.decode(emb), ref.decode(emb))):
            gaps[what] = max_err(a, b)
            past[what] = int((np.abs(a - b) > 1e-6 + 1e-5 * np.abs(b)).sum())
            require(past[what] == 0,
                    f"PP {kind} {what}: {past[what]} entries past rtol 1e-5, "
                    f"atol 1e-6 of the unpipelined session (max abs gap "
                    f"{gaps[what]:.3e})")
        fe.encoder_extrema_cuda.launches = 0
        pp.reconstruct(x)
        k5 = fe.encoder_extrema_cuda.launches
        require(k5 == PP_MICROBATCHES,
                f"PP {kind}: K5 launched {k5} times for one batch, not once "
                f"per microbatch")
        host_pp, host_one = [], []
        for _ in range(10):
            for s, into in ((pp, host_pp), (ref, host_one)):
                t0 = time.perf_counter()
                s.reconstruct(x)
                into.append(1e3 * (time.perf_counter() - t0))
        trace = device_trace(torch, lambda: pp.reconstruct(x),
                             f"chip_smoke.pp_{kind}", own=True)
        say("pipeline_parallel", f"{kind}, B={BATCH} in {PP_MICROBATCHES} "
            f"microbatches, both stages on cuda:0 (a stream each): "
            f"reconstruct, embed and decode against the unpipelined "
            f"session, max abs gap "
            + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
            + f" (rtol 1e-5, atol 1e-6; entries past it {past}); K5 "
            f"{k5} launches per batch; reconstruct host median "
            f"{statistics.median(host_pp):.3f} ms pipelined vs "
            f"{statistics.median(host_one):.3f} ms unpipelined (same call, "
            f"one H100, {nvidia_smi_line()}); pipelined trace: {trace} ok")
    say("pipeline_parallel",
        f"phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase dp_sp: 2 data x 2 point ranks
# ---------------------------------------------------------------------------

DPSP_DATA = 2
DPSP_POINT = 2
DPSP_STEPS = 5


def dp_sp_rank_steps(device, out_dir):
    """A rank of phase dp_sp on a (2 data, 2 model) grid: for `model` and
    `model_emd`, one f32 step of ``sp.make_sp_step_fns(..., axis=
    MODEL_AXIS, batch_axis=DATA_AXIS)`` from the card alone's weights on
    this rank's rows and points of its batch, with the launches counted;
    the combined Chamfer indices of (its points, its rows of a second
    batch).
    Writes ``<out_dir>/dpsp_rank<r>.pt``."""
    import torch

    from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_encoder as fe
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh
    from pointnet_autoencoder_tpu_torch.parallel import mesh, sp
    from pointnet_autoencoder_tpu_torch.train import schedules
    from pointnet_autoencoder_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    grid = mesh.ProcessMesh(device, DPSP_POINT)
    axes = (mesh.MODEL_AXIS, mesh.DATA_AXIS)
    counters = kernel_counters(ch, fe, fh, em)
    out = {}
    for model in ("model", "model_emd"):
        case = torch.load(os.path.join(out_dir, f"{model}_dpsp_case.pt"))
        net = get_model_spec(model).make(NUM_POINT)
        net.load_state_dict(case["state"])
        net.to(device)
        state = TrainState(net, make_optimizer("adam", net.parameters()),
                           schedules.learning_rate_schedule(
                               0.001, 0.7, BATCH, 200000))
        # The BN momentum, constant: a staircase of rate 1.
        step, _ = sp.make_sp_step_fns(
            state, model, schedules.Staircase(case["momentum"], 1.0, 1, 1),
            grid, *axes)
        x = case["x"].to(device)
        xl = sp.point_batch_shard(x, grid, *axes)
        per = BATCH // DPSP_DATA
        rows = slice(grid.data_index * per, (grid.data_index + 1) * per)
        with torch.no_grad():
            _, i1, _, i2 = sp.nn_distance_point_sharded(
                xl, case["y"][rows].to(device), grid.model)
        for fn in counters.values():
            fn.launches = 0
        m = step(xl)
        torch.cuda.synchronize()
        out[model] = dict(
            scalars={k: float(m[k]) for k in ("loss", "pcloss")},
            buffers={n: b.detach().cpu() for n, b in net.named_buffers()},
            launches={n: fn.launches for n, fn in counters.items()},
            nn=(i1.cpu(), i2.cpu()), shape=tuple(xl.shape))

    # The step functions captured (a tape over gloo) beside eager, from
    # the card alone's `model` weights: TRAIN_EPOCHS epochs of DPSP_STEPS
    # batches made on the card, an eval step after each epoch.
    case = torch.load(os.path.join(out_dir, "model_dpsp_case.pt"))
    gen = torch.Generator(device=device).manual_seed(SEED + 83)
    batches = [sp.point_batch_shard(torch.rand(
        (BATCH, NUM_POINT, 3), generator=gen, device=device), grid, *axes)
        for _ in range(DPSP_STEPS)]
    runs, fns = {}, {}
    for compiled in (True, False):
        net = get_model_spec("model").make(NUM_POINT)
        net.load_state_dict(case["state"])
        net.to(device)
        state = TrainState(net, make_optimizer("adam", net.parameters()),
                           schedules.learning_rate_schedule(
                               0.001, 0.7, BATCH, 200000))
        step, evaluate = sp.make_sp_step_fns(
            state, "model", schedules.Staircase(case["momentum"], 1.0, 1, 1),
            grid, *axes, compiled=compiled)
        for fn in counters.values():
            fn.launches = 0
        evals = []
        for _ in range(TRAIN_EPOCHS):
            for xb in batches:
                step(xb)
            evals.append(float(evaluate(batches[0])["loss"]))
        torch.cuda.synchronize()
        runs[compiled] = dict(
            launches={n: fn.launches for n, fn in counters.items()},
            state=_host_state(torch, types.SimpleNamespace(state=state)),
            evals=evals, step=state.step,
            programs=None if not compiled else {
                k: (p.graphs, p.collectives)
                for k, p in step.programs._programs.items()})
        fns[compiled] = step
    timing = grouped_step_timing(torch, {
        c: (lambda step=step: step(batches[0])["loss"].item())
        for c, step in fns.items()}, "chip_smoke.dpsp")
    for c in runs:
        runs[c]["timing"] = timing[c]
    out["captured"] = runs
    torch.save(out, os.path.join(out_dir, f"dpsp_rank{grid.world.rank}.pt"))


def phase_dp_sp(torch, tmp):
    """DP x SP on the one card: 4 ranks over gloo on cuda:0. See the
    module docstring, phase 19."""
    from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
    from pointnet_autoencoder_tpu_torch.ops import chamfer as ch
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.parallel import mesh
    from pointnet_autoencoder_tpu_torch.train import schedules
    from pointnet_autoencoder_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )

    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp, "dpsp")
    os.makedirs(out_dir)
    ranks_n = DPSP_DATA * DPSP_POINT
    say("dp_sp", f"4 ranks sharing one H100 over gloo ({nvidia_smi_line()}):"
        f" 2 data x 2 point, each with {BATCH // DPSP_DATA} rows and "
        f"{NUM_POINT // DPSP_POINT} points of every shape; nothing here is "
        f"a multi-card time or a speedup")
    x = torch.from_numpy(clouds(np.random.RandomState(SEED + 80), BATCH,
                                NUM_POINT))
    y = torch.from_numpy(clouds(np.random.RandomState(SEED + 82), BATCH,
                                NUM_POINT))
    momentum = 0.5
    single = {}
    for model in ("model", "model_emd"):
        net = get_model_spec(model).make(
            NUM_POINT, generator=torch.Generator().manual_seed(SEED + 81))
        torch.save({"state": net.state_dict(), "x": x, "y": y,
                    "momentum": momentum},
                   os.path.join(out_dir, f"{model}_dpsp_case.pt"))
        net.to("cuda")
        state = TrainState(net, make_optimizer("adam", net.parameters()),
                           schedules.learning_rate_schedule(
                               0.001, 0.7, BATCH, 200000))
        # The card alone on the EMD's dense form: the per-shard form's.
        emd_inputs = {}
        emd = (plain_emd_on_the_card(emd_inputs) if model == "model_emd"
               else contextlib.nullcontext())
        with emd:
            m = state.train_step(x.cuda(), get_model_spec(model).loss_fn,
                                 schedules.Staircase(momentum, 1.0, 1, 1))
        torch.cuda.synchronize()
        single[model] = dict(
            scalars={k: float(m[k]) for k in ("loss", "pcloss")},
            buffers={n: b.detach().cpu() for n, b in net.named_buffers()})
        if emd_inputs:
            # The dense EMD's own f32 floor (PR 10's bound): its loss in
            # float64 on the step's inputs. Its 10 annealing levels amplify
            # the order of the column sums, which the ranks split.
            x1, x2 = emd_inputs["xyz"]
            single[model]["loss_f64"] = float(em.emd_forward_plain(
                x1.double(), x2.double())[0].mean())
    _, c1, _, c2 = ch.nn_distance_cuda(x.cuda(), y.cuda())
    t0 = time.perf_counter()
    mesh.launch(dp_sp_rank_steps, devices=["cuda:0"] * ranks_n,
                backend="gloo", args=(out_dir,))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"dpsp_rank{r}.pt"))
             for r in range(ranks_n)]
    say("dp_sp", grouped_held(
        torch, "model DP x SP 2 x 2 ranks over gloo (tape)",
        [r["captured"] for r in ranks],
        what=f"{TRAIN_EPOCHS} epochs of {DPSP_STEPS} steps of "
             f"make_sp_step_fns on batches made on the card, an eval step "
             f"after each") + " ok")
    per_b, per_n = BATCH // DPSP_DATA, NUM_POINT // DPSP_POINT
    for model in ("model", "model_emd"):
        one = single[model]
        # model_emd: K1 for the pcloss metric, no K2; the per-shard EMD is
        # the dense form (no K6).
        want_l = with_bn({"fused_head_fwd": 1, "fused_head_bwd": 1,
                          "nn_distance": 1,
                          "nn_distance_grad": 1 if model == "model" else 0,
                          "emd_forward": 0, "fused_encoder_eval": 0}, model,
                         1)
        idx_equal = True
        buf_err = 0.0
        for r, rank in enumerate(ranks):
            got = rank[model]
            d, t = divmod(r, DPSP_POINT)
            require(got["shape"] == (per_b, per_n, 3),
                    f"dp_sp rank {r} holds {got['shape']}")
            for key in ("loss", "pcloss"):
                want_v = one["scalars"][key]
                floor = (abs(one["loss_f64"] - want_v) if key == "loss"
                         and "loss_f64" in one else 0.0)
                require(abs(got["scalars"][key] - want_v)
                        <= max(1e-5 * abs(want_v), 2 * floor),
                        f"{model} DP x SP {key} {got['scalars'][key]} vs one "
                        f"card {want_v} (rtol 1e-5; twice the dense EMD's "
                        f"f32 floor {floor:.3e})")
            for n, b in one["buffers"].items():
                b = b.numpy()
                err = np.abs(got["buffers"][n].numpy() - b)
                require(bool(np.all(err <= 2e-5 + 1e-4 * np.abs(b))),
                        f"{model} DP x SP BN statistic {n}: max abs err "
                        f"{float(err.max()):.3e} past rtol 1e-4, atol 2e-5")
                buf_err = max(buf_err, float(err.max()))
            rows = slice(d * per_b, (d + 1) * per_b)
            pts = slice(t * per_n, (t + 1) * per_n)
            i1, i2 = got["nn"]
            idx_equal &= (torch.equal(i1, c1[rows, pts].cpu())
                          and torch.equal(i2, c2[rows].cpu()))
            require(got["launches"] == want_l,
                    f"{model} DP x SP rank {r} launches {got['launches']}, "
                    f"the path needs {want_l}")
        require(idx_equal, f"{model} DP x SP: the combined Chamfer indices "
                f"differ from K1's on the card alone")
        say("dp_sp", f"{model} f32 step, B={BATCH} N={NUM_POINT}, 2 data x "
            f"2 point ranks on cuda:0 (gloo) vs one card"
            + (" (its EMD in the dense form, the ranks' per-shard form)"
               if model == "model_emd" else "")
            + f": loss {ranks[0][model]['scalars']['loss']:.6f} vs "
            f"{one['scalars']['loss']:.6f}, pcloss "
            f"{ranks[0][model]['scalars']['pcloss']:.6f} vs "
            f"{one['scalars']['pcloss']:.6f} (rtol 1e-5"
            + (f"; the loss also within twice the dense EMD's f32 floor, "
               f"its float64 value {one['loss_f64']:.6f}"
               if "loss_f64" in one else "")
            + f"); BN statistics "
            f"within rtol 1e-4, atol 2e-5 (largest abs gap {buf_err:.3e}); "
            f"the combined Chamfer indices equal to K1's on one card; "
            f"per-rank launches {ranks[0][model]['launches']} ok")
    say("dp_sp", f"the 4-rank run took {ranks_s:.1f} s; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phases hwcheck and profile: the tooling
# ---------------------------------------------------------------------------

# The kernels ops/hwcheck.py reaches on the card. No contract
# differentiates through the conv5 head (as in the JAX package), so K4
# (fused_head_bwd) is left to the phases above.
HWCHECK_KERNELS = ("nn_distance", "nn_distance_grad", "fused_head_fwd",
                   "fused_encoder_eval", "emd_forward")


def phase_hwcheck(torch, counters):
    """The port's ops/hwcheck.py on the card, in this process. See the
    module docstring, phase 20."""
    import re

    from pointnet_autoencoder_tpu_torch.ops import hwcheck as hw

    t_phase = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    first = len(hw._RESULTS)
    # The whole pool: its first 8 shapes are the JAX package's, the CUDA
    # tiles' own boundaries come after them.
    draws = len(hw._FUZZ_POOL)
    rc = hw.main(["--device", "cuda", "--fuzz", str(draws)])
    seconds = time.perf_counter() - t_phase
    results = hw._RESULTS[first:]
    launches = {name: fn.launches for name, fn in counters.items()}
    require(rc == 0 and not hw._FAILURES,
            f"hwcheck returned {rc}; failures {hw._FAILURES}")
    require(all(launches[name] > 0 for name in HWCHECK_KERNELS),
            f"a kernel hwcheck reaches never launched: {launches}")
    # The largest error of each contract (its shapes and draws merged)
    # against its tolerance.
    worst = {}
    for name, err, tol in results:
        key = re.sub(r" \(B=[^)]*\)| large(-prime)?-N", "", name)
        if key not in worst or err > worst[key][0]:
            worst[key] = (err, tol, name)
    for key, (err, tol, name) in worst.items():
        say("hwcheck", f"{key}: largest {err:.3e} against tol {tol:.0e} "
            f"({name})")
    say("hwcheck", f"{len(results)} checks of {len(worst)} contracts "
        f"passed (the default sweep and {draws} fuzz draws) in "
        f"{seconds:.1f} s; launches {launches} (K4, fused_head_bwd, "
        f"left to the phases above) ok")


def trace_kernel_counts(path: str) -> dict:
    """Each device kernel's base name in a Chrome trace written by
    ``utils/profiling.trace`` -> its number of events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        if e.get("cat") == "kernel":
            base = _short(e.get("name", "")).split("<")[0]
            counts[base] = counts.get(base, 0) + 1
    return counts


# The path's __global__ kernels in a bf16 `model` epoch and the
# path_launches key each one follows.
PROFILE_KERNELS = {"nn_distance_kernel": "nn_distance",
                   "nn_distance_grad_kernel": "nn_distance_grad",
                   "head_fwd_mma_kernel": "fused_head_fwd",
                   "head_bwd_dx_kernel": "fused_head_bwd",
                   "head_bwd_dw_kernel": "fused_head_bwd",
                   "encoder_mma_kernel": "fused_encoder_eval",
                   "bn_apply_kernel": "batch_norm_fwd",
                   "bn_dx_kernel": "batch_norm_bwd"}


def phase_profile(torch, counters, data, tmp, rng):
    """``cli.train --profile_dir`` on the card, and ``StepTimer``. See the
    module docstring, phase 21."""
    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.utils.profiling import StepTimer

    t_phase = time.perf_counter()
    prof_dir = os.path.join(tmp, "profile")
    log_dir = os.path.join(tmp, "profile_log")
    argv = train_argv("model", data, log_dir) + [
        "--profile_dir", prof_dir, "--max_epoch", str(TRAIN_EPOCHS)]
    for fn in counters.values():
        fn.launches = 0
    trainer, logger = cli_train.build_trainer(
        cli_train.build_parser().parse_args(argv))
    try:
        # Each epoch's wall clock from its start to the next one's (its
        # train steps, eval, trace and saves).
        starts = []
        real_epoch = trainer.train_one_epoch

        def timed_epoch(epoch):
            starts.append(time.perf_counter())
            return real_epoch(epoch)

        trainer.train_one_epoch = timed_epoch
        trainer.train()
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        walls = [b - a for a, b in zip(starts, starts[1:])]
        steps = len(trainer.train_pipe)
        evals = len(trainer.eval_pipe)
        got = {k: counters[k].launches for k in counters}
        require(got == path_launches(TRAIN_EPOCHS * steps,
                                     TRAIN_EPOCHS * evals),
                f"launches {got} in {TRAIN_EPOCHS} epochs")
        files = sorted(os.listdir(prof_dir))
        require(len(files) == 1 and files[0].endswith(".json"),
                f"profile dir holds {files}, not one trace")
        path = os.path.join(prof_dir, files[0])
        counts = trace_kernel_counts(path)
        want = path_launches(steps, evals)
        expected = {k: want[key] for k, key in PROFILE_KERNELS.items()}
        seen = {k: counts.get(k, 0) for k in PROFILE_KERNELS}
        require(seen == expected,
                f"the first epoch's trace holds {seen} of the path's "
                f"kernels, one epoch launches {expected}")
        with open(os.path.join(log_dir, "log_train.txt")) as f:
            text = f.read()
        require(text.count(f"profiler trace written to {prof_dir}") == 1,
                "the log does not say once where the trace went")
        phases = [line for line in text.splitlines()
                  if line.startswith("step phases on the device")]
        require(len(phases) == 1, f"the log's phase lines: {phases}")
        tensorboard = ("made" if getattr(logger, "_tb", None) else
                       "not made (torch.utils.tensorboard does not import)")
        say("profile", f"cli.train --profile_dir, {TRAIN_EPOCHS} bf16 "
            f"epochs of {steps} steps and {evals} eval batches: one trace "
            f"({os.path.getsize(path) / 1e6:.1f} MB, "
            f"{sum(counts.values())} kernel events) of the first epoch, "
            f"the path's kernels in it {seen} as one epoch launches; "
            f"epoch wall clock profiled {walls[0]:.3f} s, unprofiled "
            f"{walls[1]:.3f} s; TensorBoard writers {tensorboard}; the log "
            f"line ok; {phases[0]}")

        # The background saves of the run's last epoch end first, so both
        # timings see the same host.
        trainer.flush()
        x = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to("cuda")
        med, lo, hi, trace = step_timing(torch, trainer, x, "profile_step")
        # StepTimer's steps in turns with steps on step_timing's clock (to
        # the loss on the host), so that the host's drift between two
        # windows of 10 steps does not read as a disagreement.
        timer, host = StepTimer(), []
        for i in range(20):
            if i % 2 == (i // 2) % 2:
                with timer.step() as box:
                    box["result"] = trainer.train_step(x)
            else:
                t0 = time.perf_counter()
                trainer.train_step(x)["loss"].item()
                host.append(1e3 * (time.perf_counter() - t0))
        s = timer.summary()
        h_med = statistics.median(host)
        spread = max(host) - min(host)
        require(s["steps"] == 10 and abs(s["p50_ms"] - h_med) <= spread,
                f"StepTimer p50 {s['p50_ms']:.3f} ms against the host "
                f"clock's median {h_med:.3f} ms of the steps between "
                f"(spread {min(host):.3f}-{max(host):.3f})")
        say("profile", f"StepTimer over 10 bf16 steps: p50 "
            f"{s['p50_ms']:.3f} ms, p90 {s['p90_ms']:.3f}, p99 "
            f"{s['p99_ms']:.3f}, within the spread {spread:.3f} ms (min "
            f"{min(host):.3f}, max {max(host):.3f}) of step_timing's clock's "
            f"median {h_med:.3f} ms over 10 steps taken in turns with it; "
            f"step_timing before them: median {med:.3f} ms (min {lo:.3f}, "
            f"max {hi:.3f}), that step's trace: {trace} ok")
    finally:
        trainer.close()
        logger.close()
    say("profile", f"phase took {time.perf_counter() - t_phase:.1f} s")


def state_mb(torch, tree) -> float:
    """MB of the tensors in a (nested) state dict."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size() / 1e6
    if isinstance(tree, dict):
        return sum(state_mb(torch, v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(state_mb(torch, v) for v in tree)
    return 0.0


def phase_preempt(torch, data, tmp):
    """In this process, device-input training of ``model``; a thread sends
    SIGTERM after the first logged step. ``train()`` must return with a
    preemption checkpoint, ``--resume`` start at the same step, and the
    previous SIGTERM handler be back. Then the saver's snapshot check on
    the card: submit a snapshot, take a synchronous host copy of the same
    state, run 5 more steps, flush: the checkpoint equals the host copy bit
    for bit. Last, the training thread's time in a save of the model state,
    synchronous and in the background."""
    import itertools
    import signal

    from pointnet_autoencoder_tpu_torch.cli import train as cli_train
    from pointnet_autoencoder_tpu_torch.data.device_pipeline import (
        assemble_batch,
    )
    from pointnet_autoencoder_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    log_dir = os.path.join(tmp, "preempt_log")
    argv = train_argv("model", data, log_dir) + ["--max_epoch", "1000",
                                                 "--log_every", "1"]
    parser = cli_train.build_parser()
    trainer, logger = cli_train.build_trainer(parser.parse_args(argv))
    scalars = os.path.join(log_dir, "scalars.jsonl")
    previous = signal.getsignal(signal.SIGTERM)

    def send_sigterm_after_the_first_logged_step():
        for _ in range(1200):
            if os.path.exists(scalars) and os.path.getsize(scalars) > 0:
                break
            time.sleep(0.1)
        os.kill(os.getpid(), signal.SIGTERM)

    sender = threading.Thread(target=send_sigterm_after_the_first_logged_step)
    try:
        require(trainer.input_mode == "device"
                and trainer._saver is not None,
                "the preempt run is not device input with background saves")
        sender.start()
        t0 = time.perf_counter()
        trainer.train()
        train_s = time.perf_counter() - t0
        sender.join(timeout=130)
        steps = trainer.state.step
    finally:
        trainer.close()
        logger.close()
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        text = f.read()
    require("preemption checkpoint saved" in text and steps >= 1,
            f"no preemption checkpoint after {steps} steps")
    require(signal.getsignal(signal.SIGTERM) == previous,
            "the previous SIGTERM handler is not back")
    stored = checkpoint.load(checkpoint.CheckpointManager(log_dir).latest())
    resumed, rlogger = cli_train.build_trainer(parser.parse_args(
        argv + ["--resume"]))
    try:
        require(resumed.state.step == steps == stored["step"]
                and resumed.start_epoch == stored["epoch"],
                f"resume at step {resumed.state.step} epoch "
                f"{resumed.start_epoch}; preempted at {steps}, stored "
                f"{stored['step']}/{stored['epoch']}")
        say("preempt", f"SIGTERM after the first logged step: train() "
            f"returned after {train_s:.1f} s at step {steps} with a "
            f"preemption checkpoint (stored epoch {stored['epoch']}); "
            f"--resume starts at step {resumed.state.step}, epoch "
            f"{resumed.start_epoch}; the previous SIGTERM handler is back ok")

        # The snapshot check: the worker copies on its own stream while
        # five in-place steps run.
        tr, dd, pipe = resumed, resumed.train_device, resumed.train_pipe
        tree = dict(checkpoint.snapshot(tr.state.state_dict()), epoch=0,
                    best_loss=0.0)
        tr._saver.submit("periodic", 0, tree, device=tr.device)
        host = dict(checkpoint.snapshot(checkpoint.to_host(
            tr.state.state_dict())), epoch=0, best_loss=0.0)
        for idxs in itertools.islice(pipe.epoch(), 5):
            tr.train_step(assemble_batch(dd.data, dd.lengths, idxs,
                                         pipe.generator, NUM_POINT,
                                         rotate=False))
        tr._saver.flush()
        saved = checkpoint.load(os.path.join(log_dir, "model.ckpt"))
        mismatch = tree_mismatch(torch, saved, host)
        require(mismatch is None and tr.state.step == steps + 5,
                f"the background save differs from the host copy at "
                f"{mismatch}")
        mb = state_mb(torch, host)

        # The training thread's time in one save, each way: in the
        # background (a fresh snapshot, then the worker's drain), then
        # synchronous.
        torch.cuda.synchronize()
        tr._snap_cache = None
        t0 = time.perf_counter()
        tr._save("periodic", 0)
        background = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        tr._saver.flush()
        drain = 1e3 * (time.perf_counter() - t0)
        saver, tr._saver = tr._saver, None
        t0 = time.perf_counter()
        tr._save("periodic", 0)
        synchronous = 1e3 * (time.perf_counter() - t0)
        tr._saver = saver
        say("preempt", f"a snapshot submitted, then 5 steps: the saved "
            f"checkpoint equals the host copy taken at submit bit for bit "
            f"ok; training thread in one save of the {mb:.1f} MB state "
            f"(model and Adam): background {background:.2f} ms "
            f"(clone on the card and submit; its write then took "
            f"{drain:.1f} ms more on the worker), synchronous "
            f"{synchronous:.2f} ms (copy to the host and write)")
    finally:
        resumed.close()
        rlogger.close()
    say("preempt", f"phase took {time.perf_counter() - t_phase:.1f} s")


def tree_mismatch(torch, a, b, path=""):
    """The first path where two nested state dicts differ (tensors bit for
    bit, with dtype), or None."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        same = (torch.is_tensor(a) and torch.is_tensor(b)
                and a.dtype == b.dtype and torch.equal(a, b))
        return None if same else path
    if isinstance(a, dict) and isinstance(b, dict):
        if list(a) != list(b):
            return path + " (keys)"
        for k in a:
            m = tree_mismatch(torch, a[k], b[k], f"{path}/{k}")
            if m is not None:
                return m
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return path + " (length)"
        for i, (x, y) in enumerate(zip(a, b)):
            m = tree_mismatch(torch, x, y, f"{path}/{i}")
            if m is not None:
                return m
        return None
    return None if a == b else path


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


def phase_timings(torch, fe, ch, fh, em, session, trainer, emd_trainer, rng,
                  launches, errs) -> list:
    from pointnet_autoencoder_tpu_torch.utils import roofline

    dev = torch.device("cuda")
    pts = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    chain = session.model.encoder.fold()
    rows = []

    # Each bound is utils/roofline.kernel_bound's: K5's operations
    # 2*B*N*sum(C*F); its bytes the points, weights and folded rows read
    # once, the (B, 1024) max and min written once.
    k_ms = cuda_ms(torch, lambda: fe.encoder_extrema_cuda(pts, chain))
    p_ms = cuda_ms(torch, lambda: fe.encoder_extrema_plain(pts, chain))
    rows.append(dict(
        name="fused_encoder_eval", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/fused_encoder.cu",
        replaces="pointnet_autoencoder_tpu/ops/fused_encoder.py:61",
        launches=launches["fused_encoder_eval"],
        max_abs_err=errs["fused_encoder"], ms=k_ms, plain_ms=p_ms,
        **bound("fused_encoder_eval", b=BATCH, n=NUM_POINT, dtype="f32"),
        library_ms=None))
    bf16_chain = fe.fold_layers(
        [tuple(torch.from_numpy(x).to(dev) for x in layer)
         for layer in random_layers(rng)], eps=EPS, dtype=torch.bfloat16)
    # bf16 points, so that the wrapper's cast is no copy and the traces
    # hold the kernels alone.
    pts16 = pts.to(torch.bfloat16)
    kb_ms = cuda_ms(torch, lambda: fe.encoder_extrema_cuda(pts16, bf16_chain))
    for name, c5, p5 in (("f32", chain, pts), ("bf16", bf16_chain, pts16)):
        dev_ms, counts = median_device_ms(
            torch, lambda p5=p5, c5=c5: fe.encoder_extrema_cuda(p5, c5))
        bf16 = name == "bf16"
        b5 = bound("fused_encoder_eval", b=BATCH, n=NUM_POINT, dtype=name)
        say("timings", f"fused_encoder_eval {name} B={BATCH} N={NUM_POINT}: "
            + (f"{kb_ms:.4f} ms by CUDA events (tensor cores); " if bf16
               else "")
            + f"device time per call, median of 50 traced calls: "
            f"{dev_ms:.5f} ms ({_event_counts(counts)}); bound "
            f"{b5['bound_ms']:.4f} ms ({b5['bound_by']})")

    # K1, both directions: the function needs each pair's d2 once (3 sub,
    # 3 mul, 2 add) and one compare per direction, 10 f32 operations per
    # pair; bytes: both clouds read once, (dist, idx) of every point
    # written once.
    x1 = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    x2 = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    k_ms = cuda_ms(torch, lambda: ch.nn_distance_cuda(x1, x2))
    p_ms = cuda_ms(torch, lambda: ch.nn_distance_plain(x1, x2))

    def cdist_min():
        d = torch.cdist(x1, x2)
        return d.min(dim=2), d.min(dim=1)

    l_ms = cuda_ms(torch, cdist_min)
    # The CUDA-event time of one call also holds the wrapper's host time
    # before the launch: the device time per call (both kernels), the
    # median over 50 traced calls.
    dev_ms, counts = median_device_ms(torch, lambda: ch.nn_distance_cuda(
        x1, x2))
    say("timings", f"nn_distance alone, device time per call, median of 50 "
        f"traced calls: {dev_ms:.5f} ms; device events "
        f"{_event_counts(counts)}")
    rows.append(dict(
        name="nn_distance", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/chamfer.cu",
        replaces="pointnet_autoencoder_tpu/ops/chamfer.py:92",
        launches=launches["nn_distance"], max_abs_err=errs["nn_distance"],
        ms=k_ms, plain_ms=p_ms,
        **bound("nn_distance", b=BATCH, n=NUM_POINT, m=NUM_POINT),
        library_ms=l_ms))

    # K3 and K4 at the training path's shapes, in its default type (bf16)
    # for the JSON rows, and in f32 for the record. K3: operations
    # 2*B*N*128*1024; bytes: x, w, scale and shift read once, (max,
    # argmax) written once. K4: B*F*C products, 4 operations each with the
    # sum; bytes: dx written once, the argmax rows of x, w, gvals, argmax
    # read once, dw written once. No single PyTorch call computes either.
    head = {}
    for dtype_name in ("f32", "bf16"):
        dtype = torch.float32 if dtype_name == "f32" else torch.bfloat16
        x, w, scale, shift = head_inputs(torch, rng, BATCH, NUM_POINT, dtype)
        b, n, c = x.shape
        f = w.shape[1]
        _, arg = fh.head_max_cuda(x, w, scale, shift)
        gvals = torch.from_numpy(
            (1e-3 * rng.randn(b, f)).astype(np.float32)).to(dev)
        fwd_dev, fwd_counts = median_device_ms(
            torch, lambda: fh.head_max_cuda(x, w, scale, shift))
        fwd = dict(
            ms=cuda_ms(torch, lambda: fh.head_max_cuda(x, w, scale, shift)),
            plain_ms=cuda_ms(torch, lambda: fh.head_max_plain(
                x, w, scale, shift)),
            **bound("fused_head_fwd", b=b, n=n, c=c, f=f, dtype=dtype_name))
        rows_x = roofline.distinct_rows(arg, n)
        bwd = dict(
            ms=cuda_ms(torch, lambda: fh.head_bwd_cuda(x, w, gvals, arg)),
            plain_ms=cuda_ms(torch, lambda: fh.head_bwd_plain(
                x, w, gvals, arg)),
            **bound("fused_head_bwd", b=b, n=n, c=c, f=f, dtype=dtype_name,
                    rows=rows_x))
        bwd_dev, bwd_counts = median_device_ms(
            torch, lambda: fh.head_bwd_cuda(x, w, gvals, arg))
        # K4 writes dx once in the matmul type: its trace holds its own
        # kernels only (no memset, no cast).
        require(bool(bwd_counts) and all("head_" in name
                                         for name in bwd_counts),
                f"K4's trace holds a memset, a cast or nothing: "
                f"{sorted(bwd_counts)}")
        say("timings", f"fused_head {dtype_name} B={b} N={n}: forward "
            f"{fwd['ms']:.4f} ms (device time per call {fwd_dev:.5f}, "
            f"median of 50 traced calls: {_event_counts(fwd_counts)}; plain "
            f"{fwd['plain_ms']:.4f}, bound "
            f"{fwd['bound_ms']:.4f} {fwd['bound_by']}); backward "
            f"{bwd['ms']:.4f} ms (device time per call {bwd_dev:.5f}, "
            f"median of 50 traced calls: {_event_counts(bwd_counts)}; plain "
            f"{bwd['plain_ms']:.4f}, bound "
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
    # The CUDA-event time of a call this short holds the launch latency:
    # the device time of each call, the median over 50 traced calls (one
    # call alone reads up to 2x off).
    for what, fn in (("nn_distance_grad", lambda: ch.nn_distance_grad_cuda(
            x1, x2, i1, i2, g1, g2)), ("index_add_", lambda: out.index_add_(
                0, rows_idx, terms))):
        dev_ms, counts = median_device_ms(torch, fn)
        say("timings", f"{what} alone, device time, median of 50 traced "
            f"calls: {dev_ms:.5f} ms; device events "
            f"{_event_counts(counts)}")
        if what == "nn_distance_grad":
            # K2 writes every output once: no memset before it.
            require(bool(counts) and not any("Memset" in n for n in counts),
                    f"K2's trace holds a memset or nothing: {sorted(counts)}")
    rows.append(dict(
        name="nn_distance_grad", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/chamfer.cu",
        replaces="pointnet_autoencoder_tpu/ops/chamfer.py:229",
        launches=launches["nn_distance_grad"],
        max_abs_err=errs["nn_distance_grad"], ms=k_ms, plain_ms=p_ms,
        **bound("nn_distance_grad", b=BATCH, n=NUM_POINT, m=NUM_POINT),
        library_ms=l_ms))

    # K6 at the training path's shapes (xyz1 the label, xyz2 the
    # prediction). Bound: operations, counted once for the function
    # (utils/roofline.py): the larger of the f32 operations over the f32
    # peak and the exp2, sqrt and rsqrt over the SFU rate; its bytes are
    # both clouds read once and cost and gradients written once. No single
    # PyTorch call computes the function.
    x1 = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    x2 = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    pairs = float(BATCH * NUM_POINT * NUM_POINT)
    k6 = bound("emd_forward", b=BATCH, n=NUM_POINT, m=NUM_POINT)
    flops = roofline.emd_ops(BATCH, NUM_POINT, NUM_POINT)
    sfu = roofline.EMD_SFU_PER_PAIR * pairs
    sfu_ms = sfu / roofline.PEAK_SFU_PER_S * 1e3
    rows.append(dict(
        name="emd_forward", route="cuda",
        source="pointnet_autoencoder_tpu_torch/csrc/emd.cu",
        replaces="pointnet_autoencoder_tpu/ops/emd_pallas.py:116",
        launches=launches["emd_forward"], max_abs_err=errs["emd_forward"],
        ms=cuda_ms(torch, lambda: em.emd_forward_cuda(x1, x2)),
        plain_ms=cuda_ms(torch, lambda: em.emd_forward_plain(x1, x2),
                         reps=5, warmup=1),
        **k6, library_ms=None))
    say("timings", f"emd_forward bound: {roofline.EMD_LEVELS * pairs:.4g} "
        f"pair-levels, {flops:.4g} f32 operations "
        f"({flops / roofline.PEAK_F32_FLOPS * 1e3:.4f} ms), {sfu:.4g} SFU "
        f"results "
        f"({sfu_ms:.4f} ms)")

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

    # One train step of each trained bf16 trainer on a batch already on
    # the card: host clock to the loss on the host, median of 10, then
    # traced.
    tb = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    for model, tr in (("model", trainer), ("model_emd", emd_trainer)):
        med, lo, hi, trace = step_timing(torch, tr, tb,
                                         f"chip_smoke.{model}.train_step")
        say("timings", f"{model} train step, bf16, B={BATCH} N={NUM_POINT} "
            f"(host clock, to the loss on the host): median {med:.3f} ms, "
            f"min {lo:.3f}, max {hi:.3f}")
        say("timings", f"{model} train step traced: {trace}")
    input_step_timings(torch, trainer)

    # K1 and K2 at model_hierachy's center term, 64 centers against the
    # label's points; bounds as above. Own seed.
    hier = np.random.RandomState(SEED + 10)
    c1 = torch.from_numpy(clouds(hier, BATCH, HIER_CENTERS)).to(dev)
    c2 = torch.from_numpy(clouds(hier, BATCH, NUM_POINT)).to(dev)
    _, j1, _, j2 = ch.nn_distance_cuda(c1, c2)
    h1, h2 = (torch.from_numpy(hier.randn(BATCH, n).astype(np.float32)).to(
        dev) for n in (HIER_CENTERS, NUM_POINT))
    for what, fn, b in (
            ("nn_distance", lambda: ch.nn_distance_cuda(c1, c2),
             bound("nn_distance", b=BATCH, n=HIER_CENTERS, m=NUM_POINT)),
            ("nn_distance_grad", lambda: ch.nn_distance_grad_cuda(
                c1, c2, j1, j2, h1, h2), bound(
                    "nn_distance_grad", b=BATCH, n=HIER_CENTERS,
                    m=NUM_POINT))):
        dev_ms, counts = median_device_ms(torch, fn)
        say("timings", f"{what} B={BATCH} N={HIER_CENTERS} M={NUM_POINT} "
            f"(model_hierachy's centers): device time per call, median of "
            f"50 traced calls: {dev_ms:.5f} ms ({_event_counts(counts)}); "
            f"bound {b['bound_ms']:.5f} ms ({b['bound_by']})")
    # K1 beside its library yardstick (torch.cdist and the two mins) at its
    # two small shapes, model_hierachy's centers and cli.test's B=1: the
    # device time per call of each, median of 50 traced calls.
    p1, p2 = (torch.from_numpy(clouds(hier, 1, NUM_POINT)).to(dev)
              for _ in range(2))
    for what, a, b in ((f"B={BATCH} N={HIER_CENTERS} M={NUM_POINT}", c1, c2),
                       (f"B=1 N=M={NUM_POINT}", p1, p2)):
        k_ms, _ = median_device_ms(torch, lambda: ch.nn_distance_cuda(a, b))
        l_ms, counts = median_device_ms(
            torch, lambda: cdist_yardstick(torch, a, b), repeats=True)
        say("timings", f"nn_distance {what}: device time per call, median "
            f"of 50 traced calls: kernel {k_ms:.5f} ms, library "
            f"(torch.cdist + two min) {l_ms:.5f} ms "
            f"({_event_counts(counts)})")
    return rows


def cdist_yardstick(torch, a, b):
    """The library yardstick of K1: both directions' nearest distance and
    index from one ``torch.cdist``."""
    d = torch.cdist(a, b)
    return d.min(dim=2), d.min(dim=1)


def input_step_timings(torch, trainer):
    """The ``model`` bf16 train step with its input, in both input modes, on
    the trained device-input trainer: device input builds each batch on
    the card (``assemble_batch``); host input takes the next batch of a
    ``BatchPipeline`` over the same dataset (its producer thread, pinned
    copies). Host clock per step to the loss on the host, median of 10
    after one warm epoch (which fills the host dataset's item cache), then
    a trace of one step: device busy time and idle share."""
    from pointnet_autoencoder_tpu_torch.data.device_pipeline import (
        assemble_batch,
    )
    from pointnet_autoencoder_tpu_torch.data.pipeline import BatchPipeline

    def forever(epoch):
        while True:
            yield from epoch()

    dd, pipe = trainer.train_device, trainer.train_pipe
    idxs = forever(pipe.epoch)
    host_pipe = BatchPipeline(trainer.train_dataset, BATCH, rotate=False,
                              shuffle=True, device=trainer.device, seed=SEED)
    batches = forever(host_pipe.epoch)
    steps = {
        "device": lambda: trainer.train_step(assemble_batch(
            dd.data, dd.lengths, next(idxs), pipe.generator, NUM_POINT,
            rotate=False))["loss"].item(),
        "host": lambda: trainer.train_step(next(batches))["loss"].item()}
    try:
        for mode, step in steps.items():
            for _ in range(len(pipe)):
                step()
            host = []
            for _ in range(10):
                t0 = time.perf_counter()
                step()
                host.append(1e3 * (time.perf_counter() - t0))
            trace = device_trace(torch, step,
                                 f"chip_smoke.model.{mode}_input_step", top=4)
            say("timings", f"model train step with {mode} input, bf16, "
                f"B={BATCH} N={NUM_POINT} (host clock, input included, to "
                f"the loss on the host): median {statistics.median(host):.3f} "
                f"ms, min {min(host):.3f}, max {max(host):.3f}; traced: "
                f"{trace}")
    finally:
        batches.close()
        idxs.close()


def median_device_ms(torch, fn, reps=50, attempts=6, repeats=False):
    """(one call's device time in ms: over ``reps`` traced calls, each
    followed by a synchronize, the median duration of each kernel that
    ``fn`` launches once per call, summed over its kernels; the number of
    events of each name). A name with more than ``reps`` events (a kernel
    launched more than once per call) fails, unless ``repeats``: a name
    may then run a whole number m of times per call (a library's chain of
    kernels, two reductions of one template), and counts m times its
    median. A trace may lose events (on an H100 a trace once kept 16 of 50
    calls' and another 43): with fewer than ``m * reps - 2`` of a name the
    trace is taken again, up to ``attempts`` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if not events:
            return float("nan"), {}
        by_name = {}
        for e in events:
            by_name.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
        counts = {name: len(v) for name, v in by_name.items()}
        per_call = {name: max(1, round(c / reps)) if repeats else 1
                    for name, c in counts.items()}
        require(all(c <= per_call[n] * reps for n, c in counts.items()),
                f"more than one event per call in {reps} calls: {counts}")
        if all(c >= per_call[n] * reps - 2 for n, c in counts.items()):
            return (sum(statistics.median(v) * per_call[n]
                        for n, v in by_name.items()) / 1e3, counts)
        seen.append(counts)
    raise PhaseError(f"{attempts} traces of {reps} calls each lost events: "
                     f"{seen}")


# Substrings of the device-side names of the port's kernels and memsets.
OWN_KERNELS = ("encoder_", "reduce_tiles", "nn_distance", "head_", "emd_",
               "bn_", "Memset")


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


def _event_counts(counts: dict) -> str:
    """Each kernel name of ``median_device_ms`` with its event count."""
    return ", ".join(sorted(f"{_short(n)} x{c}" for n, c in counts.items()))


def bound(kernel: str, **shape) -> dict:
    """{"bound_ms", "bound_by"} of one call of ``kernel`` at ``shape``
    (utils/roofline.kernel_bound), as the kernels line carries them."""
    from pointnet_autoencoder_tpu_torch.utils import roofline

    kb = roofline.kernel_bound(kernel, **shape)
    return {"bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"]}


# ---------------------------------------------------------------------------
# Phase compiled: the captured steps and forwards against the eager ones
# ---------------------------------------------------------------------------

ALL_FAMILIES = ("model", "model_emd", "model_cpu", "model_hierachy",
                "model_upconv", "model_fc_upconv")
# cuDNN's transposed convolutions may add in arrival order: the
# compared runs of these families take cuDNN's deterministic algorithms.
UPCONV_FAMILIES = ("model_upconv", "model_fc_upconv")
# model_cpu's dense Chamfer gradient scatters with index_add_, which adds
# with atomics in arrival order on a card: its compared runs take torch's
# deterministic algorithms (a sorted scatter).
DENSE_FAMILIES = ("model_cpu",)
COMPILED_LOG_EVERY = 3


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """torch's deterministic algorithms within the block (a warning where
    an op has none), the previous setting restored after it."""
    mode = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn)
# Names of the CUDA runtime calls by which the host issues device work.
HOST_OPS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
            "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def overhead_trace(torch, fn, label, reps=3, min_events=1,
                   attempts=4, accept=None) -> dict:
    """One torch.profiler trace of ``reps`` calls of ``fn()`` (each ending
    with the device's work done), the last one read: its host span, the
    union of device intervals inside it (busy), the idle share, the device
    events and each of the port's kernels among them, and the device
    operations the host issued (CUDA runtime launches, graph launches,
    copies and memsets) by name. A trace may lose device events (a
    replayed graph's too): one with fewer than ``min_events``, or that
    ``accept(trace)`` refuses, is taken again, up to ``attempts`` times
    in all, and the last one is returned."""
    for _ in range(attempts):
        out = _overhead_trace_once(torch, fn, label, reps)
        if out["device_events"] >= min_events and (accept is None
                                                   or accept(out)):
            break
    return out


# For each launch counter, the kernels of which its wrapper launches
# exactly one each time on every route (a trace's ``own`` names).
COUNTER_KERNELS = {"fused_encoder_eval": ("reduce_tiles_kernel",),
                   "nn_distance": ("nn_distance_kernel",),
                   "fused_head_fwd": ("head_fwd_mma_kernel",
                                      "head_fwd_tile_kernel"),
                   "fused_head_bwd": ("head_bwd_dw_kernel",),
                   "nn_distance_grad": ("nn_distance_grad_kernel",),
                   "emd_forward": ("emd_cost_sum",),
                   "batch_norm_fwd": ("bn_apply_kernel",),
                   "batch_norm_bwd": ("bn_dx_kernel",)}


def trace_launches(own: dict) -> dict:
    """The launches of each counter's wrapper that a trace's ``own``
    kernel counts show."""
    return {k: sum(own.get(n, 0) for n in names)
            for k, names in COUNTER_KERNELS.items()}


def counted(counters, fn, box: dict):
    """``fn`` wrapped so that each call leaves its launch counters'
    increments in ``box``."""
    def call():
        before = {k: c.launches for k, c in counters.items()}
        fn()
        box.clear()
        box.update({k: c.launches - before[k] for k, c in counters.items()})
    return call


def _overhead_trace_once(torch, fn, label, reps) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            with record_function(label):
                fn()
    events = prof.events()
    spans = [e.time_range for e in events
             if e.name == label and e.device_type == DeviceType.CPU]
    require(len(spans) == reps, f"trace holds {len(spans)} calls")
    t0, t1 = spans[-1].start, spans[-1].end
    dev = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1),
                  e.name) for e in events
                 if e.device_type == DeviceType.CUDA and e.name != label
                 and not getattr(e, "is_user_annotation", False)
                 and e.time_range.end > t0 and e.time_range.start < t1)
    host = {}
    for e in events:
        if (e.device_type == DeviceType.CPU and e.name.startswith(HOST_OPS)
                and t0 <= e.time_range.start <= t1):
            host[e.name] = host.get(e.name, 0) + 1
    busy, end, own = 0.0, t0, {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        if any(k in name for k in OWN_KERNELS):
            base = _short(name).split("<")[0]
            own[base] = own.get(base, 0) + 1
    return dict(span_ms=(t1 - t0) / 1e3, busy_ms=busy / 1e3,
                idle=1.0 - busy / max(t1 - t0, 1e-9), device_events=len(dev),
                host_ops=sum(host.values()), host=host,
                graph_launches=sum(n for k, n in host.items()
                                   if "GraphLaunch" in k), own=own)


def _overhead_str(t: dict, per: int = 1) -> str:
    device = (f"device busy {t['busy_ms']:.4f} ms, idle share "
              f"{t['idle']:.4f}" if t["device_events"] else
              "device busy and idle share not measured (no device events "
              "in the trace)")
    return (f"span {t['span_ms']:.4f} ms, {device}, {t['device_events']} "
            f"device events, {t['host_ops']} host-issued operations"
            + (f" ({t['host_ops'] / per:.1f} a step)" if per > 1 else "")
            + f", {t['graph_launches']} graph launches")


# The bf16-master cases of phase compiled: TrainConfig flags by tag.
COMPILED_MASTERS = {"--bf16_params --bf16_moments":
                    dict(bf16_params=True, bf16_moments=True),
                    "--bf16_params": dict(bf16_params=True)}
# The graphed step's host median may exceed its device busy time by this
# much (ms), and its busy time the eager step's by this share; the host
# operations it may issue: what PERF.md compares the captured master step
# with (reported, not required: host clocks vary between calls).
MASTER_HOST_OVER_BUSY_MS = 0.5
MASTER_BUSY_SHARE = 0.05
MASTER_HOST_OPS = 6
# The master case whose device-input epoch is traced, as the default
# step's are (the other one holds only its programs' keys).
MASTER_EPOCH_TRACED = "--bf16_params --bf16_moments"
# Times phase compiled takes an eager and a graphed trace of one call
# again, both, where their kernels differ.
TRACE_PAIRS = 3


def _compiled_config(data, log_dir, name, bf16, input_mode, **flags):
    from pointnet_autoencoder_tpu_torch.config import TrainConfig

    return TrainConfig(model=name, data_path=data, category="Chair",
                       num_point=NUM_POINT, batch_size=BATCH, bf16=bf16,
                       log_dir=log_dir, log_every=COMPILED_LOG_EVERY
                       if input_mode == "device" else 5,
                       input_mode=input_mode, seed=SEED, **flags)


def _host_state(torch, tr) -> dict:
    """The Trainer's weights, BN statistics and optimizer state (slots,
    step counts, groups) on the host."""
    def host(v):
        if torch.is_tensor(v):
            return v.detach().cpu()
        if isinstance(v, dict):
            return {k: host(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return [host(u) for u in v]
        return v

    return host(tr.state.state_dict())


def _noise_offsets(tr) -> list:
    """The offset of the master optimizer's noise generator (none for
    another optimizer, or on the CPU)."""
    return [g.get_offset()
            for g in getattr(tr.state.optimizer, "generators", ())]


def _compiled_run(torch, counters, tr, epochs=1):
    """``epochs`` train epochs and two eval epochs of ``tr`` from its
    start: the launches, the state on the host, the generators' states
    (and the noise generator's offset), the logged records and the eval
    losses."""
    for fn in counters.values():
        fn.launches = 0
    for epoch in range(epochs):
        tr.train_one_epoch(epoch)
    evals = [tr.eval_one_epoch(0), tr.eval_one_epoch(0)]
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    tr.flush()
    with open(os.path.join(tr.config.log_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    gens = ([tr.train_pipe.generator.get_state(),
             tr.eval_pipe.generator.get_state()]
            if tr.input_mode == "device" else [])
    return dict(launches=launches, state=_host_state(torch, tr), gens=gens,
                noise=_noise_offsets(tr), recs=recs, evals=evals,
                step=tr.state.step, step_tensor=int(tr.state.step_tensor))


def compiled_training(torch, counters, data, tmp, name, bf16, input_mode,
                      x, master=None, count=False):
    """A captured Trainer (the default) beside an eager one
    (``compiled=False``) from the same seed: one train epoch (device
    input: log_every 3, so chunks of 3, 3, 3 and 1 steps; the first chunk
    is the warm-up, eager, the other 7 steps are replays of a program of 3
    steps and one of 1; host input: the first step eager, 9 replays) and
    two eval epochs each (the second replayed); everything bit-equal.
    ``master``: a key of ``COMPILED_MASTERS``, bf16 master weights (and
    moments), trained 2 epochs, the noise generator's offset equal too,
    and the graphed Trainer holding its train programs of 3 steps and of
    1. Then each one's step on ``x`` timed and traced, and with device
    input (one master case: ``MASTER_EPOCH_TRACED``) an epoch of each
    traced, the graphed one in one graph launch a chunk. ``count``: then
    a ``StepCost`` of one more eager step on the card and of the same
    step on the CPU (``step_costs``). Returns the report line, the
    timings and the two costs (None without ``count``)."""
    from pointnet_autoencoder_tpu_torch.parallel.sp import cudnn_deterministic
    from pointnet_autoencoder_tpu_torch.train import master as master_mod
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    tag = (f"{name} {'bf16' if bf16 else 'f32'} {input_mode} input"
           + (f" {master}" if master else ""))
    flags = COMPILED_MASTERS[master] if master else {}
    epochs = TRAIN_EPOCHS if master else 1
    context = (cudnn_deterministic if name in UPCONV_FAMILIES else
               (lambda: deterministic_algorithms(torch))
               if name in DENSE_FAMILIES else contextlib.nullcontext)
    runs, trainers = {}, {}
    try:
        for compiled in (True, False):
            cfg = _compiled_config(
                data, os.path.join(tmp, f"compiled_{name}_{bf16}_"
                                        f"{input_mode}_{master}_{compiled}"),
                name, bf16, input_mode, **flags)
            tr = trainers[compiled] = Trainer(cfg, device="cuda",
                                              compiled=compiled)
            require((tr._steps is not None) == compiled,
                    f"{tag}: compiled={compiled} but no programs")
            require(isinstance(tr.state.optimizer,
                               master_mod.MasterOptimizer) == bool(master),
                    f"{tag}: optimizer {type(tr.state.optimizer).__name__}")
            with context():
                runs[compiled] = _compiled_run(torch, counters, tr, epochs)
        graphed, eager = runs[True], runs[False]
        bad = tree_mismatch(torch, graphed["state"], eager["state"])
        require(bad is None, f"{tag}: graphed and eager states differ at "
                f"{bad}")
        steps = len(trainers[True].train_pipe)
        chunks = -(-steps // COMPILED_LOG_EVERY)
        require(graphed["step"] == eager["step"] == graphed["step_tensor"]
                == epochs * steps, f"{tag}: steps {graphed['step']}, "
                f"{eager['step']}, device {graphed['step_tensor']}")
        require(graphed["noise"] == eager["noise"]
                and len(graphed["noise"]) == (1 if master else 0),
                f"{tag}: the noise generator's offset {graphed['noise']} "
                f"graphed, {eager['noise']} eager")
        require(all(torch.equal(a, b) for a, b in
                    zip(graphed["gens"], eager["gens"])),
                f"{tag}: the generators' states differ after the epoch "
                f"(the device-input batches were not the eager path's)")
        strip = [[{k: v for k, v in r.items() if k not in ("time", "wall")}
                  for r in run["recs"]] for run in (graphed, eager)]
        require(strip[0] == strip[1] and graphed["evals"] == eager["evals"],
                f"{tag}: logged metrics differ: {strip[0]} vs {strip[1]}, "
                f"eval {graphed['evals']} vs {eager['evals']}")
        require(graphed["launches"] == eager["launches"],
                f"{tag}: launches {graphed['launches']} graphed vs "
                f"{eager['launches']} eager")
        if master and input_mode == "device":
            # The chunks of log_every steps and the last, shorter one ran
            # as captured programs (the first chunk is the warm-up).
            held = sorted(k for k in trainers[True]._steps.programs._programs
                          if k[0] == "train")
            want = sorted({("train", COMPILED_LOG_EVERY),
                           ("train", steps - (chunks - 1)
                            * COMPILED_LOG_EVERY)})
            require(held == want, f"{tag}: the graphed Trainer's train "
                    f"programs {held}, not {want}")
        trace_epoch = input_mode == "device" and master in (
            None, MASTER_EPOCH_TRACED)
        # The step on a batch already on the card, and a device-input
        # epoch, each traced, eager first: its traces' device events are
        # the least the graphed traces must hold. A trace may lose events:
        # one whose kernels the counters do not count, or (graphed) whose
        # kernels, memsets included, are not the eager trace's, is taken
        # again; and a pair that still differs is taken again whole (the
        # eager trace may be the one that lost them).
        host, calls, deltas = {}, {}, {}
        for compiled in (False, True):
            tr = trainers[compiled]
            box = deltas[compiled] = {"step": {}, "epoch": {}}

            def step(tr=tr):
                tr.train_step(x)["loss"].item()

            calls[compiled] = {
                "step": (counted(counters, step, box["step"]), 3),
                "epoch": (counted(counters,
                                  lambda tr=tr: tr.train_one_epoch(1),
                                  box["epoch"]), 2)}
            with context():
                step()
                step()
                times = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    step()
                    times.append(1e3 * (time.perf_counter() - t0))
            host[compiled] = statistics.median(times)
        traces = {False: {}, True: {}}
        for kind in ("step", "epoch") if trace_epoch else ("step",):
            for _ in range(TRACE_PAIRS):
                for compiled in (False, True):
                    fn, reps = calls[compiled][kind]
                    eager_trace = traces[False].get(kind)
                    least = ({} if not compiled else dict(min_events=int(
                        0.95 * eager_trace["device_events"])))

                    def agrees(t, box=deltas[compiled][kind],
                               compiled=compiled, eager_trace=eager_trace):
                        return trace_launches(t["own"]) == box and (
                            not compiled or t["own"] == eager_trace["own"])

                    with context():
                        traces[compiled][kind] = overhead_trace(
                            torch, fn, f"compiled.{name}.{kind}", reps=reps,
                            accept=agrees, **least)
                if traces[True][kind]["own"] == traces[False][kind]["own"]:
                    break
        timing = {c: (host[c], traces[c]["step"], traces[c].get("epoch"))
                  for c in (False, True)}
        # The port's kernels in each trace: as the counters count that
        # call, graphed and eager alike.
        for kind, i in (("step", 1), ("epoch", 2)):
            if timing[True][i] is None:
                continue
            own = {c: timing[c][i]["own"] for c in (True, False)}
            seen = {c: trace_launches(own[c]) for c in (True, False)}
            require(own[True] == own[False]
                    and seen[True] == deltas[True][kind]
                    and seen[False] == deltas[False][kind],
                    f"{tag}: the port's kernels in the traced {kind}: "
                    f"graphed {own[True]}, eager {own[False]}; as launches "
                    f"{seen}, the counters {deltas[True][kind]} graphed, "
                    f"{deltas[False][kind]} eager")
        g_step, e_step = timing[True][1], timing[False][1]
        require(g_step["graph_launches"] == 1
                and e_step["graph_launches"] == 0,
                f"{tag}: host operations of one step {g_step['host']} "
                f"graphed, {e_step['host']} eager")
        line = (f"{tag}: {epochs} train epoch(s) of {steps} steps and 2 "
                f"eval epochs (the second replayed) bit-equal to eager: "
                f"weights, optimizer slots and counts, BN statistics, the "
                f"generators"
                + (f" and the noise generator's offset {graphed['noise']}"
                   if master else "")
                + f", every logged metric; launches "
                f"{graphed['launches']} both ways. One step on a batch on "
                f"the card (host median of 10, to the loss on the host): "
                f"graphed {timing[True][0]:.3f} ms, "
                f"{_overhead_str(g_step)}; eager {timing[False][0]:.3f} ms, "
                f"{_overhead_str(e_step)}")
        if master:
            held = {
                "host within busy + 0.5 ms": timing[True][0]
                <= g_step["busy_ms"] + MASTER_HOST_OVER_BUSY_MS,
                f"at most {MASTER_HOST_OPS} host operations":
                g_step["host_ops"] <= MASTER_HOST_OPS,
                "busy within 5% of eager": abs(
                    g_step["busy_ms"] - e_step["busy_ms"])
                <= MASTER_BUSY_SHARE * e_step["busy_ms"]}
            line += ". The graphed master step: " + ", ".join(
                f"{k} {'held' if v else 'MISSED'}" for k, v in held.items())
        if timing[True][2] is not None:
            g_epoch, e_epoch = timing[True][2], timing[False][2]
            require(g_epoch["graph_launches"] == chunks,
                    f"{tag}: a device-input epoch of {steps} steps issued "
                    f"{g_epoch['host']}, not {chunks} graph launches")
            line += (f". A device-input epoch: graphed "
                     f"{_overhead_str(g_epoch, steps)}; eager "
                     f"{_overhead_str(e_epoch, steps)}; the port's kernels "
                     f"in each epoch's trace {g_epoch['own']}, as the "
                     f"counters count it")
        costs = None
        if count:
            cfg = _compiled_config(
                data, os.path.join(tmp, f"cost_{name}_{bf16}_{master}"),
                name, bf16, "host", **flags)
            costs = step_costs(torch, trainers[False], x, cfg, context)
        return line, timing, costs
    finally:
        for tr in trainers.values():
            tr.close()


def compiled_resume(torch, data, tmp, x):
    """A card Trainer's state after 2 steps, saved as a card writes it and
    in a CPU Trainer's form (Adam's groups not capturable, the learning
    rate a float, as a checkpoint from before the learning rate was a
    tensor holds it too), each resumed by a captured card Trainer through
    ``resume``: Adam capturable again, and 3 steps on ``x`` from each (a
    warm-up, then 2 replays) bit-equal. Returns the report line."""
    import copy
    import dataclasses

    from pointnet_autoencoder_tpu_torch.train import checkpoint
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    def config(form):
        return _compiled_config(data, os.path.join(tmp, f"resume_{form}"),
                                "model", True, "device")

    src = Trainer(config("source"), device="cuda")
    try:
        for _ in range(2):
            src.train_step(x)
        card = dict(checkpoint.to_host(src.state.state_dict()), epoch=1,
                    best_loss=1e9)
    finally:
        src.close()
    cpu = copy.deepcopy(card)
    for group in cpu["optimizer"]["param_groups"]:
        group["capturable"] = False
        group["lr"] = float(group["lr"])
    states = {}
    for form, tree in (("card", card), ("cpu", cpu)):
        cfg = config(form)
        checkpoint.CheckpointManager(cfg.log_dir).save_periodic(tree)
        tr = Trainer(dataclasses.replace(cfg, resume=True), device="cuda")
        try:
            groups = tr.state.optimizer.param_groups
            require(tr.state.step == 2 and all(
                g["capturable"] and torch.is_tensor(g["lr"])
                for g in groups),
                f"resume of the {form} form: step {tr.state.step}, "
                f"capturable {[g['capturable'] for g in groups]}")
            for _ in range(3):
                tr.train_step(x)
            require(tr._steps is not None and len(tr._steps.programs._programs)
                    == 1, f"resume of the {form} form: no captured step")
            states[form] = _host_state(torch, tr)
        finally:
            tr.close()
    bad = tree_mismatch(torch, states["card"], states["cpu"])
    require(bad is None, f"3 steps after resuming the two forms differ at "
            f"{bad}")
    return ("a checkpoint in a CPU Trainer's form (Adam not capturable, a "
            "float learning rate) and as the card writes it, each resumed "
            "by a captured card Trainer: Adam capturable again, 3 steps "
            "from each (a warm-up, then 2 replays) bit-equal")


# The kernel each served op launches once per call at one padded chunk.
SERVING_OP_KERNELS = {"reconstruct": "fused_encoder_eval",
                      "embed": "fused_encoder_eval",
                      "chamfer": "nn_distance", "fscore": "nn_distance"}


def compiled_serving(torch, counters, weights, rng, batch, bf16,
                     model_parallel=1, count=False):
    """A captured session beside an eager one: reconstruct, embed,
    decode, chamfer and fscore at ``batch``, each called twice on each (on
    the captured one a warm-up, then a replay), all bit-equal, with the
    same launches; a served reconstruct timed and traced both ways.
    ``model_parallel`` 2: a TP-split session whose two devices are
    cuda:0, captured whole. ``count``: a ``StepCost`` of one eager
    reconstruct on the card and of the same call of a session on the
    CPU. Returns the report line, the timings and the costs (or None)."""
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession

    m = model_parallel
    tag = (f"B={batch} {'bf16' if bf16 else 'f32'}"
           + (f" TP-split (model_parallel={m} on cuda:0)" if m > 1 else ""))
    x = clouds(rng, batch, NUM_POINT)
    y = clouds(rng, batch, NUM_POINT)
    where = (dict(device="cuda") if m == 1 else
             dict(devices=["cuda:0"] * m, model_parallel=m))
    sessions = {c: InferenceSession("model", weights, NUM_POINT,
                                    batch_size=batch, bf16=bf16,
                                    compiled=c, **where)
                for c in (True, False)}
    try:
        paths = {c: s.forward_paths for c, s in sessions.items()}
        require(paths[True] == ["captured CUDA graphs on cuda:0"]
                and paths[False][0].startswith("eager ("),
                f"serving {tag}: forward paths {paths}")
        emb = sessions[False].embed(x)
        ops = {"reconstruct": lambda s: s.reconstruct(x),
               "embed": lambda s: s.embed(x),
               "decode": lambda s: s.decode(emb),
               "chamfer": lambda s: s.chamfer(x, y),
               "fscore": lambda s: s.fscore(x, y, 0.5)}
        seen = {}
        for op, call in ops.items():
            outs, launches = {}, {}
            for c, s in sessions.items():
                for fn in counters.values():
                    fn.launches = 0
                outs[c] = [call(s) for _ in range(2)]
                launches[c] = {k: fn.launches for k, fn in counters.items()}
            require(all(np.array_equal(o, outs[False][0])
                        for o in outs[True] + outs[False]),
                    f"serving {tag} {op}: graphed differs from eager")
            # Two calls: K5 once per forward, K1 once per metric call.
            kernel = SERVING_OP_KERNELS.get(op)
            require(launches[True] == launches[False] and (
                kernel is None or launches[True][kernel] == 2),
                    f"serving {tag} {op}: launches {launches}")
            seen[op] = {k: n for k, n in launches[True].items() if n}
        timing = {}
        for c in (False, True):
            s = sessions[c]
            host = []
            for _ in range(10):
                t0 = time.perf_counter()
                s.reconstruct(x)
                host.append(1e3 * (time.perf_counter() - t0))
            least = int(0.95 * timing[False][1]["device_events"]) if c else 1
            timing[c] = (statistics.median(host), overhead_trace(
                torch, lambda s=s: s.reconstruct(x),
                f"compiled.serve.{batch}", min_events=least))
        require(timing[True][1]["graph_launches"] == 1,
                f"serving {tag}: host operations {timing[True][1]['host']}")
        costs = None
        if count:
            from pointnet_autoencoder_tpu_torch.utils import roofline

            cpu = InferenceSession("model", weights, NUM_POINT,
                                   batch_size=batch, bf16=bf16, device="cpu",
                                   compiled=False)
            costs = []
            for s in (sessions[False], cpu):
                t0 = time.perf_counter()
                with roofline.StepCost() as cost:
                    s.reconstruct(x)
                costs.append(cost)
            costs.append(time.perf_counter() - t0)
        return (f"serving {tag}: reconstruct, embed, decode, chamfer and "
                f"fscore graphed (a warm-up, then a replay) bit-equal to "
                f"eager, the same launches (two calls each: {seen}); "
                f"reconstruct, host median of 10:"
                f" graphed {timing[True][0]:.3f} ms, "
                f"{_overhead_str(timing[True][1])}; eager "
                f"{timing[False][0]:.3f} ms, "
                f"{_overhead_str(timing[False][1])}"), timing, costs
    finally:
        for s in sessions.values():
            s.close()


def compiled_master_resume(torch, data, tmp, master):
    """bf16 masters (``COMPILED_MASTERS[master]``), captured: 5 steps on
    fixed batches on the card, a checkpoint and ``resume``, then 5 more,
    against 10 steps alone: the train state and the noise generator's
    offset bit-equal. Each Trainer's first step is its eager warm-up, the
    others replays of its one-step program (the resumed Trainer's from
    step 6 on). Returns the report line."""
    import dataclasses

    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    flags = COMPILED_MASTERS[master]
    batches = [torch.from_numpy(clouds(np.random.RandomState(SEED + 110 + i),
                                       BATCH, NUM_POINT)).to("cuda")
               for i in range(10)]
    results = {}
    for form in ("straight", "resumed"):
        cfg = dataclasses.replace(_compiled_config(
            data, os.path.join(tmp, f"master_resume_{len(flags)}_{form}"),
            "model", True, "device", **flags), async_checkpoints=False)
        tr = Trainer(cfg, device="cuda")
        try:
            for xi in batches[:10 if form == "straight" else 5]:
                tr.train_step(xi)
            if form == "resumed":
                tr._save("periodic", 0)
                tr.close()
                tr = Trainer(dataclasses.replace(cfg, resume=True),
                             device="cuda")
                require(tr.state.step == tr.state.optimizer.steps == 5,
                        f"{master}: resumed at step {tr.state.step}")
                for xi in batches[5:]:
                    tr.train_step(xi)
            require(tr._steps is not None
                    and len(tr._steps.programs._programs) == 1,
                    f"{master} resume: no captured step")
            torch.cuda.synchronize()
            results[form] = (_host_state(torch, tr), _noise_offsets(tr))
        finally:
            tr.close()
    bad = tree_mismatch(torch, results["straight"][0], results["resumed"][0])
    require(bad is None and results["straight"][1] == results["resumed"][1],
            f"{master}: 5 steps, a resume and 5 more differ from 10 steps "
            f"at {bad}; noise offsets {results['straight'][1]} vs "
            f"{results['resumed'][1]}")
    return (f"model {master}, captured: 5 steps, a checkpoint, resume and "
            f"5 more bit-equal to 10 steps alone (weights, slots, step "
            f"counts, BN statistics; the noise generator's offset "
            f"{results['resumed'][1]})")


def compiled_pipeline(torch, counters, weights, rng):
    """``PipelinedSession`` on ["cuda:0", "cuda:0"], B=32 in
    ``PP_MICROBATCHES`` microbatches, f32, captured beside eager
    (``compiled=False``): reconstruct, embed and decode called twice on
    each (on the captured one a warm-up of each stage, then replays), all
    bit-equal, with the same launches (K5 once per microbatch), and within
    rtol 1e-5, atol 1e-6 of the unpipelined session; on a third, captured
    session an embed, then two reconstructs (stage 0 replaying while stage
    1 warms up), bit-equal to eager's; a reconstruct's host
    median and trace both ways (a graph launch per stage and
    microbatch). Returns the report line."""
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.parallel.pp import PipelinedSession

    x = clouds(rng, BATCH, NUM_POINT)
    ref = InferenceSession("model", weights, NUM_POINT, batch_size=BATCH,
                           device="cuda")
    pps = {c: PipelinedSession(ref, devices=["cuda:0", "cuda:0"],
                               num_microbatches=PP_MICROBATCHES, compiled=c)
           for c in (True, False)}
    try:
        paths = {c: s.forward_path for c, s in pps.items()}
        require(paths[True].startswith("captured")
                and paths[False].startswith("eager ("),
                f"pipelined forward paths {paths}")
        emb = ref.embed(x)
        ops = {"reconstruct": (lambda s: s.reconstruct(x),
                               ref.reconstruct(x)),
               "embed": (lambda s: s.embed(x), emb),
               "decode": (lambda s: s.decode(emb), ref.decode(emb))}
        gaps, eager = {}, {}
        for op, (call, want) in ops.items():
            outs, launches = {}, {}
            for c, s in pps.items():
                for fn in counters.values():
                    fn.launches = 0
                outs[c] = [call(s) for _ in range(2)]
                launches[c] = {k: fn.launches for k, fn in counters.items()}
            require(all(np.array_equal(o, outs[False][0])
                        for o in outs[True] + outs[False]),
                    f"pipelined {op}: graphed differs from eager")
            k5 = 0 if op == "decode" else 2 * PP_MICROBATCHES
            require(launches[True] == launches[False]
                    and launches[True]["fused_encoder_eval"] == k5,
                    f"pipelined {op}: launches {launches}")
            got = outs[True][0]
            past = int((np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want))
                       .sum())
            gaps[op] = max_err(got, want)
            require(past == 0, f"pipelined {op}: {past} entries past rtol "
                    f"1e-5, atol 1e-6 of the unpipelined session")
            eager[op] = outs[False][0]
        # A first request that is an embed: the next reconstruct replays
        # stage 0 while stage 1 warms up, on stage 0's static output.
        first = pps["embed first"] = PipelinedSession(
            ref, devices=["cuda:0", "cuda:0"],
            num_microbatches=PP_MICROBATCHES)
        require(np.array_equal(first.embed(x), eager["embed"])
                and all(np.array_equal(first.reconstruct(x),
                                       eager["reconstruct"])
                        for _ in range(2)),
                "pipelined reconstruct after an embed first: graphed "
                "differs from eager")
        timing = {}
        for c in (False, True):
            host, host_one = [], []
            for _ in range(10):
                for s, into in ((pps[c], host), (ref, host_one)):
                    t0 = time.perf_counter()
                    s.reconstruct(x)
                    into.append(1e3 * (time.perf_counter() - t0))
            least = int(0.95 * timing[False][1]["device_events"]) if c else 1
            timing[c] = (statistics.median(host), overhead_trace(
                torch, lambda s=pps[c]: s.reconstruct(x),
                "compiled.pipeline", min_events=least),
                statistics.median(host_one))
        require(timing[True][1]["graph_launches"] == 2 * PP_MICROBATCHES,
                f"pipelined reconstruct graphed: host operations "
                f"{timing[True][1]['host']}")
        return (f"pipelined serving, B={BATCH} f32 in {PP_MICROBATCHES} "
                f"microbatches, both stages on cuda:0: reconstruct, embed "
                f"and decode graphed (a warm-up, then replays), and "
                f"reconstruct after an embed first, bit-equal to "
                f"the eager pipeline, the same launches (K5 "
                f"{PP_MICROBATCHES} a batch), against the unpipelined "
                f"session max abs gap "
                + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
                + f" (rtol 1e-5, atol 1e-6); reconstruct, host median of "
                f"10: graphed {timing[True][0]:.3f} ms, "
                f"{_overhead_str(timing[True][1])}; eager "
                f"{timing[False][0]:.3f} ms, {_overhead_str(timing[False][1])}"
                f"; the unpipelined session in the same loops "
                f"{timing[False][2]:.3f} / {timing[True][2]:.3f} ms")
    finally:
        for s in pps.values():
            s.close()
        ref.close()


@contextlib.contextmanager
def shared_kernel_outputs(store: dict, replay: bool):
    """Within the block, the head's argmax and the EMD's outputs (cost,
    grad1, grad2) are recorded from the card's kernel calls into
    ``store``; with ``replay`` the CPU's plain versions hand back the
    card's, in call order (the EMD's without computing its dense form,
    tens of seconds of host time at B=32, N=2048). Both are inside their
    kernels' charges, so a StepCost counts neither's work; the argmax sets
    K4's charge, its distinct rows, which a near-tie the CPU decided the
    other way would move."""
    from pointnet_autoencoder_tpu_torch.ops import emd as em
    from pointnet_autoencoder_tpu_torch.ops import fused_head as fh

    head_name = "head_max_plain" if replay else "head_max_cuda"
    emd_name = "emd_forward_plain" if replay else "emd_forward_cuda"
    head_fn, emd_fn = getattr(fh, head_name), getattr(em, emd_name)
    if not replay:
        store.update(argmax=[], emd=[])
    taken = {"argmax": 0, "emd": 0}

    def take(key):
        out = store[key][taken[key]]
        taken[key] += 1
        return out

    def head(x, w, scale, shift):
        maxout, argmax = head_fn(x, w, scale, shift)
        if replay:
            return maxout, take("argmax")
        store["argmax"].append(argmax.cpu())
        return maxout, argmax

    def emd(x1, x2):
        if replay:
            return take("emd")
        out = emd_fn(x1, x2)
        store["emd"].append(tuple(t.cpu() for t in out))
        return out

    # A kernel wrapper counts its launches on the function its module's
    # name holds: the stand-in carries the count meanwhile.
    patched = ((fh, head_name, head_fn, head), (em, emd_name, emd_fn, emd))
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


def step_costs(torch, tr, x, cpu_config, context):
    """A ``utils/roofline.StepCost`` of one step of the eager card Trainer
    ``tr`` on ``x``, and of the same step on a CPU Trainer of
    ``cpu_config`` given ``tr``'s state from before it (weights, BN
    statistics, optimizer slots and step), the card's argmax and EMD
    outputs replayed (``shared_kernel_outputs``). Returns (card, cpu,
    the CPU step's seconds)."""
    from pointnet_autoencoder_tpu_torch.train import checkpoint
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer
    from pointnet_autoencoder_tpu_torch.utils import roofline

    require(tr._steps is None, "step_costs counts an eager Trainer")
    before = checkpoint.to_host(tr.state.state_dict())
    store = {}
    with context(), shared_kernel_outputs(store, replay=False):
        with roofline.StepCost() as card:
            tr.train_step(x)
    torch.cuda.synchronize()
    cpu = Trainer(cpu_config, device="cpu")
    try:
        cpu.state.load_state_dict(before)
        x_host = x.cpu()
        t0 = time.perf_counter()
        with shared_kernel_outputs(store, replay=True):
            with roofline.StepCost() as host:
                cpu.train_step(x_host)
        seconds = time.perf_counter() - t0
    finally:
        cpu.close()
    return card, host, seconds


def cost_gap(card, cpu) -> str:
    """Holds the card's StepCost to the CPU's for the same call: every op
    of the model part, every kernel's charge and the matmul flops equal.
    Returns the difference of the parts the two run differently by design
    (the optimizer's update, the copies between host and card), which is
    the whole difference, with the ops in it that differ."""
    def part(cost, name):
        return {op: v for (p, op), v in cost.ops.items() if p == name}

    require(part(card, "model") == part(cpu, "model")
            and card.kernels == cpu.kernels
            and card.matmul_flops == cpu.matmul_flops,
            f"StepCost card vs CPU outside the update: model part "
            f"{card.part('model')} vs {cpu.part('model')}, kernels "
            f"{card.kernels} vs {cpu.kernels}, matmul flops "
            f"{card.matmul_flops} vs {cpu.matmul_flops}")
    parts = sorted(({p for p, _ in card.ops} | {p for p, _ in cpu.ops})
                   - {"model"})
    gap = card.bytes - cpu.bytes
    by_design = sum(card.part(p)["bytes"] - cpu.part(p)["bytes"]
                    for p in parts)
    require(gap == by_design, f"StepCost card - CPU {gap} B, the update "
            f"and transfers {by_design} B")
    ops = []
    for p in parts:
        a, b = part(card, p), part(cpu, p)
        for op in sorted(set(a) | set(b)):
            ca, cb = a.get(op, [0, 0.0, 0.0]), b.get(op, [0, 0.0, 0.0])
            if ca != cb:
                ops.append(f"{op.replace('aten.', '')} {ca[0]}x {ca[1]:.0f} "
                           f"B / {cb[0]}x {cb[1]:.0f} B")
    return (f"card {card.bytes:.0f} B, CPU {cpu.bytes:.0f} B: equal op by op "
            f"in the model part ({card.part('model')['calls']:.0f} ops, "
            f"{card.part('model')['bytes']:.0f} B), in the {len(card.kernels)}"
            f" kernels' charges and the matmul flops; the difference "
            f"{gap:.0f} B is exactly the {' and '.join(parts)} part's "
            f"(card / CPU: {'; '.join(ops)})")


def roofline_line(torch, tag, config, dtype, batch, timing, costs,
                  serving=False) -> str:
    """``roofline_report`` of the card's StepCost against the graphed host
    median and against the traced device busy time, and ``cost_gap``;
    also printed as one JSON line."""
    from pointnet_autoencoder_tpu_torch.utils import roofline

    card, cpu, cpu_s = costs
    host_ms, trace = timing[True][0], timing[True][1]
    reports = {what: roofline.roofline_report(
        config, batch, NUM_POINT, ms, cost=card, dtype=dtype,
        serving=serving) for what, ms in (("host", host_ms),
                                          ("busy", trace["busy_ms"]))}
    gap = cost_gap(card, cpu)
    say("compiled", "roofline json " + json.dumps(
        {"case": tag, "reports": reports, "card": card.summary(),
         "cpu": cpu.summary(), "cpu_seconds": cpu_s}))
    r = reports["host"]
    terms = ", ".join(f"{k[:-3]} {v:.5f}" for k, v in r.items()
                      if k.endswith("_ms") and k not in (
                          "measured_ms", "analytic_floor_ms", "mem_bound_ms",
                          "bound_ms", "composed_bound_ms"))
    return (f"roofline {tag}: floor {r['analytic_floor_ms']:.5f} ms "
            f"({terms}); memory bound {r['mem_bound_ms']:.4f} ms "
            f"({r['hbm_bytes_GB']:.4f} GB, {r['program_flops_G']:.2f} "
            f"GFLOP counted); bound {r['bound_ms']:.4f} ms"
            + (" (composed: floor + memory bound)"
               if "composed_bound_ms" in r else " (the memory bound)")
            + "; " + "; ".join(
                f"against the {what} {rep['measured_ms']:.4f} ms: "
                f"pct_of_bound {rep['pct_of_bound']:.1f}%, pct_of_roofline "
                f"{rep['pct_of_roofline']:.2f}%, mfu {rep['mfu']:.5f}"
                for what, rep in (("graphed host median", reports["host"]),
                                  ("device busy", reports["busy"])))
            + f" (H100 roofline at {nvidia_smi_line()}); StepCost {gap}; "
            f"the CPU's step took {cpu_s:.1f} s")


def median_busy_ms(torch, fn, label, reps=10) -> float:
    """The median over ``reps`` traced calls of ``fn()`` (each followed by
    a synchronize) of the device's busy time inside each call's host
    span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            with record_function(label):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    spans = [e.time_range for e in events
             if e.name == label and e.device_type == DeviceType.CPU]
    require(len(spans) == reps, f"trace holds {len(spans)} calls")
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA and e.name != label
                    and not getattr(e, "is_user_annotation", False))
    busy = []
    for span in spans:
        total, end = 0.0, span.start
        for a, b in device:
            a, b = max(a, span.start), min(b, span.end)
            if b > max(a, end):
                total += b - max(a, end)
                end = b
        busy.append(total / 1e3)
    require(all(b > 0 for b in busy), f"a traced call shows no device "
            f"time: {busy}")
    return statistics.median(busy)


def compiled_moment_stats(torch, rng):
    """The encoder's training forward and backward at B=32, N=2048 with
    ``moment_stats`` True and False from the same weights, in f32 and in
    bf16: in f32 the features and the new BN moving statistics held at
    the JAX package's tolerances (tests/test_fused_encoder.py:217-226:
    features rtol/atol 2e-3, statistics rtol 1e-3, atol 1e-4); in bf16 at
    the bf16 tolerance (``TOL["bf16"]``), since one flipped bf16 rounding
    of a channel's folded BN scale moves that channel by a bf16 step
    (2^-8, twice JAX's rtol) in every later layer: the count of features
    outside JAX's tolerance is printed. Each one's device busy time per
    call, the median of 10 traced calls. Returns the report line."""
    from pointnet_autoencoder_tpu_torch.nn.encoder import PointNetEncoder

    dev = torch.device("cuda")
    pts = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to(dev)
    cot = torch.from_numpy(rng.randn(BATCH, 1024).astype(np.float32)).to(
        dev)

    def call(enc):
        out = enc(pts, train=True, bn_momentum=0.5)
        (out.float() * cot).sum().backward()
        return out

    parts = []
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        encoders = {m: PointNetEncoder(
            dtype=dtype, generator=torch.Generator().manual_seed(SEED),
            moment_stats=m).to(dev) for m in (True, False)}
        feats, stats = {}, {}
        for m, enc in encoders.items():
            feats[m] = call(enc).detach().float().cpu().numpy()
            stats[m] = {n: b.cpu().numpy() for n, b in enc.named_buffers()}
        feat_tol, stat_tol = (((2e-3, 2e-3), (1e-3, 1e-4)) if name == "f32"
                              else (TOL["bf16"], TOL["bf16"]))
        feat_err = max_err(feats[True], feats[False])
        outside = int(np.sum(np.abs(feats[True] - feats[False])
                             > 2e-3 + 2e-3 * np.abs(feats[False])))
        require(close(feats[True], feats[False], *feat_tol),
                f"moment_stats {name} features: max abs err {feat_err:.3e} "
                f"over (rtol, atol) {feat_tol}")
        stat_err = max(max_err(stats[True][n], stats[False][n])
                       for n in stats[False])
        require(all(close(stats[True][n], stats[False][n], *stat_tol)
                    for n in stats[False]),
                f"moment_stats {name} BN moving statistics: max abs err "
                f"{stat_err:.3e} over (rtol, atol) {stat_tol}")
        busy = {m: median_busy_ms(torch, lambda e=enc: call(e),
                                  f"compiled.moment_stats.{name}.{m}")
                for m, enc in encoders.items()}
        parts.append(
            f"{name}: features max abs err {feat_err:.3e} ((rtol, atol) "
            f"{feat_tol}; {outside} of {feats[False].size} outside JAX's "
            f"2e-3), BN moving statistics {stat_err:.3e} ({stat_tol}); "
            f"device busy per call, median of 10 traced calls: "
            f"moment_stats {busy[True]:.4f} ms, direct {busy[False]:.4f} ms")
    return (f"encoder training forward and backward, B={BATCH} "
            f"N={NUM_POINT}, moment_stats against direct statistics "
            f"({nvidia_smi_line()}): " + "; ".join(parts))


def phase_compiled(torch, counters, data, weights, tmp, rng):
    """The captured steps and forwards. See the module docstring, phase
    22."""
    import io

    from pointnet_autoencoder_tpu_torch.ops import benchmarks

    t_phase = time.perf_counter()
    say("compiled", nvidia_smi_line())

    def case(line, t0):
        say("compiled", f"{line} ok ({time.perf_counter() - t0:.1f} s)")

    x = torch.from_numpy(clouds(rng, BATCH, NUM_POINT)).to("cuda")
    cases = [(name, True, "device") for name in ALL_FAMILIES]
    cases += [("model", False, "device"), ("model", True, "host")]
    roofs = []
    for name, bf16, mode in cases:
        t0 = time.perf_counter()
        line, timing, costs = compiled_training(
            torch, counters, data, tmp, name, bf16, mode, x,
            count=mode == "device")
        case(line, t0)
        if (name, bf16, mode) == ("model", True, "device"):
            # The graphed step's device busy time and host median, which
            # phase bench's headline step is held between.
            model_step = (timing[True][1]["busy_ms"], timing[True][0])
        if costs is not None:
            dtype = "bf16" if bf16 else "f32"
            roofs.append((f"{name} {dtype} step", name, dtype, BATCH,
                          timing, costs, False))
    t0 = time.perf_counter()
    case(compiled_resume(torch, data, tmp, x), t0)
    for tag in COMPILED_MASTERS:
        t0 = time.perf_counter()
        line, timing, costs = compiled_training(
            torch, counters, data, tmp, "model", True, "device", x,
            master=tag, count=True)
        case(line, t0)
        roofs.append((f"model bf16 {tag} step", "model", "bf16", BATCH,
                      timing, costs, False))
        t0 = time.perf_counter()
        case(compiled_master_resume(torch, data, tmp, tag), t0)
    for batch, bf16, m in ((BATCH, False, 1), (1, False, 1),
                           (BATCH, True, 1), (BATCH, False, 2),
                           (1, False, 2)):
        t0 = time.perf_counter()
        line, timing, costs = compiled_serving(
            torch, counters, weights, rng, batch, bf16, model_parallel=m,
            count=m == 1)
        case(line, t0)
        if costs is not None:
            dtype = "bf16" if bf16 else "f32"
            roofs.append((f"served reconstruct B={batch} {dtype}", "model",
                          dtype, batch, timing, costs, True))
    t0 = time.perf_counter()
    for roof in roofs:
        say("compiled", roofline_line(torch, *roof) + " ok")
    case(f"{len(roofs)} roofline reports", t0)
    t0 = time.perf_counter()
    case(compiled_pipeline(torch, counters, weights, rng), t0)
    # The runs main makes, kept to run each again eagerly.
    runs, real = [], {n: getattr(benchmarks, n)
                      for n in ("bench_chamfer_gd", "bench_emd_gd")}

    def kept(name):
        def run(**kw):
            out = real[name](**kw)
            runs.append((name, kw, out))
            return out
        return run

    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    try:
        for name in real:
            setattr(benchmarks, name, kept(name))
        with contextlib.redirect_stdout(out):
            rc = benchmarks.main(["--quick"])
    finally:
        for name, fn in real.items():
            setattr(benchmarks, name, fn)
    got = {k: fn.launches for k, fn in counters.items()}
    want = {"fused_encoder_eval": 0, "nn_distance": 21, "fused_head_fwd": 0,
            "fused_head_bwd": 0, "nn_distance_grad": 21, "emd_forward": 6,
            "batch_norm_fwd": 0, "batch_norm_bwd": 0}
    require(rc == 0 and got == want,
            f"ops.benchmarks --quick: rc {rc}, launches {got}, want {want}")
    finals = []
    for name, kw, graphed in runs:
        eager = real[name](**kw, compiled=False)
        require(eager["final_loss"] == graphed["final_loss"],
                f"ops.benchmarks --quick {graphed['config']}: final loss "
                f"{graphed['final_loss']!r} graphed, {eager['final_loss']!r} "
                f"eager")
        finals.append(f"{graphed['config']} {graphed['final_loss']!r}")
    require(len(runs) == 2, f"ops.benchmarks --quick made {len(runs)} runs")
    say("compiled", "ops.benchmarks --quick (each GD step a replayed "
        "program): " + " | ".join(out.getvalue().strip().splitlines())
        + f"; launches {got}; final losses equal to the same loops run "
        f"eagerly on the card: {'; '.join(finals)} ok")
    t0 = time.perf_counter()
    case(compiled_moment_stats(torch, np.random.RandomState(SEED + 101)),
         t0)
    say("compiled", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return model_step


# Phase bench: the port's benchmark script (bench.py).
BENCH_BUDGET_S = 120
BENCH_EXTRAS = ("model_emd", "serving", "serving_b1", "families",
                "serving_b512")
# Every row the benchmark times at N=2048 on one card.
BENCH_ROWS = ("model", "model_emd", "serving", "serving_b1", "dispatch",
              "model_cpu", "model_upconv", "model_fc_upconv",
              "model_hierachy", "serving_b512")


def free_slurm_job_id() -> int:
    """A SLURM job id whose derived port (id % 4096 + 61440, jax's rule)
    is free on this host now."""
    import socket

    rng = np.random.RandomState(os.getpid())
    for port in rng.permutation(np.arange(61440, 65536)):
        with socket.socket() as s:
            try:
                s.bind(("", int(port)))
            except OSError:
                continue
        return int(port) - 61440
    raise PhaseError("no free port in 61440-65535")


def run_bench(tmp, tag, **env_extra):
    """``python -m pointnet_autoencoder_tpu_torch.bench`` in a subprocess
    from the repository's root, its self-record in ``tmp``: rc 0, every
    stdout line a JSON object, the self-record the last one. Returns the
    last line and the seconds the run took."""
    from pointnet_autoencoder_tpu_torch.parallel import mesh

    root = os.path.dirname(os.path.abspath(__file__))
    self_path = os.path.join(tmp, f"bench_self_{tag}.json")
    # No launcher variable of this process reaches the benchmark.
    launch = (mesh.LAUNCHER_ENV + mesh.SLURM_ENV + mesh.OMPI_ENV
              + (mesh.PRTE_MARKER,))
    env = {k: v for k, v in os.environ.items() if k not in launch}
    env.update(BENCH_SELF_PATH=self_path, **env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pointnet_autoencoder_tpu_torch.bench"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"bench ({tag}): rc {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    try:
        lines = [json.loads(line) for line in proc.stdout.splitlines()]
    except ValueError as e:
        raise PhaseError(f"bench ({tag}): a stdout line is not JSON ({e}): "
                         f"{proc.stdout[-2000:]}") from None
    require(bool(lines), f"bench ({tag}): no artifact line")
    with open(self_path) as f:
        require(json.loads(f.read()) == lines[-1],
                f"bench ({tag}): the self-record is not the last line")
    return lines[-1], seconds


def bench_rows_held(tag, extras, names):
    """Every row in ``names`` ran captured, one graph replay a call, and
    launched each kernel as often as its eager call times its calls;
    returns a summary of each."""
    rows = extras["rows"]
    require(sorted(rows) == sorted(names),
            f"bench ({tag}): rows {sorted(rows)}, want {sorted(names)}")
    out = []
    for name in names:
        row = rows[name]
        want = {k: v * row["calls"] for k, v in row["eager_launches"].items()}
        require(row["replays"] == row["calls"],
                f"bench ({tag}) {name}: {row['replays']} replays for "
                f"{row['calls']} calls ({row['path']})")
        require(row["launches"] == want,
                f"bench ({tag}) {name}: launches {row['launches']} over "
                f"{row['calls']} calls, the eager call's times the calls "
                f"{want}")
        per = {k: v for k, v in row["eager_launches"].items() if v}
        out.append(f"{name} {row['ms']!r} ms (windows {row['windows_ms']}), "
                   f"{row['calls']} calls, {row['replays']} replays, "
                   f"launches a call {per}")
    return out


def phase_bench(tmp, model_step):
    """The port's benchmark script, as a user runs it. See the module
    docstring, phase 23."""
    import torch

    t_phase = time.perf_counter()
    # The script runs in a process of its own.
    release_cache(torch, "bench")
    say("bench", nvidia_smi_line())
    busy, host = model_step
    rec, seconds = run_bench(tmp, "one_card",
                             BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    extras = rec["extras"]
    require(rec["metric"] == f"train_throughput_model_b32_n{NUM_POINT}"
            and rec["unit"] == "shapes/sec/chip"
            and extras["device"]["count"] == 1 and extras["group"] is None,
            f"bench: metric {rec['metric']}, unit {rec['unit']}, device "
            f"{extras['device']}, group {extras['group']}")
    require(extras["skipped"] == [], f"bench: skipped {extras['skipped']} "
            f"at a budget of {BENCH_BUDGET_S} s")
    step_ms = extras["model_step_ms"]
    require(0.9 * busy <= step_ms <= 1.1 * host,
            f"bench: model_step_ms {step_ms!r} outside [0.9 x the graphed "
            f"step's busy {busy!r}, 1.1 x its host median {host!r}] of "
            f"phase compiled")
    for line in bench_rows_held("one card", extras, BENCH_ROWS):
        say("bench", line + " ok")
    roof = extras["roofline"]
    say("bench", "roofline: " + "; ".join(
        f"{k} pct_of_bound {v.get('pct_of_bound')!r} mfu {v['mfu']!r}"
        for k, v in sorted(roof.items())) + "; serving B=32 pct_of_bound "
        f"{extras['serving_roofline'].get('pct_of_bound')!r}, B=1 "
        f"{extras['serving_b1']['roofline'].get('pct_of_bound')!r}, B=512 "
        f"{extras['serving_b512']['roofline'].get('pct_of_bound')!r}")
    say("bench", f"one card: headline {rec['value']!r} shapes/sec/chip, "
        f"vs_baseline {rec['vs_baseline']!r}, model_step_ms {step_ms!r} in "
        f"[0.9 x {busy!r}, 1.1 x {host!r}]; model_emd "
        f"{extras['model_emd_step_ms']!r} ms; families "
        f"{extras['family_step_ms']}; serving B=32 "
        f"{extras['serving_fwd_ms']!r} ms, B=1 {extras['serving_b1']} "
        f"(dispatch_overhead_ms), B=512 "
        f"{extras['serving_b512']['measured_ms']!r} ms; bench_wall_s "
        f"{extras['bench_wall_s']!r}, the command {seconds:.1f} s ok")
    job_id = free_slurm_job_id()
    rec1, seconds1 = run_bench(
        tmp, "slurm_nccl_one", BENCH_BUDGET_S="0", SLURM_JOB_ID=str(job_id),
        SLURM_STEP_NODELIST="localhost", SLURM_NTASKS="1", SLURM_PROCID="0",
        SLURM_LOCALID="0")
    ex1 = rec1["extras"]
    require(rec1["metric"] == rec["metric"]
            and ex1["group"] == {"backend": "nccl", "ranks": 1}
            and ex1["skipped"] == list(BENCH_EXTRAS),
            f"bench under SLURM: metric {rec1['metric']}, group "
            f"{ex1['group']}, skipped {ex1['skipped']}")
    lines = bench_rows_held("SLURM, NCCL group of 1", ex1, ("model",))
    say("bench", f"SLURM variables (job {job_id}, port {job_id + 61440}), "
        f"an NCCL group of 1, headline only: {rec1['value']!r} "
        f"shapes/sec/chip, model_step_ms {ex1['model_step_ms']!r}; "
        f"{lines[0]}; the command {seconds1:.1f} s ok")
    say("bench", f"headlines: one card {json.dumps(rec['value'])}, NCCL "
        f"group of 1 under SLURM {json.dumps(rec1['value'])} "
        f"shapes/sec/chip")
    say("bench", f"phase took {time.perf_counter() - t_phase:.1f} s")


def release_cache(torch, phase: str) -> None:
    """Hand back what this process's allocator holds cached before a phase
    whose rank processes share the card, and say how much it held."""
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    say(phase, f"this process had {reserved / 2 ** 30:.2f} GiB reserved, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB after emptying "
        f"its cache")


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
        from pointnet_autoencoder_tpu_torch.ops import emd as em
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
        t0 = time.perf_counter()
        host_logs = build.build(build.HOST_SOURCES)
        say(phase, f"g++ built {', '.join(host_logs) or 'nothing (cached)'} "
            f"(the native renderer and the data loader's parser) in "
            f"{time.perf_counter() - t0:.1f} s")

        rng = np.random.RandomState(SEED)
        phase = "kernels"
        errs = phase_kernels(torch, fe, ch, fh, rng)
        # The phases of this slice draw from seeds of their own, so the
        # earlier phases see the inputs they saw before it.
        errs["emd_forward"] = phase_emd_kernel(
            torch, em, np.random.RandomState(SEED + 1))
        phase = "batch_norm_kernel"
        phase_batch_norm_kernel(torch, np.random.RandomState(SEED + 3))
        counters = kernel_counters(ch, fe, fh, em)

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
            data, fixture_s = write_chair_fixture(tmp)
            phase = "fastio"
            phase_fastio(data, tmp)
            phase = "train"
            trainer, logger, train_launches, best_path = phase_train(
                torch, counters, data, fixture_s, tmp, rng)
            phase = "train_emd"
            emd_trainer, emd_logger, emd_launches = phase_train_emd(
                torch, counters, data, tmp, np.random.RandomState(SEED + 2))
            # Serving kernels keep their serving-path counts, the training
            # kernels the training path's, and K6 the EMD training path's.
            launches.update({k: v for k, v in train_launches.items()
                             if k not in serving})
            launches["emd_forward"] = emd_launches["emd_forward"]
            try:
                phase = "timings"
                rows = phase_timings(torch, fe, ch, fh, em, session, trainer,
                                     emd_trainer, rng, launches, errs)
                batch_norm_timings(torch, np.random.RandomState(SEED + 4))
            finally:
                for closing in (trainer, logger, emd_trainer, emd_logger):
                    closing.close()
            phase = "families"
            phase_families(torch, counters, data, tmp,
                           np.random.RandomState(SEED + 9))
            phase = "pcn_emd"
            phase_pcn_emd(torch, counters)
            phase = "cli_test"
            phase_cli_test(torch, counters, fe, ch, data, best_path, tmp,
                           np.random.RandomState(SEED + 11))
            phase = "export_import"
            phase_export_import(torch, best_path, tmp,
                                np.random.RandomState(SEED + 12))
            phase = "preempt"
            phase_preempt(torch, data, tmp)
            phase = "data_parallel"
            release_cache(torch, phase)
            phase_data_parallel(torch, counters, session, weights, data, tmp,
                                np.random.RandomState(SEED + 20))
            phase = "master"
            release_cache(torch, phase)
            phase_master(torch, counters, data, tmp,
                         np.random.RandomState(SEED + 60))
            phase = "point_parallel"
            release_cache(torch, phase)
            phase_point_parallel(torch, counters, data, tmp,
                                 np.random.RandomState(SEED + 60))
            phase = "tensor_parallel"
            release_cache(torch, phase)
            phase_tensor_parallel(torch, counters, data, tmp,
                                  np.random.RandomState(SEED + 71))
            phase = "pipeline_parallel"
            phase_pipeline_parallel(torch, fe, session, weights,
                                    np.random.RandomState(SEED + 75))
            phase = "dp_sp"
            release_cache(torch, phase)
            phase_dp_sp(torch, tmp)
            phase = "hwcheck"
            phase_hwcheck(torch, counters)
            phase = "profile"
            phase_profile(torch, counters, data, tmp,
                          np.random.RandomState(SEED + 90))
            phase = "compiled"
            model_step = phase_compiled(torch, counters, data, weights, tmp,
                                        np.random.RandomState(SEED + 100))
            phase = "bench"
            phase_bench(tmp, model_step)
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
