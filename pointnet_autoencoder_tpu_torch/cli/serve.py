"""Serve a model over TCP with dynamic batching, on the card.

    python -m pointnet_autoencoder_tpu_torch.cli.serve \\
        --model model --model_path weights.npz --num_point 2048 \\
        --batch_size 32 --port 7433 [--bf16] [--device cuda] \\
        [--data_parallel N | --pipeline_parallel [--num_microbatches 4]]

``--model_path`` is a reference-named ``.npz`` (written by the JAX
package's ``cli.export --format reference_npz``), a ``.pt`` state_dict
saved from the port, or a training checkpoint of the port's
``cli/train.py`` (``model.ckpt``, ``best_model_epoch_NNN.ckpt``). Protocol and client (``PointClient``) are in
``pointnet_autoencoder_tpu_torch/serve.py``. Every ``--model`` serves; a
``--num_point`` that its decoder cannot emit fails with ValueError before
the weights load. ``--data_parallel N`` serves from N replicas, on cards
0..N-1 (N CPU replicas with ``--device cpu``), each taking batch_size/N
rows of every batch. ``--pipeline_parallel`` serves through a 2-stage
pipeline (``parallel/pp.py``): the encoder on card 0 and the decoder on
card 1 (both on the CPU with ``--device cpu``), each batch in
``--num_microbatches`` microbatches, each stage a captured program on
cards; it is exclusive with
``--data_parallel``. ``--compilation_cache_dir`` (an XLA cache in the JAX
package) has no counterpart and is refused. SIGTERM drains cleanly:
queued requests get 'server shutting down' errors instead of dead sockets.
"""

from __future__ import annotations

import argparse
import signal
import sys

import torch

from pointnet_autoencoder_tpu_torch.config import refuse_unported
from pointnet_autoencoder_tpu_torch.models.registry import available_models


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="model",
                   help=f"Model name, one of {', '.join(available_models())} "
                        f"[default: model]")
    p.add_argument("--model_path", required=True,
                   help="Reference-named .npz, the port's .pt state_dict "
                        "or a training checkpoint of the port")
    p.add_argument("--num_point", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=32,
                   help="Device batch = packing limit")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7433)
    p.add_argument("--max_delay_ms", type=float, default=2.0,
                   help="How long a partial batch waits for co-riders")
    p.add_argument("--max_pending_shapes", type=int, default=None,
                   help="Backpressure bound: shapes admitted but not yet "
                        "answered; past it requests fail fast with "
                        "'server overloaded' [default: 64 batches' worth]")
    p.add_argument("--max_connections", type=int, default=256,
                   help="Concurrent-connection bound (one thread each); "
                        "excess connections are refused with an error "
                        "frame [default: 256]")
    p.add_argument("--io_timeout", type=float, default=30.0,
                   help="Per-socket read/write deadline in seconds; a "
                        "client stalled mid-frame is dropped after this "
                        "long instead of pinning a connection slot "
                        "[default: 30]")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 parameters and matmul inputs (BN "
                        "statistics stay f32); default full f32")
    p.add_argument("--data_parallel", type=int, default=None,
                   help="Shard server batches over N devices")
    p.add_argument("--pipeline_parallel", action="store_true",
                   help="Two-stage encoder|decoder pipeline on the first "
                        "two devices (parallel/pp.py); exclusive with "
                        "--data_parallel")
    p.add_argument("--num_microbatches", type=int, default=4,
                   help="Microbatches per batch under --pipeline_parallel")
    p.add_argument("--compilation_cache_dir", default=None,
                   help="Not ported (no XLA programs to cache)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def build_server(args: argparse.Namespace):
    """The session and the (not yet started) server the flags describe."""
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.parallel.pp import PipelinedSession
    from pointnet_autoencoder_tpu_torch.serve import PointServer

    refuse_unported("compilation_cache_dir", args.compilation_cache_dir)
    if args.pipeline_parallel and args.data_parallel:
        raise SystemExit(
            "--pipeline_parallel is exclusive with --data_parallel")
    cpu = torch.device(args.device).type == "cpu"
    devices = None
    if (args.data_parallel or 1) > 1 and cpu:
        devices = [args.device] * args.data_parallel
    session = InferenceSession(args.model, args.model_path, args.num_point,
                               batch_size=args.batch_size, bf16=args.bf16,
                               device=args.device,
                               data_parallel=args.data_parallel,
                               devices=devices)
    if args.pipeline_parallel:
        session = PipelinedSession(
            session, devices=[args.device] * 2 if cpu else None,
            num_microbatches=args.num_microbatches)
    server = PointServer(session, host=args.host, port=args.port,
                         max_delay_ms=args.max_delay_ms,
                         max_pending_shapes=args.max_pending_shapes,
                         max_connections=args.max_connections,
                         io_timeout_s=args.io_timeout)
    return session, server


def main(argv=None):
    args = build_parser().parse_args(argv)
    session, server = build_server(args)
    print("warming up (the first launch builds the CUDA kernels)...",
          flush=True)
    server.start()  # warmup runs before the socket binds
    print(f"serving {session.model_name} (num_point={session.num_point}, "
          f"batch={args.batch_size}, devices="
          f"{[str(d) for d in session.devices]}) on "
          f"{args.host}:{server.port}", flush=True)
    signal.signal(signal.SIGTERM, lambda s, f: server.request_stop())
    server.serve_forever()
    print("server stopped", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
