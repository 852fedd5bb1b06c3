"""Serve a model over TCP with dynamic batching, on the card.

    python -m pointnet_autoencoder_tpu_torch.cli.serve \\
        --model model --model_path weights.npz --num_point 2048 \\
        --batch_size 32 --port 7433 [--bf16] [--device cuda]

``--model_path`` is a reference-named ``.npz`` (written by the JAX
package's ``cli.export --format reference_npz``), a ``.pt`` state_dict
saved from the port, or a training checkpoint of the port's
``cli/train.py`` (``model.ckpt``, ``best_model_epoch_NNN.ckpt``). Protocol and client (``PointClient``) are in
``pointnet_autoencoder_tpu_torch/serve.py``. SIGTERM drains cleanly:
queued requests get 'server shutting down' errors instead of dead sockets.
"""

from __future__ import annotations

import argparse
import signal
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="model")
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def build_server(args: argparse.Namespace):
    """The session and the (not yet started) server the flags describe."""
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.serve import PointServer

    session = InferenceSession(args.model, args.model_path, args.num_point,
                               batch_size=args.batch_size, bf16=args.bf16,
                               device=args.device)
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
          f"batch={args.batch_size}, device={session.device}) on "
          f"{args.host}:{server.port}", flush=True)
    signal.signal(signal.SIGTERM, lambda s, f: server.request_stop())
    server.serve_forever()
    print("server stopped", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
