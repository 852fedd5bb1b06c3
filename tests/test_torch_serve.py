"""The port's dynamic-batching server (pointnet_autoencoder_tpu_torch/
serve.py) over a CPU session: protocol round trip, coalescing of
concurrent clients, errors that keep the connection alive, and the CLI's
construction of the server. Mirrors tests/test_serve.py."""

import signal
import threading

import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu_torch.cli import serve as cli_serve
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.serve import (PointClient, PointServer,
                                                  recv_message, send_message)

torch.set_num_threads(2)

NUM_POINT = 64


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "model.pt")
    model = get_model_spec("model").make(
        NUM_POINT, generator=torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def session(weights):
    args = cli_serve.build_parser().parse_args(
        ["--model_path", weights, "--num_point", str(NUM_POINT),
         "--batch_size", "4", "--device", "cpu"])
    session, _ = cli_serve.build_server(args)
    return session


@pytest.fixture()
def server(session):
    srv = PointServer(session, port=0, max_delay_ms=1.0).start()
    yield srv
    srv.stop()


def _clouds(n, seed=0):
    return np.random.RandomState(seed).randn(n, NUM_POINT, 3).astype(
        np.float32)


def test_roundtrip_matches_direct_session(server, session):
    with PointClient("127.0.0.1", server.port) as c:
        info = c.ping()
        assert info["model"] == "model" and info["num_point"] == NUM_POINT
        pts = _clouds(3)
        np.testing.assert_allclose(
            c.reconstruct(pts), session.reconstruct(pts), rtol=1e-6)
        np.testing.assert_allclose(c.embed(pts), session.embed(pts),
                                   rtol=1e-6)
        one = c.reconstruct(pts[0])
        assert one.shape == (NUM_POINT, 3)
        np.testing.assert_allclose(one, session.reconstruct(pts[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            c.decode(c.embed(pts)), c.reconstruct(pts), rtol=1e-6)
        stats = c.stats()
        assert stats["batches"] >= 1 and stats["mean_batch_ms"] > 0.0


def test_concurrent_requests_are_batched(session):
    srv = PointServer(session, port=0, max_delay_ms=250.0).start()
    try:
        pts = _clouds(4, seed=1)
        want = session.reconstruct(pts)
        results = [None] * 4
        barrier = threading.Barrier(4)

        def worker(i):
            with PointClient("127.0.0.1", srv.port) as c:
                barrier.wait(timeout=30)
                results[i] = c.reconstruct(pts[i])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for i in range(4):
            np.testing.assert_allclose(results[i], want[i], rtol=1e-6)
        with PointClient("127.0.0.1", srv.port) as c:
            stats = c.stats()
        assert stats["requests"] == 4
        assert stats["batches"] < 4
        assert stats["mean_batch_occupancy"] > 1.0
    finally:
        srv.stop()


def test_errors_keep_connection_alive(server, session):
    with PointClient("127.0.0.1", server.port) as c:
        with pytest.raises(RuntimeError, match="expected"):
            c.reconstruct(np.zeros((2, NUM_POINT + 1, 3), np.float32))
        with pytest.raises(RuntimeError, match="decode: expected"):
            c.decode(np.zeros((2, 7), np.float32))
        send_message(c._sock, {"op": "nonsense"})
        resp, _ = recv_message(c._sock)
        assert not resp["ok"] and "unknown op" in resp["error"]
        pts = _clouds(1, seed=2)
        np.testing.assert_allclose(
            c.reconstruct(pts), session.reconstruct(pts), rtol=1e-6)


def test_cli_flags_and_sigterm_drain(weights, monkeypatch):
    args = cli_serve.build_parser().parse_args(["--model_path", weights])
    assert (args.device, args.num_point, args.batch_size, args.port) == \
        ("cuda", 2048, 32, 7433)
    assert not args.bf16 and args.max_delay_ms == 2.0
    handlers = {}
    registered = threading.Event()

    def fake_signal(sig, fn):
        handlers[sig] = fn
        registered.set()

    monkeypatch.setattr(signal, "signal", fake_signal)
    servers = []
    real_start = PointServer.start

    def start(self, warmup=True):
        servers.append(self)
        return real_start(self, warmup)

    monkeypatch.setattr(PointServer, "start", start)
    t = threading.Thread(target=cli_serve.main, args=([
        "--model_path", weights, "--num_point", str(NUM_POINT),
        "--batch_size", "4", "--port", "0", "--device", "cpu"],))
    t.start()
    try:
        assert registered.wait(timeout=60)
        with PointClient("127.0.0.1", servers[0].port) as c:
            assert c.ping()["num_point"] == NUM_POINT
        handlers[signal.SIGTERM](signal.SIGTERM, None)
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        for srv in servers:
            srv.request_stop()
        t.join(timeout=30)
