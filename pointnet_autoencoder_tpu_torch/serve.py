"""Network serving: a dynamic-batching point-cloud inference server.

The port's copy of ``pointnet_autoencoder_tpu/serve.py`` (numpy only, same
wire protocol, batching, backpressure and drain), driving the port's
``InferenceSession``. A TCP server owns one session and coalesces
concurrent client requests into full device batches, so many low-rate
clients share the card at its batched throughput instead of paying a
launch each.

    python -m pointnet_autoencoder_tpu_torch.cli.serve \\
        --model model --model_path weights.npz --num_point 2048 \\
        --port 7433

    client = PointClient("localhost", 7433)
    rec = client.reconstruct(cloud)          # (N,3) or (B,N,3) float32
    emb = client.embed(cloud)
    dec = client.decode(embedding)

Design notes:

- Batching is the whole point: a full batch costs the device little more
  than one shape. The batcher drains whatever is queued, packs up to the
  session's batch size per op kind, and waits at most ``max_delay_ms`` for
  stragglers before dispatching a partial batch (latency floor for a lone
  client, throughput ceiling under load).
- One batcher thread owns all device work; socket threads only queue and
  wait. Serializing the launches keeps one stream of work on the card and
  the session's padded batch shape constant.
- The wire protocol is deliberately primitive: a 4-byte big-endian
  length + JSON header, then a raw little-endian float32 payload. No
  schema compiler, no dependency; any language speaks it in ten lines.
- Python is the right tier here: at 2048 points a request is 24 KB and
  the server's job is queue management around one device call whose hot
  path is the CUDA kernels.

Protocol:
    request  header {"op": "reconstruct"|"embed"|"decode"|"ping"|"stats",
                     "shape": [...]} + payload float32 bytes (row-major)
    response header {"ok": true, "shape": [...]} + payload
             or     {"ok": false, "error": "..."} (no payload)
"""

from __future__ import annotations

import itertools
import json
import queue
import select
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

_HDR = struct.Struct(">I")
_MAX_HEADER = 1 << 16
_MAX_PAYLOAD = 1 << 30


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def send_message(sock: socket.socket, header: dict,
                 payload: Optional[np.ndarray] = None) -> None:
    if payload is not None:
        header = dict(header)
        header["shape"] = list(payload.shape)
    raw = json.dumps(header).encode()
    sock.sendall(_HDR.pack(len(raw)) + raw)
    if payload is not None:
        sock.sendall(np.ascontiguousarray(payload, "<f4").tobytes())


def recv_message(sock: socket.socket) -> Tuple[dict, Optional[np.ndarray]]:
    (hlen,) = _HDR.unpack(_read_exact(sock, 4))
    if hlen > _MAX_HEADER:
        raise ValueError(f"header too large ({hlen} bytes)")
    header = json.loads(_read_exact(sock, hlen))
    # Everything malformed must surface as ValueError (the one-connection
    # error path); raw AttributeError/TypeError from a non-dict header or
    # non-integer shape entries would kill the client thread instead.
    if not isinstance(header, dict):
        raise ValueError(f"header must be a JSON object, got "
                         f"{type(header).__name__}")
    payload = None
    shape = header.get("shape")
    if shape:
        if (not isinstance(shape, list)
                or not all(isinstance(d, int) and not isinstance(d, bool)
                           and d >= 0 for d in shape)):
            raise ValueError(f"shape must be a list of non-negative "
                             f"integers, got {shape!r}")
        count = 1  # python ints: no silent int64 overflow on huge dims
        for d in shape:
            count *= d
        nbytes = count * 4
        if nbytes > _MAX_PAYLOAD:
            raise ValueError(f"payload too large ({nbytes} bytes)")
        payload = np.frombuffer(
            _read_exact(sock, nbytes), "<f4").reshape(shape)
    return header, payload


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _Pending:
    """One client shape-batch waiting for device results."""

    __slots__ = ("op", "data", "seq", "event", "result", "error")

    _seq_counter = itertools.count()

    def __init__(self, op: str, data: np.ndarray):
        self.op = op
        self.data = data  # (b, ...) leading axis = shapes in this request
        self.seq = next(self._seq_counter)  # arrival order across all ops
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None


class PointServer:
    """Dynamic-batching TCP front end over an ``InferenceSession``.

    Args:
      session: the restored model (its ``batch_size`` is the packing limit).
      host/port: bind address; port 0 picks an ephemeral port (see
        ``.port`` after ``start()``).
      max_delay_ms: how long a lone request waits for co-riders before a
        partial batch dispatches anyway.
      max_pending_shapes: backpressure bound — shapes admitted but not yet
        answered. Past it, new requests get an immediate
        "server overloaded" error (and a ``rejected`` stats count) instead
        of queueing without limit; a flood of clients then costs bounded
        memory and fails fast rather than timing everyone out. (A request
        larger than the bound still admits when the server is idle.)
        Default: 64 batches' worth.
      max_connections: concurrent-connection bound (one thread per
        connection); excess connections get a "too many connections"
        error frame and an immediate close, so a connection flood costs
        bounded threads.
      io_timeout_s: per-socket read/write deadline. A client that stalls
        mid-frame (sent a header, never the payload) is dropped after
        this long instead of pinning its connection slot forever — with
        timeout-less sockets, max_connections half-frame connections
        would deny service permanently.
    """

    def __init__(self, session, host: str = "127.0.0.1", port: int = 0,
                 max_delay_ms: float = 2.0,
                 max_pending_shapes: Optional[int] = None,
                 max_connections: int = 256,
                 io_timeout_s: float = 30.0):
        self._session = session
        self._host, self._port = host, port
        self._max_delay = max_delay_ms / 1e3
        self._max_pending = (max_pending_shapes if max_pending_shapes
                             is not None else 64 * session.batch_size)
        self._inflight = 0  # admitted shapes not yet answered (under _lock)
        self._max_conns = max_connections
        self._io_timeout = io_timeout_s
        self._conns = 0  # live client connections (under _lock)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        # Per-op pending lists, owned exclusively by the batcher thread;
        # the inbox queue is the only cross-thread handoff.
        self._pending_by_op: dict = {}
        self._emb_dim: Optional[int] = None  # learned during warmup
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0, "shapes": 0, "batches": 0,
            "batched_shapes": 0, "errors": 0, "rejected": 0,
            "batch_ms_total": 0.0, "batches_timed": 0,
        }

    # -- lifecycle ----------------------------------------------------------

    def start(self, warmup: bool = True) -> "PointServer":
        if warmup:
            self.warmup()
        self._sock = socket.create_server((self._host, self._port))
        self._sock.settimeout(0.2)
        self._port = self._sock.getsockname()[1]
        for fn in (self._accept_loop, self._batch_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def warmup(self) -> None:
        """Run every served op once before accepting traffic: the first
        CUDA launch builds and loads the kernels (an nvcc run per source
        when no library is cached), which would otherwise land on the
        first clients' requests and their timeouts."""
        dummy = np.zeros((1, self._session.num_point, 3), np.float32)
        self._session.reconstruct(dummy)
        emb = self._session.embed(dummy)
        self._session.decode(emb)
        # Known embedding width lets decode requests be validated at the
        # protocol layer instead of surfacing a matmul shape error.
        self._emb_dim = int(emb.shape[-1])

    @property
    def port(self) -> int:
        return self._port

    def request_stop(self) -> None:
        """Signal-handler-safe shutdown request: flips the stop event and
        returns immediately. The batcher fails queued requests cleanly
        ('server shutting down') and ``serve_forever``/``stop`` join the
        threads."""
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._sock is not None:
            self._sock.close()

    def serve_forever(self) -> None:  # pragma: no cover - CLI convenience
        try:
            while not self._stop.is_set():
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # -- socket side ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # Bound every read/write: a peer that stalls mid-frame (or
            # stops draining responses) must release its slot, not hold
            # it until process exit. A timeout mid-frame desyncs the
            # stream, but the connection is dropped on timeout anyway.
            conn.settimeout(self._io_timeout)
            with self._lock:
                admit = self._conns < self._max_conns
                if admit:
                    self._conns += 1
            if not admit:
                try:
                    send_message(conn, {
                        "ok": False,
                        "error": (f"too many connections "
                                  f"({self._max_conns} already open)"),
                    })
                except OSError:
                    pass
                conn.close()
                continue
            t = threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True)
            t.start()

    def _client_loop(self, conn: socket.socket) -> None:
        try:
            self._client_loop_inner(conn)
        finally:
            with self._lock:
                self._conns -= 1

    def _client_loop_inner(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                # Poll for the next frame so idle connections observe
                # shutdown; once a frame starts, reads block to completion
                # (a read timeout mid-frame would desync the stream).
                readable, _, _ = select.select([conn], [], [], 0.5)
                if not readable:
                    continue
                try:
                    header, payload = recv_message(conn)
                except (ConnectionError, OSError):
                    return
                except ValueError as e:
                    send_message(conn, {"ok": False, "error": str(e)})
                    return
                try:
                    self._handle(conn, header, payload)
                except (ConnectionError, OSError):
                    return
                except Exception as e:  # surface, don't kill the connection
                    with self._lock:
                        self._stats["errors"] += 1
                    send_message(conn, {"ok": False, "error": str(e)})

    def _handle(self, conn, header: dict, payload) -> None:
        op = header.get("op")
        if op == "ping":
            send_message(conn, {"ok": True, "model":
                                self._session.model_name,
                                "num_point": self._session.num_point})
            return
        if op == "stats":
            with self._lock:
                stats = dict(self._stats)
            if stats["batches"]:
                stats["mean_batch_occupancy"] = (
                    stats["batched_shapes"] / stats["batches"])
            if stats["batches_timed"]:
                # Separate denominator: failed batches count in 'batches'
                # but contribute no service time; dividing by it would
                # permanently skew the mean low.
                stats["mean_batch_ms"] = round(
                    stats["batch_ms_total"] / stats["batches_timed"], 3)
            send_message(conn, {"ok": True, "stats": stats})
            return
        if op not in ("reconstruct", "embed", "decode"):
            raise ValueError(f"unknown op {op!r}")
        if payload is None:
            raise ValueError("missing payload")
        data = np.asarray(payload, np.float32)
        want_ndim = 2 if op == "decode" else 3
        single = data.ndim == want_ndim - 1
        if single:
            data = data[None]
        if data.ndim != want_ndim:
            raise ValueError(
                f"{op}: expected {want_ndim}-D (or single-item) payload, "
                f"got shape {data.shape}")
        if op != "decode" and data.shape[1:] != (self._session.num_point, 3):
            raise ValueError(
                f"{op}: expected (*, {self._session.num_point}, 3), got "
                f"{data.shape}")
        if (op == "decode" and self._emb_dim is not None
                and data.shape[1] != self._emb_dim):
            raise ValueError(
                f"decode: expected (*, {self._emb_dim}) embeddings, got "
                f"{data.shape}")
        b = data.shape[0]
        with self._lock:
            # A request larger than the bound must still make progress:
            # admit it whenever the server is idle (the session chunks
            # oversized batches internally) and reject it only while
            # other work is in flight.
            if self._inflight > 0 and self._inflight + b > self._max_pending:
                self._stats["rejected"] += 1
                overloaded = True
            else:
                self._inflight += b
                self._stats["requests"] += 1
                self._stats["shapes"] += b
                overloaded = False
        if overloaded:
            send_message(conn, {
                "ok": False,
                "error": (f"server overloaded: {self._max_pending} shapes "
                          f"already pending; retry later"),
            })
            return
        pending = _Pending(op, data)
        try:
            self._queue.put(pending)
            while not pending.event.wait(timeout=1.0):
                if self._stop.is_set():
                    pending.error = "server shutting down"
                    break
            if pending.error is not None:
                send_message(conn, {"ok": False, "error": pending.error})
            else:
                result = pending.result[0] if single else pending.result
                send_message(conn, {"ok": True}, result)
        finally:
            with self._lock:
                self._inflight -= b

    # -- device side ----------------------------------------------------------

    def _route_inbox(self, timeout: float) -> bool:
        """Move one inbox arrival (waiting up to ``timeout``) plus any
        others already queued into the per-op pending lists. Returns
        whether anything arrived. Batcher thread only.

        Groups key on (op, per-item shape), not op alone: two decode
        requests with different embedding widths must never share an
        ``np.concatenate`` (possible only before warmup learns _emb_dim,
        e.g. ``start(warmup=False)``)."""
        try:
            item = self._queue.get(timeout=timeout) if timeout > 0.0 \
                else self._queue.get_nowait()
        except queue.Empty:
            return False
        while True:
            key = (item.op, item.data.shape[1:])
            self._pending_by_op.setdefault(key, []).append(item)
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return True

    def _collect(self) -> List[_Pending]:
        """Assemble one same-op batch. Requests sort into per-op pending
        lists as they arrive, so interleaved ops batch with their own
        kind instead of splitting a group at every op boundary (a single
        FIFO degrades to occupancy ~1 under a strict reconstruct/embed
        interleave); across ops, the op whose head request arrived first
        dispatches first (no starvation). Once a group starts, waits up
        to max_delay_ms for same-op co-riders."""
        if not any(self._pending_by_op.values()):
            if not self._route_inbox(timeout=0.2):
                return []
        key = min((k for k, q in self._pending_by_op.items() if q),
                  key=lambda k: self._pending_by_op[k][0].seq)
        pend = self._pending_by_op[key]
        limit = self._session.batch_size
        group: List[_Pending] = []
        total = 0
        deadline = time.monotonic() + self._max_delay
        while True:
            while pend and total < limit:
                group.append(pend.pop(0))
                total += group[-1].data.shape[0]
            if total >= limit:
                break
            timeout = deadline - time.monotonic()
            # Arrivals only land via the inbox; block on it for the rest
            # of the straggler window (or bail if nothing shows up).
            if timeout <= 0.0 or not self._route_inbox(timeout=timeout):
                break
        return group

    def _batch_loop(self) -> None:
        fns = {
            "reconstruct": self._session.reconstruct,
            "embed": self._session.embed,
            "decode": self._session.decode,
        }
        while not self._stop.is_set():
            # The sole batcher thread must never die: any failure inside
            # one iteration fails that group's requests (so their socket
            # threads unblock with an error frame) and the loop continues.
            group: List[_Pending] = []
            try:
                group = self._collect()
                if not group:
                    continue
                packed = np.concatenate([p.data for p in group])
                with self._lock:
                    self._stats["batches"] += 1
                    self._stats["batched_shapes"] += packed.shape[0]
                t0 = time.monotonic()
                out = fns[group[0].op](packed)
            except Exception as e:
                with self._lock:
                    self._stats["errors"] += 1
                for p in group:
                    p.error = f"{type(e).__name__}: {e}"
                    p.event.set()
                continue
            # Device service time (the session returns host numpy, so the
            # dispatch has completed); requests/shapes/occupancy plus this
            # give the stats endpoint a full utilization picture.
            dt_ms = 1e3 * (time.monotonic() - t0)
            with self._lock:
                self._stats["batch_ms_total"] += dt_ms
                self._stats["batches_timed"] += 1
            i = 0
            for p in group:
                b = p.data.shape[0]
                p.result = out[i:i + b]
                i += b
                p.event.set()
        # Shutdown: fail any requests still queued (inbox or per-op
        # pending lists) so their socket threads unblock instead of
        # waiting out their timeout loops.
        leftovers = [p for q in self._pending_by_op.values() for p in q]
        self._pending_by_op.clear()
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for p in leftovers:
            p.error = "server shutting down"
            p.event.set()


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class PointClient:
    """Blocking client for ``PointServer``; one socket, many requests.
    Thread-safe via an internal lock (use one client per thread for
    pipelining -- the server batches across connections)."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._lock = threading.Lock()

    def close(self) -> None:
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, header: dict, payload=None):
        with self._lock:
            send_message(self._sock, header, payload)
            resp, out = recv_message(self._sock)
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "server error"))
        return resp, out

    def ping(self) -> dict:
        resp, _ = self._call({"op": "ping"})
        return resp

    def stats(self) -> dict:
        resp, _ = self._call({"op": "stats"})
        return resp["stats"]

    def reconstruct(self, points) -> np.ndarray:
        _, out = self._call({"op": "reconstruct"},
                            np.asarray(points, np.float32))
        return out

    def embed(self, points) -> np.ndarray:
        _, out = self._call({"op": "embed"}, np.asarray(points, np.float32))
        return out

    def decode(self, embeddings) -> np.ndarray:
        _, out = self._call({"op": "decode"},
                            np.asarray(embeddings, np.float32))
        return out
