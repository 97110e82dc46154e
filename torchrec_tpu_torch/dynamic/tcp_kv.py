"""A key-value store over a real TCP socket (``torchrec_tpu/dynamic/
tcp_kv.py``, byte for byte on the same wire protocol and with the same
size caps): ``TcpKVServer``, a threaded loopback server, and ``TcpKV``,
its client.  ``reliability.TcpKVCommitBarrier`` speaks it (dim-1 rows as
flags), and a client of either package talks to a server of the other.

Wire protocol (length-free, fixed headers, little-endian):
  handshake: client sends  magic u32 (0x7265C0DE), dim u32,
             ns_len u32, ns bytes; server replies status u8
             (1 = ok, 0 = dim conflicts with the namespace's)
  request:   op u8, n u64, payload
    op=1 PUT   payload keys i64[n] + rows f32[n*dim]; reply status u8
    op=2 GET   payload keys i64[n]; reply rows f32[n*dim] + found u8[n]
    op=3 LEN   reply count u64
    op=4 KEYS  reply count u64 + keys i64[count]

Left out: the registration of the ``tcp`` scheme in the parameter
server's IO registry, which waits for ``dynamic/kv_store.py`` (ROADMAP
A10).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Dict, Tuple

import numpy as np

MAGIC = 0x7265C0DE

# Wire-supplied sizes are attacker-controlled (any peer that reaches
# the port can send them): cap them BEFORE
# allocating, so a malformed request can't trigger an unbounded
# allocation.  Oversized mid-stream counts drop the connection — the
# framing has no error frame, so replying would desync the protocol.
MAX_NS_LEN = 1 << 10  # 1 KiB namespace
MAX_DIM = 1 << 14  # 16k-wide rows
MAX_KEYS_PER_REQUEST = 1 << 20  # 1M keys per PUT/GET (8 MiB of ids)
MAX_REQUEST_BYTES = 1 << 28  # n*dim*4 row-payload cap per PUT/GET (256 MiB)
MAX_KEYS_TOTAL = 1 << 27  # KEYS reply cap the client will buffer (1 GiB)


def _rows_too_big(n: int, dim: int) -> bool:
    """True when a request's row payload (n*dim f32) would exceed the
    per-request byte cap — n and dim individually in range is not
    enough; their PRODUCT is what gets allocated."""
    return n > MAX_KEYS_PER_REQUEST or 4 * n * dim > MAX_REQUEST_BYTES


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _recv_header(sock: socket.socket, n: int):
    """Like ``_recv_exact`` but a clean EOF before the FIRST byte means
    the peer is done (returns None)."""
    first = sock.recv(1)
    if not first:
        return None
    return first + _recv_exact(sock, n - 1)


class TcpKVServer:
    """Threaded loopback KV server; one namespace dict per handshake
    namespace, shared across connections (last write wins, like the
    native log store)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._stores: Dict[str, Dict[int, np.ndarray]] = {}
        self._dims: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._conns: set = set()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                with outer._lock:
                    outer._conns.add(sock)
                try:
                    magic, dim, ns_len = struct.unpack(
                        "<III", _recv_exact(sock, 12)
                    )
                    if magic != MAGIC:
                        return
                    if not (0 < dim <= MAX_DIM) or ns_len > MAX_NS_LEN:
                        # refuse before allocating/reading the namespace
                        sock.sendall(b"\x00")
                        return
                    ns = _recv_exact(sock, ns_len).decode()
                    with outer._lock:
                        # a namespace's dim is fixed by its first
                        # client; a conflicting handshake is refused
                        # (mixed-dim rows in one dict would corrupt
                        # every later GET)
                        known = outer._dims.setdefault(ns, dim)
                        if known != dim:
                            sock.sendall(b"\x00")
                            return
                        store = outer._stores.setdefault(ns, {})
                    sock.sendall(b"\x01")
                    while True:
                        hdr = _recv_header(sock, 9)
                        if hdr is None:
                            return
                        op, n = struct.unpack("<BQ", hdr)
                        if op in (1, 2) and _rows_too_big(n, dim):
                            return  # drop: payload exceeds the wire caps
                        if op == 1:  # PUT
                            keys = np.frombuffer(
                                _recv_exact(sock, 8 * n), np.int64
                            )
                            rows = np.frombuffer(
                                _recv_exact(sock, 4 * n * dim), np.float32
                            ).reshape(n, dim)
                            with outer._lock:
                                for k, r in zip(keys, rows):
                                    store[int(k)] = r.copy()
                            sock.sendall(b"\x01")
                        elif op == 2:  # GET
                            keys = np.frombuffer(
                                _recv_exact(sock, 8 * n), np.int64
                            )
                            rows = np.zeros((n, dim), np.float32)
                            found = np.zeros((n,), np.uint8)
                            with outer._lock:
                                for i, k in enumerate(keys):
                                    r = store.get(int(k))
                                    if r is not None:
                                        rows[i] = r
                                        found[i] = 1
                            sock.sendall(rows.tobytes() + found.tobytes())
                        elif op == 3:  # LEN
                            with outer._lock:
                                c = len(store)
                            sock.sendall(struct.pack("<Q", c))
                        elif op == 4:  # KEYS
                            with outer._lock:
                                ks = np.asarray(
                                    sorted(store), np.int64
                                )
                            sock.sendall(
                                struct.pack("<Q", len(ks)) + ks.tobytes()
                            )
                        else:
                            return
                except (ConnectionError, OSError):
                    return
                finally:
                    with outer._lock:
                        outer._conns.discard(sock)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self, drop_connections: bool = False):
        """Stop accepting connections.  ``drop_connections=True`` also
        severs every ESTABLISHED connection (in-flight requests see a
        ConnectionError) — a plain shutdown only closes the listener,
        which is invisible to clients holding persistent sockets; the
        elastic coordinator-drop fault injection needs the hard cut."""
        if drop_connections:
            with self._lock:
                conns = list(self._conns)
            for sock in conns:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
        self._server.shutdown()
        self._server.server_close()


def _connect_with_retry(
    host: str,
    port: int,
    deadline_s: float,
    backoff_s: float,
    per_attempt_timeout: float = 30.0,
) -> socket.socket:
    """``socket.create_connection`` with jittered-exponential-backoff
    retry under an overall deadline.

    Worker processes come up in arbitrary order, and a first PUT/GET
    that lands before the KV server binds must not fail the worker.
    Connection-refused/reset and timeouts retry; anything else (e.g.
    DNS failure) surfaces immediately.  The jitter decorrelates a gang
    of workers all retrying the same freshly-started coordinator."""
    import random
    import time

    start = time.monotonic()
    attempt = 0
    while True:
        try:
            # clamp each attempt to the REMAINING deadline: against a
            # host that drops SYNs (filtered port) the connect blocks
            # for its full timeout, and an unclamped 30s attempt would
            # overshoot a sub-second overall budget by 60x
            remaining = deadline_s - (time.monotonic() - start)
            return socket.create_connection(
                (host, port),
                timeout=max(0.05, min(per_attempt_timeout, remaining)),
            )
        except (ConnectionError, socket.timeout, TimeoutError) as e:
            elapsed = time.monotonic() - start
            if elapsed >= deadline_s:
                raise ConnectionError(
                    f"tcp kv: could not connect to {host}:{port} within "
                    f"{deadline_s:.1f}s ({attempt + 1} attempts): {e}"
                ) from e
            delay = min(
                backoff_s * (2 ** attempt) * (0.5 + random.random()),
                max(0.0, deadline_s - elapsed),
            )
            time.sleep(delay)
            attempt += 1


class _ProtocolCapError(IOError):
    """Deliberate poison-close (a reply exceeded the wire caps) — NOT a
    transient disconnect; retrying would just re-request the same
    oversized reply, so the reconnect wrapper re-raises it as-is."""


class TcpKV:
    """The client: ``rest`` is ``host:port/namespace`` (namespace
    optional), ``dim`` the width of a row.

    connect_deadline_s / connect_backoff_s: overall budget and base
    backoff for connecting to a late-starting coordinator (see
    ``_connect_with_retry``).

    A transient disconnect MID-request (coordinator restart, LB drain,
    a dropped TCP session) does not fail the round trip: every op
    runs under a reconnect wrapper that redials + re-handshakes with
    the same jittered backoff and replays the request, up to
    ``op_retries`` times.  The replay is safe because PUT is
    last-write-wins and GET/LEN/KEYS are pure, and a reply desync is
    impossible: each request/response pair holds the request lock for
    its whole round trip and any mid-stream failure abandons the
    socket rather than reusing it."""

    def __init__(
        self,
        rest: str,
        dim: int,
        connect_deadline_s: float = 10.0,
        connect_backoff_s: float = 0.05,
        op_retries: int = 2,
    ):
        addr, _, ns = rest.partition("/")
        host, _, port = addr.partition(":")
        if not 0 < dim <= MAX_DIM:
            raise ValueError(f"dim {dim} outside (0, {MAX_DIM}]")
        self.dim = dim
        ns_b = (ns or "default").encode()
        if len(ns_b) > MAX_NS_LEN:
            raise ValueError(f"namespace longer than {MAX_NS_LEN} bytes")
        self._host, self._port = host, int(port)
        self._ns, self._ns_label = ns_b, ns or "default"
        self._deadline_s = connect_deadline_s
        self._backoff_s = connect_backoff_s
        self.op_retries = int(op_retries)
        self._sock = self._dial()
        self._lock = threading.Lock()

    def _dial(self) -> socket.socket:
        """Connect + handshake a fresh socket (no lock held — the
        blocking connect/recv must not stall concurrent requests)."""
        sock = _connect_with_retry(
            self._host, self._port, self._deadline_s, self._backoff_s
        )
        try:
            sock.sendall(
                struct.pack("<III", MAGIC, self.dim, len(self._ns))
                + self._ns
            )
            ok = _recv_exact(sock, 1) == b"\x01"
        except (ConnectionError, OSError):
            sock.close()
            raise
        if not ok:
            sock.close()
            raise ValueError(
                f"tcp kv handshake refused for namespace "
                f"{self._ns_label!r}: dim {self.dim} conflicts with the "
                "namespace's established dim (or exceeds the wire caps)"
            )
        return sock

    def _reconnect(self) -> None:
        """Replace a dead socket: dial + re-handshake OUTSIDE the
        request lock, then swap the socket object under it."""
        sock = self._dial()
        with self._lock:
            old, self._sock = self._sock, sock
        try:
            old.close()
        except OSError:
            pass

    def _with_reconnect(self, op):
        """Run one request/response closure, transparently redialing
        and replaying on a transient disconnect (see class docstring).
        The reconnect's own deadline is exhausted -> the final
        ConnectionError surfaces to the caller."""
        attempts = 0
        while True:
            try:
                return op()
            except _ProtocolCapError:
                raise
            except (ConnectionError, TimeoutError, OSError):
                attempts += 1
                if attempts > self.op_retries:
                    raise
                self._reconnect()

    def put(self, keys, rows) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.shape != (len(keys), self.dim):
            # a bare assert would be stripped under -O and desync the
            # wire protocol with silently-misparsed payload bytes
            raise ValueError(
                f"rows shape {rows.shape} != ({len(keys)}, {self.dim})"
            )
        if _rows_too_big(len(keys), self.dim):
            raise ValueError(
                f"put of {len(keys)} keys x dim {self.dim} exceeds the "
                "per-request wire caps; chunk the put"
            )
        status = self._with_reconnect(lambda: self._put_rpc(keys, rows))
        if status != b"\x01":
            raise IOError("tcp kv put failed")

    def _put_rpc(self, keys: np.ndarray, rows: np.ndarray) -> bytes:
        with self._lock:
            self._sock.sendall(
                struct.pack("<BQ", 1, len(keys))
                + keys.tobytes() + rows.tobytes()
            )
            status = _recv_exact(self._sock, 1)
        return status

    def get(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.ascontiguousarray(keys, np.int64)
        n = len(keys)
        if _rows_too_big(n, self.dim):
            raise ValueError(
                f"get of {n} keys x dim {self.dim} exceeds the "
                "per-request wire caps; chunk the get"
            )
        return self._with_reconnect(lambda: self._get_rpc(keys, n))

    def _get_rpc(
        self, keys: np.ndarray, n: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            self._sock.sendall(
                struct.pack("<BQ", 2, n) + keys.tobytes()
            )
            rows = np.frombuffer(
                _recv_exact(self._sock, 4 * n * self.dim), np.float32
            ).reshape(n, self.dim).copy()
            found = np.frombuffer(
                _recv_exact(self._sock, n), np.uint8
            ).astype(bool)
        return rows, found

    def __len__(self) -> int:
        return self._with_reconnect(self._len_rpc)

    def _len_rpc(self) -> int:
        with self._lock:
            self._sock.sendall(struct.pack("<BQ", 3, 0))
            return struct.unpack("<Q", _recv_exact(self._sock, 8))[0]

    def keys(self) -> np.ndarray:
        return self._with_reconnect(self._keys_rpc)

    def _keys_rpc(self) -> np.ndarray:
        with self._lock:
            self._sock.sendall(struct.pack("<BQ", 4, 0))
            c = struct.unpack("<Q", _recv_exact(self._sock, 8))[0]
            if c > MAX_KEYS_TOTAL:
                # server-supplied count: don't trust it with our memory.
                # The unread payload would desync every later request on
                # this socket, so poison the connection before raising
                # (mirrors the server's drop-the-connection policy).
                self.close()
                raise _ProtocolCapError(
                    f"KEYS reply count {c} exceeds cap {MAX_KEYS_TOTAL}; "
                    "connection closed"
                )
            return np.frombuffer(
                _recv_exact(self._sock, 8 * c), np.int64
            ).copy()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
