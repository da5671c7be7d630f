"""Transport layer under nodes, peers, and the directory (DESIGN.md §11).

One RPC protocol, two carriers:

* :class:`LoopbackTransport` — in-process dispatch straight into a
  handler. Requests and responses still round-trip through msgpack, so a
  handler exercised in-process sees exactly the types it would see off
  the wire (tuples arrive as lists, keys as plain strings).
* :class:`SocketTransport` / :class:`SocketServer` — the same protocol
  over unix or TCP sockets, reusing the ``shm_ipc`` framing: a 4-byte
  little-endian length prefix, then a msgpack control frame. Streaming
  responses interleave raw **byte frames** (same prefix, no msgpack)
  terminated by a zero-length frame and a trailing control frame, so a
  multi-hundred-MiB model never materializes as one msgpack blob.

Wire protocol::

  request  frame: {op: "...", ...}
  response frame: {ok: true, ...}                      (unary)
                | {ok: true, stream: true, ...}        (streaming header)
                  <byte frame> * N, <empty byte frame>
                  {ok: true, ...}                      (trailer)
                | {ok: false, error: "..."}

PyTorch port: the msgpack frames are encoded by ``core.wire``, the port's
own codec for the protocol's subset of msgpack, byte-equal to
``msgpack.packb(use_bin_type=True)``, so port and JAX-package endpoints
talk to each other.

Failure taxonomy — both exception types are ``OSError`` subclasses on
purpose: every cluster fetch path already treats ``OSError`` as "this
source failed, re-plan or fall back to CLOUD", so a dead daemon or a hung
link degrades into a re-planned fetch, never a wedged gather thread:

* :class:`TransportError` (``ConnectionError``) — the carrier failed:
  connect refused, mid-frame EOF, read timeout, short write.
* :class:`RemoteError` (``OSError``) — the carrier worked but the remote
  handler reported failure (``ok: false``).
"""
from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Callable, Iterable, Optional, Tuple, Union

from repro_torch.core import wire

# refuse absurd control frames (a desynced stream decodes garbage lengths;
# better a crisp TransportError than a 4 GiB allocation)
MAX_FRAME_BYTES = 512 << 20
DEFAULT_CHUNK_BYTES = 1 << 20
DEFAULT_CALL_TIMEOUT_S = 30.0
DEFAULT_IDLE_TIMEOUT_S = 300.0

# a handler returns a control dict, optionally paired with a byte-chunk
# iterator (the streaming response body)
Response = Union[dict, Tuple[dict, Iterable[bytes]]]


class TransportError(ConnectionError):
    """The transport itself failed (connect/timeout/mid-frame EOF)."""


class RemoteError(OSError):
    """The remote handler reported ``ok: false``; carries its message."""


# ---------------------------------------------------------------------------
# robust framing primitives (also used by shm_ipc)
# ---------------------------------------------------------------------------

def sendall(sock: socket.socket, data) -> None:
    """``sock.sendall`` with explicit partial-write/EINTR handling: a
    signal landing mid-``sendall`` can leave an unknown number of bytes
    sent — looping over ``send`` keeps our own byte count, so a retried
    write never duplicates or drops a prefix."""
    view = memoryview(data)
    while view:
        try:
            n = sock.send(view)
        except InterruptedError:
            continue  # EINTR before any byte moved: retry the same slice
        except socket.timeout as e:
            raise TransportError(f"send timed out: {e}") from e
        except OSError as e:
            raise TransportError(f"send failed: {e}") from e
        view = view[n:]


def recvn(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes. Returns None on a clean EOF *before any
    byte* (the peer closed between messages); raises
    :class:`TransportError` on EOF mid-message, timeout, or socket error
    — a truncated frame is corruption, not a clean close."""
    if n == 0:
        return b""
    parts = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except InterruptedError:
            continue
        except socket.timeout as e:
            raise TransportError(f"recv timed out after {got}/{n} bytes") \
                from e
        except OSError as e:
            raise TransportError(f"recv failed: {e}") from e
        if not chunk:
            if got == 0:
                return None
            raise TransportError(f"connection closed mid-frame "
                                 f"({got}/{n} bytes)")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def send_frame(sock: socket.socket, obj: dict) -> None:
    """One length-prefixed msgpack control frame."""
    data = wire.packb(obj)
    sendall(sock, struct.pack("<I", len(data)) + data)


def recv_frame(sock: socket.socket) -> Optional[dict]:
    """One control frame; None on clean EOF between frames."""
    hdr = recvn(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack("<I", hdr)
    if n > MAX_FRAME_BYTES:
        raise TransportError(f"frame length {n} exceeds cap "
                             f"{MAX_FRAME_BYTES} (desynced stream?)")
    body = recvn(sock, n)
    if body is None:  # EOF landed exactly between header and body
        raise TransportError("connection closed between frame header "
                             "and body")
    # strict_map_key off: directory snapshots key maps by int shard id
    return wire.unpackb(body)


def send_chunk(sock: socket.socket, data: bytes) -> None:
    """One raw byte frame of a streaming body (empty = end of stream)."""
    sendall(sock, struct.pack("<I", len(data)))
    if data:
        sendall(sock, data)


def recv_chunk(sock: socket.socket) -> Optional[bytes]:
    """One raw byte frame; None marks end of stream."""
    hdr = recvn(sock, 4)
    if hdr is None:
        raise TransportError("connection closed inside a byte stream")
    (n,) = struct.unpack("<I", hdr)
    if n == 0:
        return None
    if n > MAX_FRAME_BYTES:
        raise TransportError(f"chunk length {n} exceeds cap")
    data = recvn(sock, n)
    if data is None:  # EOF between chunk header and body is truncation,
        raise TransportError("connection closed between chunk header "
                             "and body")  # never a clean end-of-stream
    return data


# ---------------------------------------------------------------------------
# addresses
# ---------------------------------------------------------------------------

def parse_address(address: str) -> Tuple[str, object]:
    """``"unix:/path.sock"`` -> ("unix", path); ``"tcp:host:port"`` ->
    ("tcp", (host, port))."""
    if address.startswith("unix:"):
        return "unix", address[len("unix:"):]
    if address.startswith("tcp:"):
        host, _, port = address[len("tcp:"):].rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    raise ValueError(f"bad transport address {address!r} "
                     f"(want unix:/path or tcp:host:port)")


def _connect(address: str, timeout_s: Optional[float]) -> socket.socket:
    kind, where = parse_address(address)
    if kind == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(timeout_s)
    try:
        sock.connect(where)
    except OSError as e:
        sock.close()
        raise TransportError(f"connect {address}: {e}") from e
    return sock


# ---------------------------------------------------------------------------
# client transports
# ---------------------------------------------------------------------------

class SocketTransport:
    """RPC client over one lazily-connected socket.

    Thread-safe: a per-request lock serializes whole request/response
    exchanges (two threads interleaving frames on one socket is exactly
    the ``RemoteTrimsClient`` bug this layer exists to prevent). Reads
    carry ``timeout_s``, so a hung server surfaces as a
    :class:`TransportError` — an ``OSError`` the fetch paths re-plan on —
    instead of wedging the calling gather thread. A request that fails on
    a *reused* connection (the server restarted, or an idle timeout closed
    it) is retried once on a fresh connection."""

    remote = True  # peers behind this transport measure real wire time

    def __init__(self, address: str,
                 timeout_s: Optional[float] = DEFAULT_CALL_TIMEOUT_S):
        self.address = address
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._fresh = False  # True until the first exchange completes
        self._responded = False  # current request saw its response header

    def _ensure_sock(self) -> socket.socket:
        if self._sock is None:
            self._sock = _connect(self.address, self.timeout_s)
            self._fresh = True
        return self._sock

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _exchange(self, req: dict, sink: Optional[Callable[[bytes], None]],
                  sock: Optional[socket.socket] = None):
        pooled = sock is None
        if pooled:
            sock = self._ensure_sock()
        send_frame(sock, req)
        resp = recv_frame(sock)
        if resp is None:
            raise TransportError(f"{self.address}: connection closed "
                                 f"awaiting response")
        # this request's own response started arriving: a carrier failure
        # from here on (mid-stream EOF/timeout) must never be retried —
        # the sink may already hold a partial body. Dedicated (ephemeral)
        # exchanges never touch the pooled connection's retry state — they
        # run lock-free in parallel with it.
        if pooled:
            self._responded = True
            self._fresh = False
        if not resp.get("ok", False):
            raise RemoteError(resp.get("error", "remote handler failed"))
        if not resp.get("stream"):
            return resp
        while True:
            chunk = recv_chunk(sock)
            if chunk is None:
                break
            if sink is not None:
                sink(chunk)
        trailer = recv_frame(sock)
        if trailer is None:
            raise TransportError(f"{self.address}: connection closed "
                                 f"awaiting stream trailer")
        if not trailer.get("ok", False):
            raise RemoteError(trailer.get("error", "stream failed"))
        merged = dict(resp)
        merged.update(trailer)
        return merged

    def call(self, req: dict, dedicated: bool = False) -> dict:
        """One unary RPC. Raises :class:`RemoteError` on handler failure,
        :class:`TransportError` on carrier failure."""
        return self.call_stream(req, None, dedicated=dedicated)

    def call_stream(self, req: dict,
                    sink: Optional[Callable[[bytes], None]],
                    dedicated: bool = False) -> dict:
        """One RPC whose response may stream byte chunks into ``sink``.
        Returns the header merged with the trailer.

        ``dedicated=True`` runs the exchange on its own ephemeral
        connection instead of the pooled one — no shared lock, so N
        concurrent dedicated calls genuinely overlap on the wire (the
        gather data plane, DESIGN.md §8). A fresh connection has no stale
        state, so there is nothing to retry: carrier failures surface
        directly and the fetch path re-plans."""
        if dedicated:
            sock = _connect(self.address, self.timeout_s)
            try:
                return self._exchange(req, sink, sock=sock)
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
        with self._lock:
            self._responded = False
            try:
                return self._exchange(req, sink)
            except TransportError:
                # a stale pooled connection dies on first reuse after a
                # server restart/idle close; retry once on a fresh socket.
                # Never retry a request that already saw any of its own
                # response (``_responded``, not the per-connection
                # ``_fresh`` — which this exchange may have just cleared):
                # a desynced half-stream must not be resumed, and the sink
                # may already hold partial chunks.
                retry = not self._fresh and not self._responded
                self._drop_sock()
                if not retry:
                    raise
                self._responded = False
                try:
                    return self._exchange(req, sink)
                except TransportError:
                    self._drop_sock()
                    raise
            except RemoteError:
                raise  # protocol stayed in sync: keep the connection

    def close(self) -> None:
        with self._lock:
            self._drop_sock()


class LoopbackTransport:
    """In-process transport: dispatches straight into ``handler`` with a
    msgpack round-trip on the request (``core.wire``), so in-process callers exercise the
    handler with wire-identical types (every existing in-process suite
    runs unchanged against the same handlers the socket server uses)."""

    remote = False  # no wire: callers keep modeled link times

    def __init__(self, handler: Callable[[dict], Response],
                 address: str = "loopback:"):
        self.handler = handler
        self.address = address

    def call(self, req: dict, dedicated: bool = False) -> dict:
        return self.call_stream(req, None, dedicated=dedicated)

    def call_stream(self, req: dict,
                    sink: Optional[Callable[[bytes], None]],
                    dedicated: bool = False) -> dict:
        # ``dedicated`` is accepted for interface parity with
        # SocketTransport; in-process dispatch has no connection to pool
        req = wire.unpackb(wire.packb(req))
        try:
            resp = self.handler(req)
        except Exception as e:  # noqa: BLE001 — mirror the server's wiring
            raise RemoteError(f"{type(e).__name__}: {e}") from e
        chunks: Iterable[bytes] = ()
        if isinstance(resp, tuple):
            resp, chunks = resp
        if not resp.get("ok", False):
            raise RemoteError(resp.get("error", "remote handler failed"))
        for chunk in chunks:
            if sink is not None:
                sink(chunk)
        return resp

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class SocketServer:
    """Threaded frame-RPC server: one ``handler(req) -> Response`` for
    every op, one thread per connection (the ``MRMServer`` shape).

    ``address`` is a transport URI; ``"tcp:host:0"`` binds an ephemeral
    port and :attr:`address` reports the real one. ``idle_timeout_s``
    bounds how long a connection may sit silent before the server drops
    it — a hung or vanished client releases its thread instead of
    pinning it forever."""

    def __init__(self, handler: Callable[[dict], Response], address: str,
                 idle_timeout_s: Optional[float] = DEFAULT_IDLE_TIMEOUT_S,
                 name: str = "rpc"):
        self.handler = handler
        self.idle_timeout_s = idle_timeout_s
        self.name = name
        kind, where = parse_address(address)
        self._kind = kind
        if kind == "unix":
            if os.path.exists(where):
                os.unlink(where)
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.bind(where)
            self.address = address
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.sock.bind(where)
            host, port = self.sock.getsockname()[:2]
            self.address = f"tcp:{host}:{port}"
        self.sock.listen(64)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._accept_loop,
                                       daemon=True, name=f"{name}-accept")
        self.thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sock.settimeout(0.2)
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name=f"{self.name}-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            if self._kind == "tcp":
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(self.idle_timeout_s)
            while not self._stop.is_set():
                try:
                    req = recv_frame(conn)
                except TransportError:
                    return  # idle timeout / truncated frame: drop the conn
                if req is None:
                    return
                try:
                    resp = self.handler(req)
                except Exception as e:  # noqa: BLE001 — wire errors back
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                chunks = None
                if isinstance(resp, tuple):
                    resp, chunks = resp
                try:
                    send_frame(conn, resp)
                    if chunks is None:
                        continue
                    trailer = {"ok": True}
                    try:
                        for chunk in chunks:
                            send_chunk(conn, chunk)
                    except Exception as e:  # noqa: BLE001 — source died
                        # mid-stream: the only in-band escape is ending
                        # the byte stream and failing the trailer
                        trailer = {"ok": False,
                                   "error": f"{type(e).__name__}: {e}"}
                    send_chunk(conn, b"")
                    send_frame(conn, trailer)
                except TransportError:
                    return  # client went away mid-response
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        where = None
        if self._kind == "unix":
            where = parse_address(self.address)[1]
        try:
            self.sock.close()
        finally:
            if where and os.path.exists(where):
                try:
                    os.unlink(where)
                except OSError:
                    pass
        self.thread.join(timeout=2)
