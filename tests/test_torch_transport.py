"""The port's transport (``repro_torch.core.transport``) against the JAX
package's: the same frame bytes, and RPC across the two packages in both
directions (a JAX client on a port server, a port client on a JAX server),
unary and streaming, plus the framing and partial-I/O guarantees of the
reference suite on the port's own module."""
from __future__ import annotations

import os
import socket
import struct
import tempfile
import threading
import time

import pytest

from repro.core import transport as jt
from repro_torch.core import transport as pt

MODS = {"port": pt, "jax": jt}
# (client package, server package)
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]


def _handler(req):
    op = req["op"]
    if op == "echo":
        return {"ok": True, "back": req.get("x")}
    if op == "boom":
        raise ValueError("kaput")
    if op == "stream":
        def chunks():
            for i in range(req["n"]):
                yield bytes([i]) * req["size"]
        return {"ok": True, "stream": True, "n": req["n"]}, chunks()
    if op == "stream_dies":
        def chunks():
            yield b"first"
            raise IOError("source vanished")
        return {"ok": True, "stream": True}, chunks()
    if op == "slow":
        time.sleep(req["s"])
        return {"ok": True}
    raise ValueError(f"unknown {op}")


@pytest.fixture(params=PAIRS, ids=lambda p: f"{p[0]}-client-{p[1]}-server")
def rpc(request):
    client, server = (MODS[n] for n in request.param)
    tmp = tempfile.mkdtemp(prefix="tt-", dir="/tmp")
    srv = server.SocketServer(_handler, f"unix:{tmp}/rpc.sock")
    yield client, srv
    srv.stop()
    os.rmdir(tmp)


FRAMES = [{"op": "open", "framework": "repro-torch", "name": "A", "version": "1"},
          {"ok": True, "handle_id": 7, "nbytes": 2 ** 33, "segments": [{"shm": "trims_x", "size": 9}],
           "tensors": [{"name": "embed", "dtype": "bfloat16", "shape": [4, 8], "segment": 0,
                        "offset": 0}], "timings": {"tier_hit": "host", "total_s": 1.25e-3}},
          {"views": {0: "a", 7: "b"}, "blob": b"\x00\xff" * 300, "neg": -70000, "none": None}]


@pytest.mark.parametrize("frame", FRAMES, ids=["open", "reply", "mixed"])
def test_frames_are_byte_equal_and_cross_decode(frame):
    wire = {}
    for name, mod in MODS.items():
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, frame)
            a.shutdown(socket.SHUT_WR)
            data = b""
            while chunk := b.recv(1 << 16):
                data += chunk
        finally:
            a.close()
            b.close()
        wire[name] = data
    assert wire["port"] == wire["jax"]
    for sender, receiver in (("port", "jax"), ("jax", "port")):
        a, b = socket.socketpair()
        try:
            MODS[sender].send_frame(a, frame)
            assert MODS[receiver].recv_frame(b) == frame
        finally:
            a.close()
            b.close()


def test_unary_roundtrip(rpc):
    client, srv = rpc
    t = client.SocketTransport(srv.address, timeout_s=10)
    assert t.call({"op": "echo", "x": [1, "two", b"3", {5: None}]})["back"] == \
        [1, "two", b"3", {5: None}]
    with pytest.raises(client.RemoteError, match="ValueError: kaput"):
        t.call({"op": "boom"})
    assert t.call({"op": "echo", "x": 1})["back"] == 1      # connection survived
    t.close()


def test_streaming_body(rpc):
    client, srv = rpc
    t = client.SocketTransport(srv.address, timeout_s=10)
    got = []
    resp = t.call_stream({"op": "stream", "n": 5, "size": 70000}, got.append)
    assert resp["ok"] and resp["n"] == 5
    assert b"".join(got) == b"".join(bytes([i]) * 70000 for i in range(5))
    got = []
    resp = t.call_stream({"op": "stream", "n": 3, "size": 11}, got.append, dedicated=True)
    assert b"".join(got) == b"".join(bytes([i]) * 11 for i in range(3))
    got = []
    with pytest.raises(client.RemoteError, match="source vanished"):
        t.call_stream({"op": "stream_dies"}, got.append)
    assert got == [b"first"]
    t.close()


def test_concurrent_clients_and_timeout(rpc):
    client, srv = rpc
    errs = []

    def worker(i):
        try:
            t = client.SocketTransport(srv.address, timeout_s=10)
            for j in range(20):
                assert t.call({"op": "echo", "x": i * 100 + j})["back"] == i * 100 + j
            t.close()
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=30)
    assert not errs
    t = client.SocketTransport(srv.address, timeout_s=0.2)
    with pytest.raises(client.TransportError):
        t.call({"op": "slow", "s": 1.0})
    t.close()


def test_reconnect_after_idle_close():
    tmp = tempfile.mkdtemp(prefix="tt-", dir="/tmp")
    srv = pt.SocketServer(_handler, f"unix:{tmp}/rpc.sock", idle_timeout_s=0.2)
    try:
        t = pt.SocketTransport(srv.address, timeout_s=10)
        assert t.call({"op": "echo", "x": 1})["back"] == 1
        time.sleep(0.6)                        # the server dropped the idle connection
        assert t.call({"op": "echo", "x": 2})["back"] == 2
        t.close()
    finally:
        srv.stop()
        os.rmdir(tmp)


def test_tcp_ephemeral_port():
    srv = pt.SocketServer(_handler, "tcp:127.0.0.1:0")
    try:
        assert srv.address.startswith("tcp:127.0.0.1:") and not srv.address.endswith(":0")
        t = jt.SocketTransport(srv.address, timeout_s=10)
        assert t.call({"op": "echo", "x": "tcp"})["back"] == "tcp"
        t.close()
    finally:
        srv.stop()
    with pytest.raises(OSError):
        pt.SocketTransport("unix:/nonexistent/nope.sock").call({"op": "e"})


def test_framing_failures_are_transport_errors():
    a, b = socket.socketpair()
    a.close()
    assert pt.recv_frame(b) is None                         # clean EOF between frames
    b.close()
    for fn, match in ((pt.recv_frame, "between frame header"),
                      (pt.recv_chunk, "between chunk header")):
        a, b = socket.socketpair()
        a.sendall(struct.pack("<I", 10))
        a.close()
        with pytest.raises(pt.TransportError, match=match):
            fn(b)
        b.close()
    a, b = socket.socketpair()
    a.sendall(struct.pack("<I", 1 << 30))
    with pytest.raises(pt.TransportError, match="exceeds cap"):
        pt.recv_frame(b)
    a.close()
    b.close()
    a, b = socket.socketpair()
    pt.send_frame(a, {"op": "x", "pad": b"\x00" * 1024})
    a.close()
    b.recv(10)
    with pytest.raises(pt.TransportError):
        pt.recv_frame(b)
    b.close()


class _DribbleSock:
    """Sends and receives one byte at a time, with EINTR on every third call."""

    def __init__(self, rx: bytes = b""):
        self.sent, self.rx, self.pos, self.calls = bytearray(), rx, 0, 0

    def send(self, data) -> int:
        self.calls += 1
        if self.calls % 3 == 0:
            raise InterruptedError
        self.sent += bytes(data[:1])
        return 1

    def recv(self, n: int) -> bytes:
        self.calls += 1
        if self.calls % 3 == 0:
            raise InterruptedError
        if self.pos >= len(self.rx):
            return b""
        self.pos += 1
        return self.rx[self.pos - 1:self.pos]


def test_partial_io():
    payload = os.urandom(257)
    s = _DribbleSock()
    pt.sendall(s, payload)
    assert bytes(s.sent) == payload
    assert pt.recvn(_DribbleSock(rx=payload), len(payload)) == payload
    assert pt.recvn(_DribbleSock(rx=b""), 8) is None
    with pytest.raises(pt.TransportError, match="mid-frame"):
        pt.recvn(_DribbleSock(rx=b"abc"), 8)


def test_loopback_matches_the_socket_surface():
    seen = {}

    def handler(req):
        seen.update(req)
        return _handler(req)

    for mod in (pt, jt):
        t = mod.LoopbackTransport(handler)
        assert t.remote is False
        assert t.call({"op": "echo", "x": 5, "key": ("jax", "m", "1")})["back"] == 5
        assert seen["key"] == ["jax", "m", "1"]          # tuples arrive as lists
        with pytest.raises(mod.RemoteError, match="ValueError: kaput"):
            t.call({"op": "boom"})
        got = []
        assert t.call_stream({"op": "stream", "n": 3, "size": 10}, got.append)["ok"]
        assert len(b"".join(got)) == 30
