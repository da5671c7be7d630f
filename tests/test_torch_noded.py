"""The port's node daemon (``repro_torch.core.noded``): the reference's
PeerStub parity, directory-over-RPC and daemon lifecycle tests on port
daemons (``"device": "cpu"``), and interop with the JAX package's daemon
over real unix sockets: a port daemon pulls a model from a JAX daemon
through the JAX daemon's directory, and the reverse, with equal SHA-256.

Daemon processes run the port's ``main`` through a launcher that gives
them a segment prefix of their own (``shm_ipc.SEGMENT_PREFIX``), so no
other test's ``trims_*`` clean-up can unlink a segment a running daemon
still owns; sockets live under a short ``/tmp`` directory (AF_UNIX paths
are limited to 107 bytes)."""
from __future__ import annotations

import glob
import hashlib
import os
import shutil
import signal
import socket as socketlib
import subprocess
import tempfile
import threading
import time

import numpy as np
import pytest

from repro.core.noded import NodeDaemon as JaxNodeDaemon
from repro_torch.core import noded
from repro_torch.core.cache import Tier
from repro_torch.core.directory import make_directory
from repro_torch.core.mrm import ModelKey
from repro_torch.core.noded import (DirectoryClient, NodeDaemon, PeerStub, spawn_node,
                                    sync_directory)
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.store import DiskStore, write_model
from repro_torch.core.transport import LoopbackTransport, SocketTransport

PREFIX = f"trimsnoded{os.getpid()}_"
KEY = ModelKey("jax", "m0", "1")
# runs the daemon's CLI with this test's segment prefix set first
LAUNCHER = ("import sys; from repro_torch.core import noded, shm_ipc; "
            "shm_ipc.SEGMENT_PREFIX = sys.argv[1]; sys.exit(noded.main(sys.argv[2:]))")


def make_model(root: str, key=KEY, kib: int = 256, seed: int = 0) -> str:
    rng = np.random.RandomState(seed)
    n = max(1, (kib << 10) // (4 * 256))
    path = DiskStore(root).path_for(key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_model(path, {f"w{i}": rng.rand(n, 64).astype(np.float32) for i in range(4)},
                {"framework": key[0], "name": key[1], "version": key[2]})
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture
def sockdir():
    d = tempfile.mkdtemp(prefix="tnd-", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _spec(name, tmp, sockdir, **kw):
    root = os.path.join(str(tmp), name)
    os.makedirs(root, exist_ok=True)
    return {"name": name, "disk_root": root, "listen": f"unix:{sockdir}/{name}.sock",
            "device": "cpu", "device_capacity": 64 << 20, **kw}


@pytest.fixture
def two_daemons(tmp_path, sockdir):
    """Daemon a (serves the sharded directory, holds m0 on disk) and daemon
    b (cold), both in this process, linked by real unix sockets."""
    osroot = str(tmp_path / "objstore")
    digest = make_model(str(tmp_path / "a"))
    ObjectStore(osroot).put_file(KEY, DiskStore(str(tmp_path / "a")).path_for(KEY))
    a = NodeDaemon(_spec("a", tmp_path, sockdir, objectstore={"root": osroot},
                         directory={"serve": True, "policy": "sharded", "n_shards": 4}))
    b = NodeDaemon(_spec("b", tmp_path, sockdir, objectstore={"root": osroot},
                         directory={"connect": a.address}))
    yield a, b, digest
    b.shutdown()
    a.shutdown()


# ---------------------------------------------------------- PeerStub

def test_peer_stub_surface_matches_direct(tmp_path, sockdir):
    make_model(str(tmp_path / "d"))
    d = NodeDaemon(_spec("d", tmp_path, sockdir))
    try:
        stub, node = PeerStub(LoopbackTransport(d.handle), "d"), d.node
        nope = ModelKey("jax", "nope", "1")
        assert stub.has_model(KEY) == node.has_model(KEY) is True
        assert stub.model_nbytes(KEY) == node.model_nbytes(KEY)
        assert stub.has_model(nope) is False and stub.model_nbytes(nope) is None
        got = []
        n = stub.read_model(KEY, got.append)
        with open(d.mrm.disk.path_for(KEY), "rb") as f:
            raw = f.read()
        assert b"".join(got) == raw and n == len(raw)
        assert stub.read_model_ranges(KEY, [(0, 64), (100, 32)]) == raw[:64] + raw[100:132]
        assert stub.local_model_path(KEY) is None and node.local_model_path(KEY)
        assert stub.remote and not node.remote
        assert d.mrm.device_name.type == "cpu"
    finally:
        d.shutdown()


def test_dead_peer_probes_degrade_and_reads_raise(tmp_path):
    stub = PeerStub(SocketTransport(f"unix:{tmp_path}/gone.sock", timeout_s=0.5), "ghost")
    assert stub.has_model(KEY) is False and stub.model_nbytes(KEY) is None
    assert stub.has_shard(KEY, 0) is False
    with pytest.raises(OSError):
        stub.read_model(KEY, lambda b: None)

    class Lying:
        address = "fake:"

        def __init__(self, claim):
            self.claim = claim

        def call_stream(self, req, sink):
            sink(b"abcd")
            return {"ok": True, "nbytes": self.claim}

    got = []
    assert PeerStub(Lying(4), "ok").read_model(KEY, got.append) == 4 and got == [b"abcd"]
    with pytest.raises(OSError, match="delivered 4 of 999"):
        PeerStub(Lying(999), "liar").read_model(KEY, lambda b: None)


# ---------------------------------------------------- directory over RPC

def test_directory_client_roundtrip(two_daemons):
    a, b, _ = two_daemons
    d = a.dir_service.directory
    assert {n.name for n in d.nodes()} == {"a", "b"}
    assert ("a", Tier.DISK) in d.holders(KEY)
    peer = b.directory.node("a")
    assert isinstance(peer, PeerStub) and peer.has_model(KEY)
    ghost = ModelKey("jax", "ghost", "9")
    b.directory.publish("b", ghost, Tier.HOST)
    assert b.directory.tier_on(ghost, "b") == Tier.HOST
    b.directory.withdraw("b", ghost, Tier.HOST)
    assert b.directory.tier_on(ghost, "b") is None


def test_cold_open_pulls_over_socket(two_daemons):
    a, b, digest = two_daemons
    rec = a.dir_service.directory.node("b")
    assert isinstance(rec, PeerStub) and rec.address == b.address
    assert rec.has_model(KEY) is False
    t = SocketTransport(b.address)
    r = t.call({"op": "open", "key": list(KEY), "tier": "device", "timeout": 60})
    t.close()
    assert r["timings"]["tier_hit"] == "peer" and r["disk_digest"] == digest
    assert r["timings"]["wire_s"] > 0
    assert a.node.metrics["peer_serves"] == 1 and b.node.metrics["peer_fetches"] == 1
    assert b.mrm.metrics["peer_fetches"] == 1
    assert rec.has_model(KEY) is True   # a can now plan a <- b


def test_hung_peer_times_out_and_falls_back(tmp_path, sockdir):
    osroot = str(tmp_path / "objstore")
    make_model(str(tmp_path / "seed"))
    ObjectStore(osroot).put_file(KEY, DiskStore(str(tmp_path / "seed")).path_for(KEY))
    hung_path = f"{sockdir}/hung.sock"
    hung = socketlib.socket(socketlib.AF_UNIX)
    hung.bind(hung_path)
    hung.listen(4)
    conns = []
    threading.Thread(target=lambda: [conns.append(hung.accept()) for _ in range(9)],
                     daemon=True).start()
    c = NodeDaemon(_spec("c", tmp_path, sockdir, objectstore={"root": osroot},
                         call_timeout_s=0.5, directory={"serve": True}))
    try:
        c.directory.register(PeerStub(SocketTransport(f"unix:{hung_path}", timeout_s=0.5),
                                      "hung"))
        c.directory.publish("hung", KEY, Tier.DISK)
        t0 = time.perf_counter()
        h = c.mrm.open_async(KEY, tier="host").result(timeout=30)
        assert h.timings.tier_hit == "cloud" and time.perf_counter() - t0 < 10
        c.mrm.close(h)
    finally:
        c.shutdown()
        hung.close()


def test_addressless_member_and_anti_entropy(two_daemons, tmp_path, sockdir):
    a, b, _ = two_daemons
    a.dir_service.handle({"op": "dir.register", "name": "ghost"})
    ghost = DirectoryClient(LoopbackTransport(a.dir_service.handle)).node("ghost")
    assert ghost.remote and ghost.has_model(KEY) is False and ghost.model_nbytes(KEY) is None
    assert ghost.has_shard(KEY, 0) is False and ghost.local_model_path(KEY) is None
    d3 = make_directory("sharded", n_shards=4)
    t = SocketTransport(a.address)
    assert sync_directory(d3, t) > 0 and "a" in dict(d3.holders(KEY))
    stale = d3.export_snapshot()
    a.dir_service.directory.drop_node("b")
    sync_directory(d3, t)
    assert "b" not in {n.name for n in d3.nodes()}
    d3.merge_snapshot(stale)          # an old snapshot must not revive b
    assert "b" not in {n.name for n in d3.nodes()}
    t.close()


# ----------------------------------------------- interop with JAX daemons

def _jax_spec(spec):
    return {k: v for k, v in spec.items() if k != "device"}


@pytest.mark.parametrize("server", ["jax", "port"])
def test_interop_pull_across_packages(tmp_path, sockdir, server):
    """One package's daemon serves the directory and holds m0; the other
    package's daemon connects to it and pulls m0 by peer fetch. The copy's
    SHA-256 equals the source's, and both directories list the puller."""
    digest = make_model(str(tmp_path / "a"))
    Holder, Puller = (JaxNodeDaemon, NodeDaemon) if server == "jax" else \
        (NodeDaemon, JaxNodeDaemon)
    spec_a = _spec("a", tmp_path, sockdir,
                   directory={"serve": True, "policy": "sharded", "n_shards": 4})
    a = Holder(_jax_spec(spec_a) if Holder is JaxNodeDaemon else spec_a)
    spec_b = _spec("b", tmp_path, sockdir, directory={"connect": a.address})
    b = Puller(_jax_spec(spec_b) if Puller is JaxNodeDaemon else spec_b)
    try:
        t = SocketTransport(b.address)
        r = t.call({"op": "open", "key": list(KEY), "tier": "host", "timeout": 60})
        stats = t.call({"op": "node_stats"})
        t.close()
        assert r["timings"]["tier_hit"] == "peer" and r["disk_digest"] == digest
        assert stats["node"]["peer_fetches"] == 1 and a.node.metrics["peer_serves"] == 1
        with open(b.mrm.disk.path_for(KEY), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == digest
        holders = {n for n, _ in a.dir_service.directory.holders(KEY)}
        assert holders == {"a", "b"}
    finally:
        b.shutdown()
        a.shutdown()
    assert "b" not in {n.name for n in a.dir_service.directory.nodes()}


# ------------------------------------------------------ daemon processes

@pytest.fixture
def own_segments(monkeypatch):
    """Daemons spawned through ``spawn_node`` run the launcher, so their
    segments carry this test's prefix."""
    real = subprocess.Popen

    def popen(args, **kw):
        if list(args[1:3]) == ["-m", "repro_torch.core.noded"]:
            args = [args[0], "-c", LAUNCHER, PREFIX, *args[3:]]
        return real(args, **kw)

    monkeypatch.setattr(noded.subprocess, "Popen", popen)
    yield
    for path in glob.glob(f"/dev/shm/{PREFIX}*"):
        os.unlink(path)


def _spawn(tmp_path, sockdir, register_daemon, name, **extra):
    err = open(tmp_path / f"{name}.err", "w")
    p, info = spawn_node(_spec(name, tmp_path, sockdir, **extra), stderr=err,
                         ready_timeout_s=60.0)
    register_daemon(p)
    return p, info


@pytest.mark.proc
def test_sigterm_clean_shutdown(tmp_path, sockdir, register_daemon, own_segments):
    make_model(str(tmp_path / "a"))
    pa, ia = _spawn(tmp_path, sockdir, register_daemon, "a", use_shm=True,
                    directory={"serve": True, "policy": "sharded", "n_shards": 4})
    pb, ib = _spawn(tmp_path, sockdir, register_daemon, "b", use_shm=True,
                    directory={"connect": ia["address"]})
    ta, tb = SocketTransport(ia["address"]), SocketTransport(ib["address"])
    r = tb.call({"op": "open", "key": list(KEY), "tier": "host", "timeout": 60})
    assert r["timings"]["tier_hit"] == "peer"
    assert glob.glob(f"/dev/shm/{PREFIX}*"), "b's host copy lives in a segment"
    assert any(n == "b" for n, _ in ta.call({"op": "dir.holders", "key": list(KEY)})["holders"])
    pb.send_signal(signal.SIGTERM)
    assert pb.wait(timeout=15) == 0
    holders = ta.call({"op": "dir.holders", "key": list(KEY)})["holders"]
    assert not any(n == "b" for n, _ in holders), holders
    pa.send_signal(signal.SIGTERM)
    assert pa.wait(timeout=15) == 0
    assert glob.glob(f"/dev/shm/{PREFIX}*") == []
    ta.close()
    tb.close()


@pytest.mark.proc
def test_spawn_ready_timeout_enforced(tmp_path, sockdir):
    hung_path = f"{sockdir}/hungdir.sock"
    hung = socketlib.socket(socketlib.AF_UNIX)
    hung.bind(hung_path)
    hung.listen(4)
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="never became ready"):
            spawn_node(_spec("z", tmp_path, sockdir, call_timeout_s=120,
                             directory={"connect": f"unix:{hung_path}"}),
                       ready_timeout_s=3.0)
        assert time.monotonic() - t0 < 40
    finally:
        hung.close()


@pytest.mark.proc
def test_restart_gets_new_incarnation(tmp_path, sockdir, register_daemon, own_segments):
    pa, ia = _spawn(tmp_path, sockdir, register_daemon, "a",
                    directory={"serve": True, "policy": "sharded", "n_shards": 4})
    make_model(str(tmp_path / "b"), seed=1)
    pb1, _ = _spawn(tmp_path, sockdir, register_daemon, "b", directory={"connect": ia["address"]})
    ta = SocketTransport(ia["address"])
    gen0 = ta.call({"op": "dir.generation"})["generation"]
    assert any(n == "b" for n, _ in ta.call({"op": "dir.holders", "key": list(KEY)})["holders"])
    pb1.kill()
    pb1.wait(timeout=10)
    for f in glob.glob(str(tmp_path / "b" / "**" / "*.trims"), recursive=True):
        os.unlink(f)
    _spawn(tmp_path, sockdir, register_daemon, "b", directory={"connect": ia["address"]})
    assert ta.call({"op": "dir.generation"})["generation"] > gen0
    holders = ta.call({"op": "dir.holders", "key": list(KEY)})["holders"]
    assert not any(n == "b" for n, _ in holders), holders
    ta.close()


@pytest.mark.proc
def test_port_daemon_process_pulls_from_jax_daemon(tmp_path, sockdir, register_daemon,
                                                   own_segments):
    """A port daemon in its own process, with a client socket (shm mode),
    joins a JAX daemon's directory and pulls m0 from it over the data-plane
    socket; a client of the port daemon then opens it as a host hit."""
    from repro_torch.core.shm_ipc import RemoteTrimsClient
    digest = make_model(str(tmp_path / "a"))
    a = JaxNodeDaemon(_jax_spec(_spec("a", tmp_path, sockdir,
                                      directory={"serve": True, "policy": "sharded"})))
    try:
        pb, ib = _spawn(tmp_path, sockdir, register_daemon, "b",
                        client_sock=f"{sockdir}/b-client.sock",
                        directory={"connect": a.address})
        tb = SocketTransport(ib["address"])
        r = tb.call({"op": "open", "key": list(KEY), "tier": "host", "timeout": 60})
        tb.close()
        assert r["timings"]["tier_hit"] == "peer" and r["disk_digest"] == digest
        client = RemoteTrimsClient(ib["client_sock"])
        h = client.open(*KEY)
        assert h.timings["tier_hit"] == "host"
        want = a.mrm.disk.open(KEY).read_all()
        assert sorted(h.arrays) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(h.arrays[n], want[n])
        h.arrays.clear()          # drop the views before the segment closes
        client.close(h)
        client.disconnect()
        pb.send_signal(signal.SIGTERM)
        assert pb.wait(timeout=15) == 0
        assert "b" not in {n.name for n in a.dir_service.directory.nodes()}
        assert glob.glob(f"/dev/shm/{PREFIX}*") == []
    finally:
        a.shutdown()
