"""Node daemon: one process per cluster machine (DESIGN.md §11).

The paper's TrIMS deployment is a fleet of per-server MRM daemons; this
module is that daemon. Each :class:`NodeDaemon` hosts an MRM (optionally
exposed to co-located client processes via ``shm_ipc.MRMServer``), a
:class:`~repro_torch.core.cluster.ClusterNode`, and ONE peer-facing data-plane
endpoint (the Triton thin-proxy shape: a single enforcement point per
node that routes control frames and streams tensor bytes). Peers consume
it through :class:`PeerStub` — the same surface ``ClusterNode`` peers
expose in-process — so ``_pull_from_peer``, ``plan_shard_sources``,
gather re-plans, and streaming ``on_shard`` feeds run unmodified against
real sockets. Directory traffic rides the same endpoint as ``dir.*``
RPCs (:class:`DirectoryService` / :class:`DirectoryClient`), including
snapshot-exchange anti-entropy between genuinely separate processes.

Run one with::

    python -m repro_torch.core.noded --spec '{"name": "b", "disk_root": ...,
        "listen": "tcp:127.0.0.1:0", "directory": {"connect": "tcp:..."}}'

It prints ``TRIMS_NODED_READY {...}`` once serving (``spawn_node`` waits
for it) and shuts down cleanly on SIGTERM: the node withdraws from the
directory, every shm segment is unlinked, and the sockets close.

PyTorch port: the daemon's MRM puts its device tier on the spec's
``device`` (CUDA by default; it raises without a card unless the spec
says ``"device": "cpu"``), and its device capacity defaults to 12 GiB
rather than all free device memory, so several daemons and their clients
can share one card. The wire protocol is the JAX package's, so a port
daemon and a JAX daemon serve each other.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cache import Tier
from repro_torch.core.cluster import ClusterDirectory, ClusterNode
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.store import DiskStore
from repro_torch.core.tenant import RequestContext
from repro_torch.core.transport import (DEFAULT_CALL_TIMEOUT_S,
                                        LoopbackTransport, SocketServer,
                                        SocketTransport, TransportError)

READY_MARKER = "TRIMS_NODED_READY"


def _key(wire) -> ModelKey:
    return ModelKey(*wire)


def _wire_key(key: ModelKey) -> list:
    return list(key)


# ---------------------------------------------------------------------------
# peer stub — the remote half of the peer data-plane surface
# ---------------------------------------------------------------------------

class PeerStub:
    """A remote peer, speaking the exact surface in-process
    ``ClusterNode`` peers expose (``has_model`` / ``model_nbytes`` /
    ``read_model`` / ``read_model_ranges`` / ``has_shard`` /
    ``read_shard`` / ``store_shard`` / ``stats``) over a transport.

    Probe methods (``has_*``, ``model_nbytes``) swallow transport errors
    into "not held": a dead daemon is indistinguishable from a stale
    directory hint, and the planner already handles stale hints. Data
    reads let the ``OSError`` out — the fetch paths re-plan or fall back
    to CLOUD on it."""

    remote = True  # reads cross a real socket: wire time is measured

    def __init__(self, transport, name: str):
        self.name = name
        self.transport = transport

    @property
    def address(self) -> str:
        return self.transport.address

    def detach(self) -> None:
        self.transport.close()

    # -- probes (errors degrade to "not held") ------------------------------
    def has_model(self, key: ModelKey) -> bool:
        try:
            return bool(self.transport.call(
                {"op": "has_model", "key": _wire_key(key)})["has"])
        except OSError:
            return False

    def model_nbytes(self, key: ModelKey) -> Optional[int]:
        try:
            return self.transport.call(
                {"op": "model_nbytes", "key": _wire_key(key)})["nbytes"]
        except OSError:
            return None

    def has_shard(self, key: ModelKey, index: int) -> bool:
        try:
            return bool(self.transport.call(
                {"op": "has_shard", "key": _wire_key(key),
                 "index": index})["has"])
        except OSError:
            return False

    def local_model_path(self, key: ModelKey) -> Optional[str]:
        return None  # remote: no local file — peer wire streams raw

    # -- data plane (errors propagate: the caller re-plans) -----------------
    def read_model(self, key: ModelKey, write, ctx=None) -> int:
        # count the bytes the sink actually received — never trust the
        # server-reported nbytes for validation (a desynced/duplicated
        # stream would pass it while the sink holds garbage), and the
        # in-process surface returns bytes written too
        got = 0

        def counted(chunk: bytes) -> None:
            nonlocal got
            got += len(chunk)
            write(chunk)

        resp = self.transport.call_stream(
            self._with_ctx({"op": "fetch_model", "key": _wire_key(key)}, ctx),
            counted)
        nbytes = resp.get("nbytes")
        if nbytes is not None and got != nbytes:
            raise TransportError(f"{self.name}: fetch_model delivered "
                                 f"{got} of {nbytes} bytes")
        return got

    # shard reads (the gather data plane, DESIGN.md §8) run on dedicated
    # ephemeral connections: concurrent shard sources must overlap on the
    # wire instead of serializing on the stub's pooled connection. A
    # dedicated exchange has no retry (nothing stale to retry) — the
    # gather's own re-plan/CLOUD fallback handles the failure.
    def read_model_ranges(self, key: ModelKey, ranges, ctx=None) -> bytes:
        return self.transport.call(
            self._with_ctx({"op": "read_ranges", "key": _wire_key(key),
                            "ranges": [list(r) for r in ranges]}, ctx),
            dedicated=True)["data"]

    def read_shard(self, key: ModelKey, index: int, ctx=None) -> bytes:
        return self.transport.call(
            self._with_ctx({"op": "fetch_shard", "key": _wire_key(key),
                            "index": index}, ctx),
            dedicated=True)["data"]

    @staticmethod
    def _with_ctx(req: dict, ctx) -> dict:
        """Attach optional RequestContext metadata (DESIGN.md §12) so the
        serving daemon sees the same tenant/deadline the local open does."""
        if ctx is not None:
            req["ctx"] = ctx.to_wire()
        return req

    def store_shard(self, key: ModelKey, index: int, data: bytes) -> None:
        self.transport.call({"op": "store_shard", "key": _wire_key(key),
                             "index": index, "data": data})

    def stats(self) -> dict:
        return self.transport.call({"op": "node_stats"})["node"]


# ---------------------------------------------------------------------------
# directory over RPC
# ---------------------------------------------------------------------------

class _NodeRecord:
    """Stand-in for a registered member with no reachable data plane (it
    advertised no address). It still carries the peer probe surface so
    planners treat it exactly like a stale hint — every probe misses —
    instead of crashing on a missing attribute; ``detach`` is a no-op
    (the remote node's own lifecycle handles it)."""

    __slots__ = ("name", "address")

    remote = True  # never actually read: probes always miss

    def __init__(self, name: str, address: Optional[str]):
        self.name = name
        self.address = address

    # planner probes: an address-less member is unreachable, so it never
    # verifies as a source (the CLOUD fall-through covers the fetch)
    def has_model(self, key: ModelKey) -> bool:
        return False

    def model_nbytes(self, key: ModelKey) -> Optional[int]:
        return None

    def has_shard(self, key: ModelKey, index: int) -> bool:
        return False

    def local_model_path(self, key: ModelKey) -> Optional[str]:
        return None

    def detach(self) -> None:
        pass


class DirectoryService:
    """Handler exposing any DirectoryProtocol impl as ``dir.*`` RPCs.

    Placement and query ops map one-to-one. ``dir.register`` supersedes
    an existing registration of the same name (a crash-restarted daemon
    re-registers before anyone dropped it: the old record is dropped
    first, which bumps the generation/incarnation exactly like the
    in-process restart flow). ``dir.sync`` is snapshot-exchange
    anti-entropy: it merges the caller's snapshot and returns this
    replica's *pre-merge* snapshot — together the two merges equal one
    ``sync_with`` round."""

    def __init__(self, directory):
        self.directory = directory

    def handle(self, req: dict):
        op = req["op"][len("dir."):]
        d = self.directory
        if op == "generation":
            return {"ok": True, "generation": d.generation}
        if op == "register":
            # a registration that advertises an address resolves to a
            # live PeerStub, so planners co-located with this directory
            # replica probe (and fetch from) the remote member exactly
            # like a DirectoryClient does; address-less members get the
            # always-miss record
            rec = (_stub_resolver(req["name"], req.get("address"))
                   or _NodeRecord(req["name"], None))
            try:
                d.register(rec)
            except KeyError:
                d.drop_node(rec.name)  # supersede: crash-restarted daemon
                d.register(rec)
            return {"ok": True}
        if op == "node":
            node = d.node(req["name"])
            if node is None:
                return {"ok": True, "found": False, "address": None}
            return {"ok": True, "found": True,
                    "address": getattr(node, "address", None)}
        if op == "nodes":
            return {"ok": True,
                    "nodes": [[n.name, getattr(n, "address", None)]
                              for n in d.nodes()]}
        if op == "drop_node":
            d.drop_node(req["name"])
            return {"ok": True}
        if op == "publish":
            d.publish(req["node"], _key(req["key"]), Tier(req["tier"]))
            return {"ok": True}
        if op == "withdraw":
            d.withdraw(req["node"], _key(req["key"]), Tier(req["tier"]))
            return {"ok": True}
        if op == "publish_shard":
            d.publish_shard(req["node"], _key(req["key"]), req["index"],
                            Tier(req["tier"]))
            return {"ok": True}
        if op == "withdraw_shard":
            tier = req.get("tier")
            d.withdraw_shard(req["node"], _key(req["key"]), req["index"],
                             Tier(tier) if tier is not None else None)
            return {"ok": True}
        if op == "holders":
            return {"ok": True,
                    "holders": [[n, t.value] for n, t in
                                d.holders(_key(req["key"]),
                                          exclude=req.get("exclude"))]}
        if op == "tier_on":
            t = d.tier_on(_key(req["key"]), req["node"])
            return {"ok": True, "tier": t.value if t is not None else None}
        if op == "shard_holders":
            return {"ok": True,
                    "holders": [[n, t.value] for n, t in
                                d.shard_holders(_key(req["key"]),
                                                req["index"],
                                                exclude=req.get("exclude"))]}
        if op == "shards_on":
            return {"ok": True,
                    "indices": d.shards_on(_key(req["key"]), req["node"])}
        if op == "stats":
            return {"ok": True, "stats": d.stats()}
        if op == "sync":
            if not hasattr(d, "merge_snapshot"):
                raise ValueError("directory does not support snapshot sync "
                                 "(needs policy='sharded')")
            mine = d.export_snapshot()
            merged = d.merge_snapshot(req["snap"], resolver=_stub_resolver)
            return {"ok": True, "snap": mine, "merged": merged}
        raise ValueError(f"unknown directory op dir.{op!r}")


def _stub_resolver(name: str, address: Optional[str]):
    """Default resolver for members learned through anti-entropy: a
    PeerStub at the member's advertised address."""
    if not address:
        return None
    return PeerStub(SocketTransport(address), name)


class DirectoryClient:
    """DirectoryProtocol carried over a transport: every publish /
    withdraw / holders / drop becomes an RPC to the replica a
    :class:`DirectoryService` serves, so hint maintenance and source
    planning work between genuinely separate processes.

    ``node(name)`` resolves locally registered nodes to their in-process
    object and every other member to a cached :class:`PeerStub` at the
    address the directory recorded for it."""

    def __init__(self, transport,
                 stub_timeout_s: Optional[float] = DEFAULT_CALL_TIMEOUT_S):
        self.transport = transport
        self.stub_timeout_s = stub_timeout_s
        self._local: Dict[str, object] = {}
        self._stubs: Dict[Tuple[str, str], PeerStub] = {}
        self._lock = threading.Lock()

    def _call(self, op: str, **kw) -> dict:
        kw["op"] = op
        return self.transport.call(kw)

    @property
    def generation(self) -> int:
        return self._call("dir.generation")["generation"]

    def register(self, node) -> None:
        self._call("dir.register", name=node.name,
                   address=getattr(node, "address", None))
        with self._lock:
            self._local[node.name] = node

    def node(self, name: str):
        with self._lock:
            local = self._local.get(name)
        if local is not None:
            return local
        resp = self._call("dir.node", name=name)
        if not resp["found"]:
            return None
        address = resp["address"]
        if not address:
            return _NodeRecord(name, None)  # unreachable: probes see misses
        with self._lock:
            stub = self._stubs.get((name, address))
            if stub is None:
                stub = PeerStub(
                    SocketTransport(address, timeout_s=self.stub_timeout_s),
                    name)
                self._stubs[(name, address)] = stub
        return stub

    def nodes(self) -> list:
        return [self.node(name)
                for name, _ in self._call("dir.nodes")["nodes"]]

    def drop_node(self, name: str) -> None:
        self._call("dir.drop_node", name=name)
        with self._lock:
            local = self._local.pop(name, None)
            stubs = [s for (n, _), s in self._stubs.items() if n == name]
            for k in [k for k in self._stubs if k[0] == name]:
                del self._stubs[k]
        if local is not None:
            local.detach()
        for s in stubs:
            s.detach()

    def publish(self, node_name: str, key: ModelKey, tier: Tier) -> None:
        self._call("dir.publish", node=node_name, key=_wire_key(key),
                   tier=tier.value)

    def withdraw(self, node_name: str, key: ModelKey, tier: Tier) -> None:
        self._call("dir.withdraw", node=node_name, key=_wire_key(key),
                   tier=tier.value)

    def publish_shard(self, node_name: str, key: ModelKey, index: int,
                      tier: Tier) -> None:
        self._call("dir.publish_shard", node=node_name, key=_wire_key(key),
                   index=index, tier=tier.value)

    def withdraw_shard(self, node_name: str, key: ModelKey, index: int,
                       tier: Optional[Tier] = None) -> None:
        self._call("dir.withdraw_shard", node=node_name,
                   key=_wire_key(key), index=index,
                   tier=tier.value if tier is not None else None)

    def holders(self, key: ModelKey,
                exclude: Optional[str] = None) -> List[Tuple[str, Tier]]:
        return [(n, Tier(t)) for n, t in
                self._call("dir.holders", key=_wire_key(key),
                           exclude=exclude)["holders"]]

    def warmest(self, key: ModelKey,
                exclude: Optional[str] = None) -> Optional[Tuple[str, Tier]]:
        held = self.holders(key, exclude=exclude)
        return held[0] if held else None

    def tier_on(self, key: ModelKey, node_name: str) -> Optional[Tier]:
        t = self._call("dir.tier_on", key=_wire_key(key),
                       node=node_name)["tier"]
        return Tier(t) if t is not None else None

    def shard_holders(self, key: ModelKey, index: int,
                      exclude: Optional[str] = None
                      ) -> List[Tuple[str, Tier]]:
        return [(n, Tier(t)) for n, t in
                self._call("dir.shard_holders", key=_wire_key(key),
                           index=index, exclude=exclude)["holders"]]

    def shards_on(self, key: ModelKey, node_name: str) -> List[int]:
        return list(self._call("dir.shards_on", key=_wire_key(key),
                               node=node_name)["indices"])

    def stats(self) -> dict:
        return self._call("dir.stats")["stats"]

    def close(self) -> None:
        with self._lock:
            stubs = list(self._stubs.values())
            self._stubs.clear()
        for s in stubs:
            s.detach()
        self.transport.close()


def sync_directory(local_dir, transport, resolver=_stub_resolver) -> int:
    """One transport-carried anti-entropy round: push ``local_dir``'s
    snapshot to the replica behind ``transport`` (a ``dir.sync`` RPC)
    and merge its pre-merge snapshot back — equivalent to one in-process
    ``sync_with`` exchange. Returns records exchanged on both sides."""
    resp = transport.call({"op": "dir.sync",
                           "snap": local_dir.export_snapshot()})
    return resp["merged"] + local_dir.merge_snapshot(resp["snap"],
                                                     resolver=resolver)


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

class NodeDaemon:
    """MRM + ClusterNode + data-plane endpoint in one process.

    ``spec`` (all paths absolute; everything but ``name``/``disk_root``/
    ``listen`` optional)::

      name            node name in the directory
      disk_root       DiskStore root
      listen          data-plane address ("unix:/path" | "tcp:host:0")
      objectstore     {"root", "bw", "rtt", "shard_bytes", "codec"}
      directory       {"serve": true, "policy": "single"|"sharded", ...}
                    | {"connect": "<address>"}  | absent (private)
      client_sock     unix path: serve co-located clients via MRMServer
                      (forces use_shm)
      device          torch device of the MRM's device tier ("cuda")
      device_capacity / host_capacity / policy / peer_fetch / gather /
      peer_codec / use_shm            -> MRM / ClusterNode knobs
      call_timeout_s / idle_timeout_s -> transport knobs
      serve_delay_s   fault injection: sleep per data-plane serve
    """

    def __init__(self, spec: dict):
        self.spec = spec
        self.name = spec["name"]
        self.serve_delay_s = float(spec.get("serve_delay_s", 0.0))
        self.chunk_bytes = int(spec.get("chunk_bytes", 1 << 20))
        self._stop = threading.Event()
        self._opens: Dict[str, object] = {}
        self._open_counter = 0
        self._lock = threading.Lock()

        objectstore = None
        os_spec = spec.get("objectstore")
        if os_spec:
            from repro_torch.core.objectstore import ObjectStore
            objectstore = ObjectStore(
                os_spec["root"], bw=os_spec.get("bw", 1e9),
                rtt=os_spec.get("rtt", 20e-3),
                simulate_time=bool(os_spec.get("simulate_time", False)),
                codec=os_spec.get("codec", "none"),
                shard_bytes=os_spec.get("shard_bytes"))
        use_shm = bool(spec.get("use_shm", False)) or bool(
            spec.get("client_sock"))
        self.mrm = MRM(
            DiskStore(spec["disk_root"]),
            device_capacity=int(spec.get("device_capacity", 12 << 30)),
            host_capacity=int(spec.get("host_capacity", 64 << 30)),
            policy=spec.get("policy", "lru"),
            use_shm=use_shm,
            objectstore=objectstore,
            device=spec.get("device", "cuda"))

        # data-plane endpoint first: TCP port 0 resolves here, and the
        # advertised address goes into the directory registration
        self.server = SocketServer(
            self.handle, spec["listen"],
            idle_timeout_s=spec.get("idle_timeout_s", 300.0),
            name=f"noded-{self.name}")
        self.address = self.server.address

        self.dir_service: Optional[DirectoryService] = None
        self._dir_client: Optional[DirectoryClient] = None
        dir_spec = spec.get("directory") or {}
        if dir_spec.get("serve"):
            from repro_torch.core.directory import make_directory
            kw = {k: dir_spec[k] for k in ("n_shards", "vnodes")
                  if k in dir_spec}
            directory = make_directory(dir_spec.get("policy", "single"),
                                       **kw)
            self.dir_service = DirectoryService(directory)
        elif dir_spec.get("connect"):
            self._dir_client = DirectoryClient(SocketTransport(
                dir_spec["connect"],
                timeout_s=spec.get("call_timeout_s",
                                   DEFAULT_CALL_TIMEOUT_S)),
                stub_timeout_s=spec.get("call_timeout_s",
                                        DEFAULT_CALL_TIMEOUT_S))
            directory = self._dir_client
        else:
            directory = ClusterDirectory()
        self.directory = directory

        self.node = ClusterNode(
            self.name, self.mrm, directory,
            peer_fetch=bool(spec.get("peer_fetch", True)),
            peer_codec=spec.get("peer_codec"),
            gather=bool(spec.get("gather", True)),
            address=self.address)

        self.mrm_server = None
        if spec.get("client_sock"):
            from repro_torch.core.shm_ipc import MRMServer
            self.mrm_server = MRMServer(
                self.mrm, spec["client_sock"],
                idle_timeout_s=spec.get("idle_timeout_s"))

    # -- request handling ----------------------------------------------------
    def _delay(self) -> None:
        if self.serve_delay_s > 0:
            time.sleep(self.serve_delay_s)

    def handle(self, req: dict):
        op = req["op"]
        if op.startswith("dir."):
            if self.dir_service is None:
                raise ValueError(f"{self.name} does not host a directory")
            return self.dir_service.handle(req)
        node, mrm = self.node, self.mrm
        # optional RequestContext metadata (DESIGN.md §12): the remote
        # daemon sees the same tenant/deadline the originating call does —
        # a data-plane read serving an urgent request folds that deadline
        # into THIS node's eviction horizon, and relayed opens are
        # tenant-attributed in this node's MRM
        ctx = RequestContext.from_wire(req.get("ctx"))
        if ctx is not None and ctx.deadline_s is not None:
            mrm.note_deadline(ctx.deadline_s)
        if op == "ping":
            return {"ok": True, "name": self.name,
                    "address": self.address}
        if op == "has_model":
            return {"ok": True, "has": node.has_model(_key(req["key"]))}
        if op == "model_nbytes":
            return {"ok": True,
                    "nbytes": node.model_nbytes(_key(req["key"]))}
        if op == "digest_model":
            path = mrm.disk.path_for(_key(req["key"]))
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(8 << 20), b""):
                    h.update(chunk)
            return {"ok": True, "digest": h.hexdigest(),
                    "nbytes": os.path.getsize(path)}
        if op == "fetch_model":
            key = _key(req["key"])
            nbytes = node.model_nbytes(key)
            if nbytes is None:
                raise FileNotFoundError(f"{key} not on {self.name}")
            return ({"ok": True, "stream": True, "nbytes": nbytes},
                    self._model_chunks(key))
        if op == "read_ranges":
            self._delay()
            data = node.read_model_ranges(_key(req["key"]),
                                          [tuple(r) for r in req["ranges"]])
            return {"ok": True, "data": data}
        if op == "has_shard":
            return {"ok": True,
                    "has": node.has_shard(_key(req["key"]), req["index"])}
        if op == "fetch_shard":
            self._delay()
            return {"ok": True,
                    "data": node.read_shard(_key(req["key"]), req["index"])}
        if op == "store_shard":
            node.store_shard(_key(req["key"]), req["index"], req["data"])
            return {"ok": True}
        if op == "open":
            return self._finish_open(
                self.mrm.open_async(_key(req["key"]),
                                    tier=req.get("tier", "host"), ctx=ctx),
                req.get("timeout"))
        if op == "open_begin":
            with self._lock:
                self._open_counter += 1
                token = f"open{self._open_counter}"
                self._opens[token] = self.mrm.open_async(
                    _key(req["key"]), tier=req.get("tier", "host"), ctx=ctx)
            return {"ok": True, "token": token}
        if op == "open_wait":
            with self._lock:
                fut = self._opens.pop(req["token"])
            return self._finish_open(fut, req.get("timeout"))
        if op == "set_serve_delay":
            self.serve_delay_s = float(req["seconds"])
            return {"ok": True}
        if op == "node_stats":
            return {"ok": True, "node": node.stats(),
                    "mrm": dict(mrm.metrics),
                    "calibration": self.mrm.hw.wire_calibration()}
        if op == "shutdown":
            self._stop.set()
            return {"ok": True}
        raise ValueError(f"unknown op {op!r}")

    def _model_chunks(self, key: ModelKey):
        path = self.mrm.disk.path_for(key)
        with open(path, "rb") as f:
            while True:
                self._delay()
                chunk = f.read(self.chunk_bytes)
                if not chunk:
                    break
                yield chunk
        self.node._note_serve("peer_serves")

    def _finish_open(self, fut, timeout: Optional[float]) -> dict:
        h = fut.result(timeout=timeout)
        try:
            t = h.timings
            timings = {"tier_hit": t.tier_hit, "cloud_s": t.cloud_s,
                       "peer_s": t.peer_s, "gather_s": t.gather_s,
                       "wire_s": t.wire_s, "wire_bytes": t.wire_bytes,
                       "total_s": t.total_s}
            path = self.mrm.disk.path_for(h.key)
            hh = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(8 << 20), b""):
                    hh.update(chunk)
            return {"ok": True, "nbytes": h.nbytes, "timings": timings,
                    "disk_digest": hh.hexdigest()}
        finally:
            self.mrm.close(h)

    # -- lifecycle -----------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._stop.wait(timeout)

    def shutdown(self, withdraw: bool = True) -> None:
        """SIGTERM-clean teardown: withdraw from the directory (peers
        stop planning against this node immediately instead of timing
        out on its hints), stop the servers, and unlink every shm
        segment this daemon owns."""
        self._stop.set()
        if withdraw:
            try:
                self.directory.drop_node(self.name)
            except OSError:
                pass  # directory host already gone: nothing to withdraw
        if self.mrm_server is not None:
            self.mrm_server.stop()
        self.server.stop()
        self.mrm.shutdown()
        for entry in list(self.mrm.host.entries.values()):
            entry.payload.release()  # unlinks owned trims_* shm segments
        if self._dir_client is not None:
            self._dir_client.close()


# ---------------------------------------------------------------------------
# spawn helper + CLI entry point
# ---------------------------------------------------------------------------

def spawn_node(spec: dict, stderr=None, ready_timeout_s: float = 30.0
               ) -> Tuple[subprocess.Popen, dict]:
    """Launch ``python -m repro_torch.core.noded`` with ``spec`` and block for
    its READY line. Returns ``(process, info)`` where ``info`` carries
    the daemon's resolved ``name``/``address``/``client_sock``. Raises
    :class:`TimeoutError` after ``ready_timeout_s`` even when the child
    stays alive but silent (deadlocked before READY) — stdout is drained
    by a reader thread, so the deadline is enforced while blocked, and
    the pipe can never fill up and wedge the child afterwards."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.noded",
         "--spec", json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=stderr, env=env, text=True)
    lines: queue.Queue = queue.Queue()

    def _pump(stream) -> None:
        for out in stream:
            lines.put(out)
        lines.put(None)  # EOF sentinel: the child exited

    threading.Thread(target=_pump, args=(proc.stdout,), daemon=True,
                     name=f"noded-{spec.get('name')}-stdout").start()
    deadline = time.monotonic() + ready_timeout_s
    last = ""
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            proc.kill()
            proc.wait(timeout=5)
            raise TimeoutError(f"noded {spec.get('name')!r} never became "
                               f"ready in {ready_timeout_s}s "
                               f"(last line: {last!r})")
        try:
            line = lines.get(timeout=min(remaining, 0.2))
        except queue.Empty:
            continue
        if line is None:
            proc.wait(timeout=5)
            raise RuntimeError(
                f"noded {spec.get('name')!r} exited rc={proc.returncode} "
                f"before READY")
        if line.startswith(READY_MARKER):
            info = json.loads(line[len(READY_MARKER):])
            return proc, info
        last = line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spec", required=True,
                    help="JSON NodeDaemon spec (or @/path/to/spec.json)")
    args = ap.parse_args(argv)
    raw = args.spec
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    daemon = NodeDaemon(json.loads(raw))

    def _terminate(signum, frame):
        daemon._stop.set()

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    print(f"{READY_MARKER} "
          + json.dumps({"name": daemon.name, "address": daemon.address,
                        "client_sock": daemon.spec.get("client_sock")}),
          flush=True)
    try:
        while not daemon.wait(0.2):
            pass
    finally:
        daemon.shutdown(withdraw=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
