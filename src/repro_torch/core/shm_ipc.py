"""Cross-process TrIMS: unix-socket control plane + POSIX-shm data plane.

The host-tier half of the paper's gRPC + CUDA-IPC pair (DESIGN.md §2): the
MRM daemon deserializes each model **once** into shared-memory segments;
isolated client *processes* receive segment names over a length-prefixed
msgpack protocol and attach zero-copy numpy views. Each client stages what
it attached onto its own device (``device.tensor_from_numpy``); sharing the
device tier itself across processes (CUDA IPC handles) is not part of this
module.

PyTorch port: the ``open`` reply names each tensor's store dtype
(``"bfloat16"`` for the port's bf16 host arrays, which are tagged
``uint16`` bits), so the client's ``_np_dtype`` gives back bf16 bits and
a JAX-package client reads the same bytes as ``ml_dtypes.bfloat16``.

Wire protocol (msgpack, 4-byte little-endian length prefix)::

  {op: "open", framework, name, version}  ->
      {ok, handle_id, nbytes, segments: [{shm, size}],
       tensors: [{name, dtype, shape, segment, offset}], timings: {...}}
  {op: "close", handle_id}                -> {ok}
  {op: "prefetch", framework, name, version} -> {ok}   (async host-tier warm)
  {op: "stats"}                           -> {ok, stats}
"""
from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.store import _dtype_name, _np_dtype
from repro_torch.core.tenant import RequestContext
from repro_torch.core.transport import (TransportError, recv_frame, recvn,
                                        send_frame)


# name prefix of the segments this process creates: a leaked segment is
# found (and reaped) under /dev/shm by it; callers that must keep their
# segments apart from another reaper's set their own
SEGMENT_PREFIX = "trims_"


class ShmSegment:
    """Owner-side shared memory segment."""

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self.shm = shm
        self.owner = owner

    @property
    def name(self) -> str:
        return self.shm.name

    @property
    def buf(self):
        return self.shm.buf

    @classmethod
    def create(cls, key, nbytes: int) -> "ShmSegment":
        name = f"{SEGMENT_PREFIX}{uuid.uuid4().hex[:16]}"
        return cls(shared_memory.SharedMemory(create=True, size=max(1, nbytes),
                                              name=name), owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmSegment":
        try:
            # track=False (3.13+): the attaching process must NOT let its
            # resource tracker unlink a segment owned by the MRM daemon.
            shm = shared_memory.SharedMemory(name=name, track=False)
        except TypeError:
            # older python registers attachers unconditionally (bpo-39959);
            # unregister or this process unlinks the daemon's segment on exit
            shm = shared_memory.SharedMemory(name=name)
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:  # noqa: BLE001 — tracking is best-effort
                pass
        return cls(shm, owner=False)

    def close_and_unlink(self):
        try:
            self.shm.close()
        except Exception:
            pass
        if self.owner:
            try:
                self.shm.unlink()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# framing — the robust primitives live in core.transport (partial-write and
# EINTR handling, mid-frame-EOF detection); these aliases keep the module's
# historical private names for callers and tests
# ---------------------------------------------------------------------------

_send = send_frame
_recv = recv_frame
_recvn = recvn


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class MRMServer:
    """Threaded daemon exposing an MRM over a unix socket.

    ``idle_timeout_s`` (None = wait forever, the historical behavior)
    bounds how long a connection may sit silent between requests; a hung
    or vanished client then releases its handles and server thread
    instead of pinning them until process exit."""

    def __init__(self, mrm: MRM, sock_path: str,
                 idle_timeout_s: Optional[float] = None):
        assert mrm.use_shm, "MRMServer requires MRM(use_shm=True)"
        self.mrm = mrm
        self.sock_path = sock_path
        self.idle_timeout_s = idle_timeout_s
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(sock_path)
        self.sock.listen(64)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._accept_loop, daemon=True)
        self.thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                self.sock.settimeout(0.2)
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        conn_handles: List[int] = []
        try:
            conn.settimeout(self.idle_timeout_s)
            while True:
                try:
                    req = _recv(conn)
                except TransportError:
                    break  # idle timeout or truncated frame: drop the conn
                if req is None:
                    break
                try:
                    resp = self._dispatch(req, conn_handles)
                except Exception as e:  # noqa: BLE001 — wire errors back
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                try:
                    _send(conn, resp)
                except TransportError:
                    break  # client went away mid-response
        finally:
            # connection death releases its handles (paper: "user process exits")
            for hid in conn_handles:
                h = self.mrm._handles.get(hid)
                if h is not None:
                    self.mrm.close(h)
            conn.close()

    def _dispatch(self, req: dict, conn_handles: List[int]) -> dict:
        op = req.get("op")
        # optional request context (DESIGN.md §12): old clients simply omit
        # the key; the daemon folds the deadline into its horizon and hands
        # the context to the MRM so cross-process opens are tenant-attributed
        ctx = RequestContext.from_wire(req.get("ctx"))
        if ctx is not None and ctx.deadline_s is not None:
            self.mrm.note_deadline(ctx.deadline_s)
        if op == "open":
            key = ModelKey(req["framework"], req["name"], req.get("version", "1"))
            h = self.mrm.open(key, tier="host", ctx=ctx)
            conn_handles.append(h.handle_id)
            host_entry = self.mrm.host.peek(key)
            hm = host_entry.payload
            segs = [{"shm": s.name, "size": s.shm.size} for s in hm.shm_segments]
            tensors = []
            off = 0
            for name, arr in hm.arrays.items():
                # the store's dtype name: bf16 bits are tagged uint16 here
                tensors.append({"name": name, "dtype": _dtype_name(arr.dtype),
                                "shape": list(arr.shape), "segment": 0,
                                "offset": off})
                off += arr.nbytes
            t = h.timings
            return {"ok": True, "handle_id": h.handle_id, "nbytes": h.nbytes,
                    "segments": segs, "tensors": tensors,
                    "timings": {"tier_hit": t.tier_hit, "cloud_s": t.cloud_s,
                                "disk_read_s": t.disk_read_s,
                                "deserialize_s": t.deserialize_s,
                                "total_s": t.total_s}}
        if op == "close":
            hid = req["handle_id"]
            h = self.mrm._handles.get(hid)
            if h is not None:
                self.mrm.close(h)
                if hid in conn_handles:
                    conn_handles.remove(hid)
            return {"ok": True}
        if op == "prefetch":
            key = ModelKey(req["framework"], req["name"], req.get("version", "1"))
            # fire-and-forget: the future completes in the daemon; the client
            # only needs the ack — its next open coalesces onto the load
            self.mrm.prefetch(key, tier="host", ctx=ctx)
            return {"ok": True}
        if op == "stats":
            return {"ok": True, "stats": self.mrm.stats()}
        raise ValueError(f"unknown op {op!r}")

    def stop(self):
        self._stop.set()
        try:
            self.sock.close()
        finally:
            if os.path.exists(self.sock_path):
                os.unlink(self.sock_path)
        self.thread.join(timeout=2)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

@dataclass
class RemoteHandle:
    handle_id: int
    nbytes: int
    arrays: Dict[str, np.ndarray]
    timings: dict
    attach_s: float              # measured o+s (share overhead) on this open
    _segments: List[ShmSegment] = None  # type: ignore


class RemoteTrimsClient:
    """Client-process stub: attaches shm segments published by MRMServer.

    Thread-safe: one shared socket carries every request, so a
    per-request lock serializes whole ``send``/``recv`` exchanges — two
    threads interleaving frames would pair one thread's request with the
    other's response."""

    def __init__(self, sock_path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(sock_path)
        self._lock = threading.Lock()

    def _call(self, req: dict) -> Optional[dict]:
        with self._lock:
            _send(self.sock, req)
            return _recv(self.sock)

    def open(self, framework: str, name: str, version: str = "1",
             ctx=None) -> RemoteHandle:
        req = {"op": "open", "framework": framework,
               "name": name, "version": version}
        if ctx is not None:
            req["ctx"] = ctx.to_wire()
        resp = self._call(req)
        if resp is None or not resp.get("ok"):
            raise RuntimeError(f"open failed: {resp}")
        t0 = time.perf_counter()
        segs = [ShmSegment.attach(s["shm"]) for s in resp["segments"]]
        arrays = {}
        for tm in resp["tensors"]:
            seg = segs[tm["segment"]]
            count = int(np.prod(tm["shape"])) if tm["shape"] else 1
            arr = np.frombuffer(seg.buf, dtype=_np_dtype(tm["dtype"]),
                                count=count, offset=tm["offset"])
            arrays[tm["name"]] = arr.reshape(tm["shape"])
        attach_s = time.perf_counter() - t0
        return RemoteHandle(resp["handle_id"], resp["nbytes"], arrays,
                            resp["timings"], attach_s, segs)

    def close(self, h: RemoteHandle):
        # views must die before the segment detaches
        h.arrays = {}
        for seg in h._segments or []:
            try:
                seg.shm.close()
            except Exception:
                pass
        self._call({"op": "close", "handle_id": h.handle_id})

    def prefetch(self, framework: str, name: str, version: str = "1",
                 ctx=None):
        """Ask the daemon to warm the host tier; returns once acknowledged."""
        req = {"op": "prefetch", "framework": framework,
               "name": name, "version": version}
        if ctx is not None:
            req["ctx"] = ctx.to_wire()
        resp = self._call(req)
        if resp is None or not resp.get("ok"):
            raise RuntimeError(f"prefetch failed: {resp}")

    def stats(self) -> dict:
        resp = self._call({"op": "stats"})
        return resp["stats"]

    def disconnect(self):
        self.sock.close()
