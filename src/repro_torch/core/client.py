"""TrIMS framework client: the transparent integration layer (paper §4.2/§5.1).

The paper hooks MXNet's ``MXPredCreate``/``MXPredFree`` so user code is
unchanged. Our framework-facing API is :func:`load_model` / :func:`free_model`
— the functions a serving stack calls to materialize weights. When TrIMS
is enabled they route through ``trims_open``/``trims_close``; when disabled
they cold-load from disk exactly like an unmodified framework (the baseline
in every benchmark).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.costmodel import get_hardware
from repro_torch.core.mrm import MRM, ModelHandle, ModelKey, OpenTimings
from repro_torch.core.sharing import get_constants, plan_granularity, rho
from repro_torch.core.store import DiskStore
from repro_torch.device import resolve_device, synchronize, tensor_from_numpy


@dataclass
class LoadedModel:
    """What the framework hands back to user code: the same structure whether
    TrIMS served it (shared) or it was cold-loaded (private)."""
    key: ModelKey
    weights: Dict[str, object]
    nbytes: int
    timings: OpenTimings
    via_trims: bool
    handle: Optional[ModelHandle] = None


class TrimsClient:
    """Client-side stub bound to one MRM (in-process or via shm_ipc)."""

    def __init__(self, mrm: MRM, client_id: str = "client0",
                 auto_granularity: bool = True):
        self.mrm = mrm
        self.client_id = client_id
        self.auto_granularity = auto_granularity
        self.open_handles: Dict[int, ModelHandle] = {}

    def open(self, framework: str, name: str, version: str = "1",
             activation_bytes: int = 0, ctx=None) -> ModelHandle:
        """``ctx`` (optional :class:`~repro_torch.core.tenant.RequestContext`)
        rides down to the MRM so the open is tenant-attributed and
        admission-checked; ``None`` is anonymous default-tenant traffic."""
        key = ModelKey(framework, name, version)
        gran = "model"
        if self.auto_granularity and self.mrm.disk.contains(key):
            mf = self.mrm.disk.open(key)
            sizes = [t.nbytes for t in mf.tensors.values()]
            gran, _, r = plan_granularity(sizes)
            if r <= 0:
                gran = "model"  # sharing still wins at coarse granularity
        h = self.mrm.open(key, activation_bytes=activation_bytes,
                          granularity=gran, ctx=ctx)
        self.open_handles[h.handle_id] = h
        return h

    def open_async(self, framework: str, name: str, version: str = "1",
                   activation_bytes: int = 0, ctx=None):
        """Future-based open; ``result()`` yields the refcounted handle."""
        key = ModelKey(framework, name, version)
        fut = self.mrm.open_async(key, activation_bytes=activation_bytes,
                                  ctx=ctx)
        fut.add_done_callback(self._track_async)
        return fut

    def _track_async(self, fut):
        h = fut._result
        # result() can wake the caller before this callback runs, so the
        # handle may already be closed — tracking it then would leak it
        if h is not None and not h.closed:
            self.open_handles[h.handle_id] = h

    def prefetch(self, framework: str, name: str, version: str = "1",
                 tier: str = "device", ctx=None):
        """Warm-up hint: stage the model toward ``tier`` in the background
        without taking a reference (paper §4.1 'models can be preloaded')."""
        return self.mrm.prefetch(ModelKey(framework, name, version),
                                 tier=tier, ctx=ctx)

    def close(self, handle: ModelHandle):
        self.open_handles.pop(handle.handle_id, None)
        self.mrm.close(handle)

    def close_all(self):
        for h in list(self.open_handles.values()):
            self.close(h)


def cold_load(disk: DiskStore, key: ModelKey, device_put_fn=None,
              simulate_h2d_time: bool = False,
              objectstore=None, device="cuda") -> LoadedModel:
    """Baseline path: what an unmodified framework does on every cold start —
    read from disk, deserialize, copy to device. No sharing, no persistence.
    With ``objectstore`` the baseline gets four-tier parity: a disk-miss
    downloads from the CLOUD tier first (and pays its modeled leg), exactly
    like the un-TrIMSed FaaS fleet the paper compares against. Without a
    ``device_put_fn`` the copy is a torch device put onto ``device``."""
    dev = resolve_device(device)
    device_put_fn = device_put_fn or (lambda a: tensor_from_numpy(a, dev))
    hw = get_hardware()
    timings = OpenTimings(tier_hit="none(cold)")
    t_start = time.perf_counter()

    if (objectstore is not None and not disk.contains(key)
            and objectstore.contains(key)):
        timings.cloud_s, _ = objectstore.fetch(key, disk)
    mf = disk.open(key)  # absent everywhere -> FileNotFoundError, as ever
    nbytes = mf.total_bytes
    t0 = time.perf_counter()
    arrays = mf.read_all()
    dt = time.perf_counter() - t0
    io_est = hw.disk_time(nbytes)
    timings.disk_read_s = min(dt, io_est)
    timings.deserialize_s = max(0.0, dt - timings.disk_read_s)

    t0 = time.perf_counter()
    weights = {n: device_put_fn(a) for n, a in arrays.items()}
    synchronize(dev)
    timings.h2d_measured_s = time.perf_counter() - t0
    timings.h2d_modeled_s = hw.h2d_time(nbytes)
    if simulate_h2d_time and timings.h2d_measured_s < timings.h2d_modeled_s:
        time.sleep(min(timings.h2d_modeled_s - timings.h2d_measured_s, 0.25))
    timings.total_s = time.perf_counter() - t_start
    return LoadedModel(key, weights, nbytes, timings, via_trims=False)


def load_model(framework: str, name: str, version: str = "1", *,
               trims: Optional[TrimsClient] = None,
               disk: Optional[DiskStore] = None,
               activation_bytes: int = 0) -> LoadedModel:
    """The transparent hook: signature and return type identical with and
    without TrIMS (paper: 'user code can leverage TrIMS transparently')."""
    key = ModelKey(framework, name, version)
    if trims is not None:
        h = trims.open(framework, name, version, activation_bytes)
        return LoadedModel(key, h.weights, h.nbytes, h.timings,
                           via_trims=True, handle=h)
    if disk is None:
        raise ValueError("need either trims client or disk store")
    return cold_load(disk, key)


def free_model(m: LoadedModel, trims: Optional[TrimsClient] = None):
    if m.via_trims and trims is not None and m.handle is not None:
        trims.close(m.handle)
    m.weights = {}
