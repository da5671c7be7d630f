"""TrIMS Model Resource Manager (paper §4.1, DESIGN.md §2-§4).

The MRM is the daemon that owns the multi-tier model cache and abstracts
model loading away from framework clients. ``open_async`` implements the
Fig. 7 state machine as a :class:`LoadFuture`:

  DEVICE hit             -> refcount++, hand out shared device arrays
  DEVICE miss / HOST hit -> make room on device, stage host->device
  HOST+DEVICE miss       -> disk, then a *chunked pipelined*
                            disk->host->device staging chain
  DISK miss              -> fetch from a peer node or the CLOUD tier
                            (whichever the cost model says is cheaper),
                            then the cold chain above (DESIGN.md §6)

Models are addressed by namespace ``(framework, name, version)``. Entries
with live references are never evicted; concurrent opens of the same model
coalesce onto one in-flight future (thundering-herd dedup). Eviction from
the device tier *demotes* victims into the host tier (TierHierarchy) rather
than dropping them, and ``prefetch`` warms a tier in the background without
taking a reference. Timings are recorded per-stage, both measured (real
disk/deserialize work and synchronised host->device copies on this host)
and modeled (H2D at ``hw.h2d_bw``) — see DESIGN.md §4 for the pipelined
staging model.

PyTorch port: the device tier holds torch tensors on ``MRM.device_name``
(CUDA by default). Every handle of one model receives the same device
tensors. In shm mode (``use_shm``) the HOST tier lives in POSIX shared
memory that client processes attach (``core.shm_ipc``), and a device
demotion copies each tensor from the card straight into its segment.
"""
from __future__ import annotations

import inspect
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.cache import CostAware, Tier, TierCache, TierHierarchy
from repro_torch.core.costmodel import (HardwareModel, PIPELINE_CHUNK_BYTES,
                                  get_hardware)
from repro_torch.core.pipeline import plan_chunks, run_pipeline
from repro_torch.core.slo import DEFAULT_HORIZON_S, SLOState
from repro_torch.core.store import CloudStore, DiskStore, ModelFile, _np_dtype
from repro_torch.core.tenant import RequestContext
from repro_torch.device import (numpy_dtype, resolve_device, synchronize,
                                tensor_from_numpy, tensor_into_numpy, tensor_to_numpy)

# write-back queue shutdown sentinel (MRM.shutdown)
_WB_SENTINEL = object()
# bound on the evicted-key tracking map feeding the misprediction metric
_EVICT_TRACK_MAX = 1024


class ModelKey(NamedTuple):
    """Namespace address of a model everywhere in the system."""
    framework: str
    name: str
    version: str = "1"


@dataclass
class OpenTimings:
    """Per-stage decomposition of one open — measured seconds where the
    work is real on this host (disk, deserialize), modeled where it is not
    (cloud/peer links); ``tier_hit`` names the resolving tier."""
    tier_hit: str = ""
    cloud_s: float = 0.0          # modeled CLOUD-tier download time
                                  # (compression-aware: wire at stored bytes
                                  # + overlapped decompress stage)
    peer_s: float = 0.0           # modeled peer-to-peer fetch time (cluster)
    gather_s: float = 0.0         # modeled multi-source shard gather time
                                  # (parallel links, ingest-bw capped — §8)
    decompress_s: float = 0.0     # measured inflate busy s (cloud/peer fetch)
    disk_read_s: float = 0.0      # measured file -> host bytes
    deserialize_s: float = 0.0    # measured unmarshal -> arrays
    h2d_measured_s: float = 0.0   # measured (synchronised) H2D copies
    h2d_modeled_s: float = 0.0    # modeled PCIe staging at hw.h2d_bw
    share_overhead_s: float = 0.0 # measured handle-creation overhead (o+s per object)
    total_s: float = 0.0
    # pipelined-staging accounting (DESIGN.md §4)
    chunks: int = 0               # staging chunks this open flowed through
    stage_overlap_s: float = 0.0  # measured stage-busy seconds hidden by overlap
    demote_s: float = 0.0         # modeled D2H cost of demotions this open caused
    staging_serial_modeled_s: float = 0.0
    staging_pipelined_modeled_s: float = 0.0
    # measured wire accounting (DESIGN.md §11): real seconds/bytes on a
    # socket transport (sum of per-transfer times — parallel gather links
    # overlap, so this is link-busy time, not wall time). Zero for
    # in-process (loopback) transfers, whose link times stay modeled.
    wire_s: float = 0.0
    wire_bytes: int = 0

    def modeled_total(self) -> float:
        return (self.cloud_s + self.peer_s + self.gather_s
                + self.disk_read_s + self.deserialize_s + self.h2d_modeled_s
                + self.share_overhead_s)


@dataclass
class HostModel:
    """HOST-tier payload: deserialized arrays (shm-backed in ipc mode)."""
    arrays: Dict[str, np.ndarray]
    nbytes: int
    shm_segments: list = field(default_factory=list)  # ShmSegment list (ipc mode)

    def release(self):
        self.arrays = {}
        for seg in self.shm_segments:
            seg.close_and_unlink()
        self.shm_segments = []


@dataclass
class ModelHandle:
    """A refcounted lease on a tier-resident model: ``weights`` alias the
    MRM's shared arrays — closing the handle releases the reference, never
    the copy."""
    handle_id: int
    key: ModelKey
    weights: Dict[str, object]   # name -> torch.Tensor (device) / np.ndarray (host)
    nbytes: int
    timings: OpenTimings
    granularity: str = "model"
    n_objects: int = 1
    tier: str = "device"
    closed: bool = False
    # private handles own their arrays outright (components-filtered
    # streaming loads, §9) — they never reference a cache entry, so
    # close() must not decrement anyone's refcount
    private: bool = False


def _accepts_kwarg(fn, name: str) -> bool:
    """True when ``fn`` can be called with keyword argument ``name``
    (either an explicit parameter or ``**kwargs``). Used to keep the
    streaming ``on_shard`` kwarg backward compatible with legacy
    remote-fetch hooks and store stubs installed by tests."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            return True
        if p.name == name and p.kind in (inspect.Parameter.KEYWORD_ONLY,
                                         inspect.Parameter.POSITIONAL_OR_KEYWORD):
            return True
    return False


# ---------------------------------------------------------------------------
# LoadFuture — the open/prefetch state machine (DESIGN.md §3)
# ---------------------------------------------------------------------------

PENDING = "pending"
LOADING = "loading"
READY = "ready"
FAILED = "failed"


class LoadFuture:
    """One open/prefetch in flight: ``pending -> loading -> ready | failed``.

    ``stage`` names the pipeline stage currently executing (``queued``,
    ``coalesced``, ``disk_read``, ``deserialize``, ``h2d``, ``hit``,
    ``done``, ``failed``) for observability. ``result()`` blocks and returns
    the :class:`ModelHandle` (or ``None`` for prefetches), re-raising any
    load error in the caller. Coalesced waiters, prefetch hints, and
    background loads all share this one code path.

    **Partial-open surface** (streaming opens, DESIGN.md §9): a future
    created by :meth:`MRM.open_stream` additionally exposes per-layer
    readiness — ``plan``/``arrays`` appear once the .trims header parses,
    ``wait_prefix(k)`` blocks until the first ``k`` layer windows are
    resident (readiness arrives in execution order), and ``demand(i)``
    asks the loader to stage window ``i`` next (on-demand MoE experts).
    A streaming future that coalesces onto another streaming load mirrors
    the primary's window events; coalescing onto a non-streaming load
    degrades gracefully — ``wait_prefix`` then releases only on
    completion, with ``plan`` left ``None`` (everything resident).
    """

    def __init__(self, key: ModelKey, tier: str = "device",
                 want_handle: bool = True, activation_bytes: int = 0,
                 granularity: str = "model", streaming: bool = False,
                 components: Optional[tuple] = None,
                 ctx: Optional[RequestContext] = None):
        self.key = key
        self.tier = tier
        self.ctx = ctx
        self.want_handle = want_handle
        self.activation_bytes = activation_bytes
        self.granularity = granularity
        self.streaming = streaming
        self.components = tuple(components) if components else None
        self.state = PENDING
        self.stage = "queued"
        self.coalesced = False
        self.suppressed = False  # batch prefetch refused under pressure
        self.timings = OpenTimings()
        self._t_start = time.perf_counter()
        self._retries = 0
        self._ev = threading.Event()
        self._result: Optional[ModelHandle] = None
        self._exc: Optional[BaseException] = None
        self._cbs = []
        self._cb_lock = threading.Lock()
        # -- partial-open state (DESIGN.md §9) --
        self.plan = None              # List[LayerWindow] once header parsed
        self.arrays = None            # live host arrays (fill as bytes land)
        self.meta = None              # .trims meta (carries the model config)
        self._win_cond = threading.Condition()
        self._win_done: set = set()
        self._win_prefix = 0          # leading complete windows
        self._win_total: Optional[int] = None
        self._win_listeners: List["LoadFuture"] = []
        self._demand: Optional[Callable[[int], bool]] = None

    # -- partial-open surface (streaming opens) ------------------------------
    def windows_ready(self) -> int:
        """Length of the ready prefix: windows ``[0, n)`` are resident."""
        with self._win_cond:
            return self._win_prefix

    def wait_prefix(self, k: int, timeout: Optional[float] = None) -> int:
        """Block until the first ``k`` layer windows are resident (or the
        whole load finished); returns the ready prefix length. ``k`` is
        clamped to the plan size once known. Re-raises the load's error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._win_cond:
            while True:
                k_eff = k if self._win_total is None \
                    else min(k, self._win_total)
                if self._win_prefix >= k_eff and self._win_total is not None:
                    return self._win_prefix
                if self._ev.is_set():
                    break
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"open of {self.key}: prefix {k} still "
                        f"{self._win_prefix} ready")
                self._win_cond.wait(remaining)
        if self._exc is not None:
            raise self._exc
        with self._win_cond:
            # finished without a plan (tier hit / non-streaming primary):
            # everything is resident
            return self._win_prefix if self._win_total is not None else k

    def demand(self, window_index: int) -> bool:
        """Hint the in-flight stream to stage ``window_index`` next (jump
        the disk queue) — the on-demand path for MoE expert windows.
        Returns False when no stream is accepting hints (already complete,
        or a non-streaming load)."""
        fn = self._demand
        return bool(fn(window_index)) if fn is not None else False

    def _set_plan(self, plan, arrays, meta=None):
        listeners: List[LoadFuture] = []
        with self._win_cond:
            if self.plan is None:
                self.plan = plan
                self.arrays = arrays
                self.meta = meta
                self._win_total = len(plan)
                listeners = list(self._win_listeners)
            self._win_cond.notify_all()
        for o in listeners:
            o._set_plan(plan, arrays, meta)

    def _mark_window(self, index: int):
        listeners: List[LoadFuture] = []
        with self._win_cond:
            if index in self._win_done:
                return
            self._win_done.add(index)
            while self._win_prefix in self._win_done:
                self._win_prefix += 1
            listeners = list(self._win_listeners)
            self._win_cond.notify_all()
        for o in listeners:
            o._mark_window(index)

    def _add_window_listener(self, other: "LoadFuture"):
        """Mirror this (primary) future's window events onto a coalesced
        streaming waiter, replaying anything that already fired."""
        with self._win_cond:
            plan, arrays, meta = self.plan, self.arrays, self.meta
            done = sorted(self._win_done)
            self._win_listeners.append(other)
        other._demand = self.demand
        if plan is not None:
            other._set_plan(plan, arrays, meta)
        for i in done:
            other._mark_window(i)

    # -- caller side --------------------------------------------------------
    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Optional[ModelHandle]:
        if not self._ev.wait(timeout):
            raise TimeoutError(f"open of {self.key} still {self.stage}")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None):
        self._ev.wait(timeout)
        return self._exc

    def add_done_callback(self, fn: Callable[["LoadFuture"], None]):
        with self._cb_lock:
            if not self._ev.is_set():
                self._cbs.append(fn)
                return
        fn(self)

    # -- MRM side ------------------------------------------------------------
    def _finish(self, result: Optional[ModelHandle] = None,
                exc: Optional[BaseException] = None):
        with self._cb_lock:
            self._result, self._exc = result, exc
            self.state = FAILED if exc is not None else READY
            self.stage = "failed" if exc is not None else "done"
            cbs, self._cbs = self._cbs, []
            self._ev.set()
        with self._win_cond:  # release wait_prefix callers (done or failed)
            self._win_cond.notify_all()
        for fn in cbs:
            fn(self)


class MRM:
    """Model Resource Manager server (in-process core; see shm_ipc for the
    cross-process wrapper)."""

    def __init__(self,
                 disk: DiskStore,
                 cloud: Optional[CloudStore] = None,
                 device_capacity: Optional[int] = None,
                 host_capacity: int = 64 * 2 ** 30,
                 policy: str = "lru",
                 hw: Optional[HardwareModel] = None,
                 eager_reclaim: bool = False,
                 use_shm: bool = False,
                 device_put_fn: Optional[Callable] = None,
                 simulate_h2d_time: bool = False,
                 demote_on_evict: bool = True,
                 pipelined_staging: bool = True,
                 staging_chunk_bytes: int = PIPELINE_CHUNK_BYTES,
                 pipeline_depth: int = 2,
                 objectstore=None,
                 writeback_to_cloud: bool = False,
                 cloud_codec: Optional[str] = None,
                 device="cuda"):
        self.device_name = resolve_device(device)
        if device_capacity is None:
            if self.device_name.type != "cuda":
                raise ValueError("device_capacity is required off CUDA")
            # free device memory at start-up, not a fixed figure
            device_capacity = torch.cuda.mem_get_info(self.device_name)[0]
        self.disk = disk
        self.cloud = cloud
        self.objectstore = objectstore  # CLOUD tier (core.objectstore)
        self.hw = hw or get_hardware()
        # cluster hook (core.cluster): fn(key, timings) -> bool resolving a
        # DISK miss from a cheaper source (peer link) before the CLOUD tier
        self.remote_fetch: Optional[Callable] = None
        # SLO-aware eviction (policy="slo", DESIGN.md §7): one shared
        # arrival predictor feeds per-tier CostAware policies whose reload
        # cost is priced from each tier's own backing tier
        self.slo: Optional[SLOState] = None
        # multi-tenant isolation (DESIGN.md §12): set by
        # TenantRegistry.attach — when present, context-carrying opens are
        # attributed per tenant, quota/deadline admission may degrade a
        # device open to host tier, and CostAware eviction is share-weighted
        self.tenants = None
        device_policy = host_policy = policy
        if policy == CostAware.name:
            self.slo = SLOState(self.hw, self._device_backing_tier,
                                self._host_backing_tier)
            device_policy = CostAware(
                self.slo.predictor,
                cost_fn=lambda e: self.slo.estimator.reload_cost_s(
                    e.key, e.nbytes),
                horizon_fn=lambda: self.slo.horizon_s)
            host_policy = CostAware(
                self.slo.predictor,
                cost_fn=lambda e: self.slo.host_estimator.reload_cost_s(
                    e.key, e.nbytes),
                horizon_fn=lambda: self.slo.horizon_s)
        self.device = TierCache(Tier.DEVICE, device_capacity, device_policy)
        self.host = TierCache(Tier.HOST, host_capacity, host_policy)
        self.tiers = TierHierarchy(self.device, self.host,
                                   demote_fn=self._demote_device_payload,
                                   demote_on_evict=demote_on_evict)
        self.eager_reclaim = eager_reclaim
        self.use_shm = use_shm
        self.device_put_fn = device_put_fn or self._device_put
        self.simulate_h2d_time = simulate_h2d_time
        self.pipelined_staging = pipelined_staging
        self.staging_chunk_bytes = staging_chunk_bytes
        self.pipeline_depth = pipeline_depth
        self._handles: Dict[int, ModelHandle] = {}
        self._hid = itertools.count(1)
        self._lock = threading.RLock()
        self._inflight: Dict[ModelKey, LoadFuture] = {}
        self.metrics = {
            "opens": 0, "closes": 0, "coalesced_loads": 0,
            "cloud_downloads": 0, "disk_loads": 0, "h2d_stages": 0,
            "bytes_from_disk": 0, "bytes_h2d": 0,
            "prefetches": 0, "pipelined_loads": 0,
            "peer_fetches": 0, "gather_fetches": 0, "cloud_writebacks": 0,
            "cloud_writeback_errors": 0,
            # streaming (partial) opens — DESIGN.md §9
            "stream_opens": 0, "stream_loads": 0, "partial_loads": 0,
            # modeled seconds of work this node performed — survives open
            # coalescing (a coalesced waiter's own timings show a zero-cost
            # hit; the staging cost lives here, on the node that paid it)
            "modeled_fetch_s": 0.0, "modeled_stage_s": 0.0,
            # SLO-aware eviction accounting (DESIGN.md §7): evictions whose
            # key came back within the deadline horizon despite a
            # farther-out prediction; host hits a demotion paid for; and
            # modeled reload seconds attributable to earlier evictions
            "mispredicted_evictions": 0, "demotion_saved_reloads": 0,
            "evicted_reload_stalls": 0, "slo_stall_s": 0.0,
            # tenancy admission (DESIGN.md §12): device opens degraded to
            # host tier because the deadline was already infeasible, or
            # because the tenant's device quota was exhausted
            "admission_degraded": 0, "quota_degraded": 0,
            # batch-class prefetches refused while the tiers are under
            # pressure (DESIGN.md §13: planner traffic yields to demand)
            "prefetch_suppressed": 0,
        }
        # eviction-attribution state: device victims awaiting a possible
        # return (key -> (t_evict, predicted_next_use_s)), keys whose
        # HOST copy exists because eviction-as-demotion put it there, and
        # a mirror of device residency the HOST policy may read under the
        # host lock (peeking the device cache there would invert the
        # DEVICE -> HOST lock order)
        self._evicted_at: Dict[ModelKey, tuple] = {}
        self._demoted_keys: set = set()
        self._device_keys: set = set()
        self._evict_lock = threading.Lock()
        self.device.add_listener(self._on_device_event)
        self.writeback_to_cloud = writeback_to_cloud
        # codec for CLOUD write-backs (None -> the object store's default);
        # fetches always decode whatever codec the manifest records
        self.cloud_codec = cloud_codec
        self._wb_queue = None
        self._wb_thread = None
        self._wb_shutdown = False
        # serializes {flag check, put} against shutdown's {flag set, put
        # sentinel}: without it a straggler put can land after the worker
        # exits and leave queue.join() waiting forever. Leaf lock (taken
        # under the host cache lock by the listener).
        self._wb_lock = threading.Lock()
        if writeback_to_cloud and objectstore is not None:
            self._start_writeback()

    def attach_objectstore(self, objectstore) -> None:
        """Late-bind the CLOUD tier (the ``Cluster.add_node`` path); arms
        the demotion write-back worker if it was requested at construction."""
        self.objectstore = objectstore
        if self.writeback_to_cloud and self._wb_queue is None:
            self._start_writeback()

    def _device_put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on ``device_name`` (bf16 through its uint16
        bits). A plain synchronous copy; the stage that calls it
        synchronises before its busy time is read."""
        return tensor_from_numpy(arr, self.device_name)

    def _start_writeback(self) -> None:
        import queue
        self._wb_queue = queue.Queue()
        self.host.add_listener(self._on_host_remove)
        self._wb_thread = threading.Thread(target=self._writeback_worker,
                                           daemon=True, name="mrm-writeback")
        self._wb_thread.start()

    # ------------------------------------------- SLO-aware eviction support
    def _device_backing_tier(self, key, nbytes: int) -> Optional[Tier]:
        """Warmest tier that would still hold ``key`` after a DEVICE
        eviction: HOST when it already holds a copy, or when
        eviction-as-demotion would re-home the victim there AND the host
        tier visibly has the room (demotion is best-effort — pricing a
        doomed demotion as a host hit would make every victim look cheap);
        else DISK, else None (CLOUD/refetch). Runs under the device lock —
        only takes locks below it in the DEVICE -> HOST order."""
        if self.host.peek(key) is not None:
            return Tier.HOST
        if (self.tiers.demote_on_evict and self.tiers.demote_fn is not None
                and self.host.free_bytes() >= nbytes):
            return Tier.HOST
        return Tier.DISK if self.disk.contains(key) else None

    def _host_backing_tier(self, key, nbytes: int) -> Optional[Tier]:
        """After a HOST eviction the copy falls back to local disk (or all
        the way to the CLOUD tier when the disk never held it) — unless a
        DEVICE copy exists, in which case the host copy is redundant (a
        later device eviction demotes it right back): cost ~0, so the
        host tier sheds duplicates first and caches the next-hottest
        working set below the device's (exclusive-ish hierarchy)."""
        with self._evict_lock:
            if key in self._device_keys:
                return Tier.DEVICE
        return Tier.DISK if self.disk.contains(key) else None

    def note_deadline(self, deadline_s: Optional[float] = None) -> None:
        """Fold a request deadline into the eviction policy's horizon
        (no-op unless ``policy=\"slo\"``) — the FaaS layer calls this on
        every deadline-carrying invoke (DESIGN.md §7). ``None`` is a safe
        no-op; anything else is validated once, at the RequestContext
        boundary (``repro_torch.core.tenant``)."""
        ctx = RequestContext.coerce(deadline_s=deadline_s)
        if self.slo is not None and ctx is not None:
            self.slo.note_deadline(ctx.deadline_s)

    def _now(self) -> float:
        return self.slo.now() if self.slo is not None else time.monotonic()

    def _on_device_event(self, event: str, entry) -> None:
        """Device-cache listener (under the device lock — leaf locks only):
        mirror device residency for the host policy, and remember when a
        live entry left the device tier and how far away its next use was
        predicted, so a quick return can be scored as a mispredicted
        eviction and its reload stall attributed."""
        if event == "insert":
            with self._evict_lock:
                self._device_keys.add(entry.key)
            return
        with self._evict_lock:
            self._device_keys.discard(entry.key)
        if entry.payload is None:  # placeholder rollback, not an eviction
            return
        now = self._now()
        pred = (self.slo.predictor.predict_next_use_s(entry.key, now=now)
                if self.slo is not None else None)
        with self._evict_lock:
            if len(self._evicted_at) >= _EVICT_TRACK_MAX:
                self._evicted_at.pop(next(iter(self._evicted_at)))
            self._evicted_at[entry.key] = (now, pred)

    def _record_arrival(self, fut: LoadFuture) -> None:
        """Feed the next-use predictor with *usage* events only: a
        handle-carrying open records once — at its tier hit, on becoming
        the primary loader, or on first coalescing onto a PREFETCH's
        in-flight load (``_submit`` gates that last site). Prefetches are
        hints, not usage, and never record; nor do opens coalescing onto
        another open (a thundering herd is one demand event per load).
        Anything else would double-count the router's prefetch + the
        function's own open of the same key, halving every routed key's
        EWMA gap and inflating its reuse probability."""
        if self.slo is not None and fut.want_handle and not fut.coalesced:
            self.slo.predictor.record(fut.key, now=self._now())

    def _note_arrival(self, fut: LoadFuture) -> None:
        """If the key was evicted from DEVICE earlier, attribute the
        reload once the future lands (arrival *recording* happens in
        ``_submit``, where coalescing is known)."""
        key = fut.key
        now = self._now()
        with self._evict_lock:
            info = self._evicted_at.pop(key, None)
        if info is None or fut.tier != "device":
            return
        t_evict, pred = info
        horizon = self.slo.horizon_s if self.slo is not None \
            else DEFAULT_HORIZON_S
        # mispredicted: the key returned within one deadline horizon of its
        # eviction even though the predictor expected it farther out (or
        # had nothing to say) — the eviction cost a deadline-relevant reload
        mispredicted = ((now - t_evict) <= horizon
                        and (pred is None or pred > horizon))

        def account(f: LoadFuture):
            t = f.timings
            if f._exc is not None or t.tier_hit in ("", "device"):
                return  # never reloaded (hit/coalesced/failed): no stall
            stall = t.cloud_s + t.peer_s + t.gather_s + (
                t.h2d_modeled_s if t.tier_hit == "host"
                else t.staging_pipelined_modeled_s)
            with self._lock:
                self.metrics["evicted_reload_stalls"] += 1
                self.metrics["slo_stall_s"] += stall
                if mispredicted:
                    self.metrics["mispredicted_evictions"] += 1

        fut.add_done_callback(account)

    # ------------------------------------------------ tenancy & admission
    def _nbytes_hint(self, key: ModelKey) -> int:
        """Best-effort size of ``key`` from the warmest source that knows it
        (tier entry, local file, CLOUD manifest); 0 when nobody does."""
        for cache in (self.device, self.host):
            e = cache.peek(key)
            if e is not None:
                return e.nbytes
        if self.disk.contains(key):
            try:
                import os
                return os.path.getsize(self.disk.path_for(key))
            except OSError:
                pass
        obj = self.objectstore
        if obj is not None and hasattr(obj, "stat"):
            st = obj.stat(key)
            if st:
                return st.get("nbytes", 0)
        return 0

    def estimated_ready_s(self, key: ModelKey) -> float:
        """Modeled seconds until ``key`` could be DEVICE-resident here,
        priced from its current warmest tier (0 for a device hit, H2D for
        host, the pipelined staging chain for disk, cloud fetch on top for
        absent) — the per-key admission analogue of
        ``FaaSPlatform.estimated_ready_s``."""
        key = ModelKey(*key)
        if self.device.peek(key) is not None:
            return 0.0
        nbytes = self._nbytes_hint(key)
        if self.host.peek(key) is not None:
            return self.hw.h2d_time(nbytes)
        if self.disk.contains(key):
            return self.hw.staging_pipelined_time(nbytes)
        return (self.hw.cloud_fetch_time(nbytes)
                + self.hw.staging_pipelined_time(nbytes))

    def _admit_tier(self, key: ModelKey, ctx: RequestContext,
                    tier: str) -> str:
        """Context-aware staging-tier decision (DESIGN.md §12), active only
        when a :class:`~repro_torch.core.tenant.TenantRegistry` is attached.
        A device open degrades to host when (a) the modeled time-to-ready
        already blows the request's deadline — device staging would burn
        H2D bandwidth on a request that has lost — or (b) the tenant's
        hard device-byte quota is exhausted. Both leave the request
        *served* (host-resident weights) and count in ``metrics``."""
        if tier != "device" or self.tenants is None:
            return tier
        if (ctx.deadline_s is not None
                and self.estimated_ready_s(key) > ctx.deadline_s):
            with self._lock:
                self.metrics["admission_degraded"] += 1
            self.tenants.note_degraded(ctx.tenant)
            return "host"
        if self.tenants.would_exceed(ctx.tenant, "device",
                                     self._nbytes_hint(key)):
            with self._lock:
                self.metrics["quota_degraded"] += 1
            self.tenants.note_degraded(ctx.tenant)
            return "host"
        return tier

    def _note_ctx(self, key: ModelKey, ctx: Optional[RequestContext]) -> None:
        if ctx is not None and self.tenants is not None:
            self.tenants.note_open(key, ctx.tenant)

    def _tier_frac(self, cache) -> float:
        with cache.lock:
            return cache.used / cache.capacity if cache.capacity else 1.0

    def _suppress_prefetch(self, key: ModelKey,
                           ctx: Optional[RequestContext],
                           want_handle: bool) -> bool:
        """Batch-class prefetch admission (DESIGN.md §13): a speculative
        warm-up carrying a batch RequestContext is refused outright while
        either tier is under admission pressure, so planner pre-positioning
        can never displace or queue behind a critical demand open. Handle
        -carrying opens and context-free legacy prefetches are untouched."""
        if (want_handle or ctx is None or self.tenants is None
                or ctx.slo_class != "batch"):
            return False
        verdict = self.tenants.admit(ctx, self._tier_frac(self.device),
                                     self._tier_frac(self.host))
        return verdict != "admit"

    # ------------------------------------------------------------------ API
    def open_async(self, key: ModelKey, activation_bytes: int = 0,
                   granularity: str = "model", tier: str = "device",
                   want_handle: bool = True,
                   _inline: bool = False,
                   ctx: Optional[RequestContext] = None) -> LoadFuture:
        """Resolve a model asynchronously; returns a :class:`LoadFuture`.

        A tier hit completes the future before returning. Otherwise the
        future either coalesces onto the in-flight load of the same key or
        becomes the loader itself (in a background thread, or in the calling
        thread when ``_inline`` — the synchronous :meth:`open` path).

        ``ctx`` (optional :class:`~repro_torch.core.tenant.RequestContext`)
        attributes the staged bytes to a tenant and arms quota/deadline
        admission when a registry is attached; without a registry it is
        inert metadata, so legacy callers are unchanged.
        """
        key = ModelKey(*key)
        self._note_ctx(key, ctx)
        if self._suppress_prefetch(key, ctx, want_handle):
            fut = LoadFuture(key, tier, want_handle,
                             activation_bytes, granularity, ctx=ctx)
            with self._lock:
                self.metrics["prefetches"] += 1
                self.metrics["prefetch_suppressed"] += 1
            fut.suppressed = True
            fut._finish(None)
            return fut
        if ctx is not None:
            tier = self._admit_tier(key, ctx, tier)
        fut = LoadFuture(key, tier, want_handle,
                         activation_bytes, granularity, ctx=ctx)
        with self._lock:
            if want_handle:
                self.metrics["opens"] += 1
            else:
                self.metrics["prefetches"] += 1
        self._note_arrival(fut)
        self._submit(fut, inline=_inline)
        return fut

    def open(self, key: ModelKey, activation_bytes: int = 0,
             granularity: str = "model", tier: str = "device",
             ctx: Optional[RequestContext] = None) -> ModelHandle:
        """Blocking open: ``open_async(...).result()``.

        ``tier="host"`` returns host-resident numpy views without device
        staging — the cross-process (shm_ipc) path.
        """
        return self.open_async(key, activation_bytes, granularity, tier,
                               _inline=True, ctx=ctx).result()

    def prefetch(self, key: ModelKey, tier: str = "device",
                 ctx: Optional[RequestContext] = None) -> LoadFuture:
        """Warm ``key`` into ``tier`` in the background without taking a
        reference; the future resolves to ``None`` when the tier is warm."""
        return self.open_async(key, tier=tier, want_handle=False, ctx=ctx)

    def open_stream(self, key: ModelKey, want_handle: bool = True,
                    components: Optional[tuple] = None,
                    ctx: Optional[RequestContext] = None) -> LoadFuture:
        """Partial open (DESIGN.md §9): a host-tier open whose future
        exposes per-layer readiness — ``wait_prefix``/``windows_ready``
        fire as each layer window's bytes land and verify, in execution
        order, fed by the gather/fetch shard pipeline on the wire leg and
        by a demand-reorderable window reader on the disk leg.

        ``components`` restricts staging to a subset of window groups
        (``"stem"``, ``"encoder"``, ``"layer"``, ``"expert"``) — e.g.
        ``("stem", "layer")`` skips a vlm/encdec checkpoint's unused
        frontend half and MoE expert banks. A partial load is **private**:
        it bypasses the host cache (a cached entry must always hold the
        full tensor set) and its handle just owns its own arrays.

        Host-tier hits and coalescing behave exactly as :meth:`open_async`
        — a warm model simply completes the future with ``plan = None``
        (nothing to wait for). In shm (cross-process) mode streaming
        degrades to an ordinary host open.
        """
        key = ModelKey(*key)
        if self.use_shm:
            # shm segments are carved per-tensor up front and shared by
            # name — per-window scatter into them is not supported
            return self.open_async(key, tier="host", want_handle=want_handle,
                                   ctx=ctx)
        self._note_ctx(key, ctx)
        fut = LoadFuture(key, tier="host", want_handle=want_handle,
                         streaming=True, components=components, ctx=ctx)
        with self._lock:
            if want_handle:
                self.metrics["opens"] += 1
            else:
                self.metrics["prefetches"] += 1
            self.metrics["stream_opens"] += 1
        self._note_arrival(fut)
        self._submit(fut)
        return fut

    def pin(self, key: ModelKey, tier: Tier = Tier.DEVICE) -> bool:
        return self.tiers.pin(ModelKey(*key), tier)

    def unpin(self, key: ModelKey, tier: Tier = Tier.DEVICE) -> bool:
        return self.tiers.unpin(ModelKey(*key), tier)

    def close(self, handle: ModelHandle):
        with self._lock:
            if handle.closed:
                return
            handle.closed = True
            self.metrics["closes"] += 1
            self._handles.pop(handle.handle_id, None)
            if handle.private:
                return  # owns its arrays; no cache entry to release
            cache = self.device if handle.tier == "device" else self.host
            e = cache.peek(handle.key)
            if e is not None and e.refcount > 0:
                e.refcount -= 1
                if self.eager_reclaim and e.refcount == 0:
                    cache.remove(handle.key)
                    if handle.tier == "host" and e.payload is not None:
                        e.payload.release()
                    e.payload = None

    def drop_model(self, key: ModelKey, from_disk: bool = False) -> dict:
        """Deregister ``key`` from this MRM: evict idle tier copies
        (refcount 0, unpinned), optionally delete the local DISK file, and
        always ``forget()`` the key's arrival history — the predictor's
        slots are bounded, so a deregistration that skips the forget leaks
        one until capacity eviction reclaims it, possibly at a live
        stream's expense (DESIGN.md §7/§13). In-use copies are left alone
        and reported via ``"busy"``; the CLOUD tier is never touched."""
        key = ModelKey(*key)
        out = {"device": False, "host": False, "disk": False, "busy": False}
        for tier_name, cache in (("device", self.device), ("host", self.host)):
            payload = None
            with cache.lock:
                e = cache.peek(key)
                if e is None:
                    continue
                if e.refcount > 0 or e.pinned:
                    out["busy"] = True
                    continue
                # a drop is not a demotion: null the payload so the host
                # write-back listener does not republish the copy to CLOUD
                payload = e.payload
                e.payload = None
                cache.remove(key)
                out[tier_name] = True
            if tier_name == "host" and payload is not None:
                payload.release()
        if from_disk and not out["busy"] and self.disk.contains(key):
            self.disk.delete(key)
            out["disk"] = True
        if self.slo is not None:
            self.slo.predictor.forget(key)
        return out

    def stats(self) -> dict:
        with self._lock:
            slo_stats = (self.slo.predictor.stats()
                         if self.slo is not None else {})
            return {"device": self.device.stats(), "host": self.host.stats(),
                    **self.tiers.stats(), **self.metrics,
                    "predictor_evicted_streams":
                        slo_stats.get("evicted_streams", 0)}

    # ------------------------------------------------- future orchestration
    def _submit(self, fut: LoadFuture, inline: bool = False):
        key = fut.key
        with self._lock:
            cache = self.device if fut.tier == "device" else self.host
            with cache.lock:
                hit = cache.get(key)
                if hit is not None and hit.payload is None:
                    hit = None  # capacity reserved, staging in flight
                if hit is not None and fut.want_handle:
                    # refcount under the cache lock: an eviction pass must
                    # never see this entry at refcount 0 once we've hit it
                    hit.refcount += 1
            if hit is not None:
                fut.stage = "hit"
                fut.timings.tier_hit = fut.tier
                self._record_arrival(fut)
                self._complete_hit(fut, hit)
                return
            primary = self._inflight.get(key)
            if primary is not None:
                if not primary.want_handle:
                    # coalescing onto a prefetch's load: this open is the
                    # first real usage of that staging work
                    self._record_arrival(fut)
                fut.coalesced = True
                fut.stage = "coalesced"
                self.metrics["coalesced_loads"] += 1
                if fut.streaming and primary.streaming:
                    # mirror the primary's per-window readiness so this
                    # waiter's wait_prefix releases as layers land (§9)
                    primary._add_window_listener(fut)
                primary.add_done_callback(
                    lambda p: self._on_primary_done(fut, p))
                return
            if not (fut.streaming and fut.components is not None):
                # a components-filtered (partial) load must not become the
                # primary: other opens coalescing onto it would adopt an
                # incomplete tensor set
                self._inflight[key] = fut
            fut.state = LOADING
            self._record_arrival(fut)
        if inline:
            self._run_load(fut)
        else:
            threading.Thread(target=self._run_load, args=(fut,), daemon=True,
                             name=f"mrm-load-{key.name}").start()

    def _complete_hit(self, fut: LoadFuture, entry):
        """Entry already refcounted by _submit when a handle is wanted."""
        try:
            if fut.want_handle:
                h = self._make_handle(fut.key, entry, fut.timings,
                                      fut.granularity, fut._t_start, fut.tier)
            else:
                h = None
                fut.timings.total_s = time.perf_counter() - fut._t_start
            fut._finish(result=h)
        except BaseException as e:  # noqa: BLE001 — delivered via the future
            fut._finish(exc=e)

    def _on_primary_done(self, fut: LoadFuture, primary: LoadFuture):
        """A load this future coalesced onto finished: take the hit path, or
        re-enter the load if the entry was evicted before we attached."""
        if primary._exc is not None:
            fut._finish(exc=primary._exc)
            return
        fut._retries += 1
        if fut._retries > 8:
            fut._finish(exc=RuntimeError(
                f"open of {fut.key} lost the load/evict race repeatedly"))
            return
        try:
            self._submit(fut)
        except BaseException as e:  # noqa: BLE001
            fut._finish(exc=e)

    def _run_load(self, fut: LoadFuture):
        try:
            result, exc = self._load_and_stage(fut), None
        except BaseException as e:  # noqa: BLE001 — delivered via the future
            result, exc = None, e
        with self._lock:
            if self._inflight.get(fut.key) is fut:
                del self._inflight[fut.key]
        fut._finish(result=result, exc=exc)

    # ------------------------------------------------------------- internals
    def _make_handle(self, key, entry, timings, granularity, t_start,
                     tier: str = "device") -> ModelHandle:
        t0 = time.perf_counter()
        payload = entry.payload.arrays if isinstance(entry.payload, HostModel) \
            else entry.payload
        weights = dict(payload)  # shallow: arrays shared, dict private
        timings.share_overhead_s = time.perf_counter() - t0
        timings.total_s = time.perf_counter() - t_start
        h = ModelHandle(next(self._hid), key, weights, entry.nbytes,
                        timings, granularity,
                        n_objects=1 if granularity == "model" else len(weights),
                        tier=tier)
        with self._lock:
            self._handles[h.handle_id] = h
        return h

    def _finish_entry(self, fut: LoadFuture, cache: TierCache, entry,
                      unpin: bool = False,
                      already_referenced: bool = False) -> Optional[ModelHandle]:
        # refcount and staging-pin release must flip atomically under the
        # cache lock: a gap would leave a refcount-0 unpinned entry that a
        # concurrent eviction pass could reap before the handle exists
        with cache.lock:
            if fut.want_handle:
                if not already_referenced:
                    entry.refcount += 1
            elif already_referenced:
                entry.refcount -= 1  # prefetch: drop the provisional guard
            if unpin:
                entry.pinned = False
        if not fut.want_handle:
            fut.timings.total_s = time.perf_counter() - fut._t_start
            return None
        return self._make_handle(fut.key, entry, fut.timings, fut.granularity,
                                 fut._t_start, fut.tier)

    def _load_and_stage(self, fut: LoadFuture) -> Optional[ModelHandle]:
        key, timings = fut.key, fut.timings
        # hit-check and source refcount are one atomic step: a concurrent
        # host-tier eviction between them would release the buffers we are
        # about to hand out or copy from
        host_entry = None
        with self.host.lock:
            e = self.host.get(key)
            if e is not None and e.payload is not None:
                e.refcount += 1  # provisional guard, settled below
                host_entry = e

        fresh = host_entry is None
        if fresh:
            # provisional: _ensure_on_disk overwrites with "peer"/"cloud"
            # when the model has to be fetched from outside this node
            timings.tier_hit = "disk"
            if fut.streaming:
                return self._load_host_streaming(fut)
            if fut.tier == "device" and self.pipelined_staging:
                return self._load_cold_pipelined(fut)
            host_entry = self._load_host(key, timings, fut)  # still pinned
        else:
            timings.tier_hit = "host"
            with self._evict_lock:
                saved = key in self._demoted_keys
                self._demoted_keys.discard(key)
            if saved:  # this host copy exists because a demotion paid D2H
                with self._lock:
                    self.metrics["demotion_saved_reloads"] += 1

        if fut.tier == "host":
            # warm path: the provisional ref becomes the handle's ref (or is
            # dropped for prefetches); fresh path takes a new ref and unpins
            return self._finish_entry(fut, self.host, host_entry, unpin=fresh,
                                      already_referenced=not fresh)
        try:
            dev_entry = self._stage_device(key, host_entry,
                                           fut.activation_bytes, timings, fut)
        finally:
            with self.host.lock:
                if fresh:
                    host_entry.pinned = False
                else:
                    host_entry.refcount -= 1
        return self._finish_entry(fut, self.device, dev_entry, unpin=True)

    def _ensure_on_disk(self, key, timings, on_shard=None, ctx=None):
        """DISK-miss fall-through (DESIGN.md §6): peer link first when a
        cluster hook is attached and picks a cheaper source, then the CLOUD
        tier (content-addressed ObjectStore, or the legacy CloudStore).

        ``on_shard(row, data)`` (streaming opens, §9) is forwarded to any
        source that can deliver digest-verified shards incrementally —
        the cluster gather and the ObjectStore's sharded fetch. ``ctx``
        (the request's :class:`~repro_torch.core.tenant.RequestContext`) rides
        along to a context-aware cluster hook so the serving peers see the
        same tenant/deadline the local open carries. Sources that predate
        either kwarg (legacy hooks/stores) are called without it; the
        caller then streams from disk after the file lands."""
        if self.disk.contains(key):
            return
        if self.remote_fetch is not None:
            kwargs = {}
            if on_shard is not None and _accepts_kwarg(self.remote_fetch,
                                                       "on_shard"):
                kwargs["on_shard"] = on_shard
            if ctx is not None and _accepts_kwarg(self.remote_fetch, "ctx"):
                kwargs["ctx"] = ctx
            ok = self.remote_fetch(key, timings, **kwargs)
            if ok:
                if timings.tier_hit in ("", "disk"):
                    # the hook may claim a more specific hit ("gather", §8)
                    timings.tier_hit = "peer"
                return
        for store in (self.cloud, self.objectstore):
            if store is None or not store.contains(key):
                continue
            if hasattr(store, "fetch"):  # ObjectStore: compression-aware
                sink: list = []
                kwargs = {"report_out": sink}
                if on_shard is not None and _accepts_kwarg(store.fetch,
                                                           "on_shard"):
                    kwargs["on_shard"] = on_shard
                modeled, _ = store.fetch(key, self.disk, **kwargs)
                report = sink[0] if sink else None
                if report is not None:  # compressed blob: decode pipelined
                    timings.decompress_s += report.stage("decompress").busy_s
                    timings.stage_overlap_s += report.overlap_s()
                    timings.chunks = max(timings.chunks, report.n_chunks)
            else:  # legacy CloudStore
                modeled, _ = store.download(key, self.disk)
            timings.cloud_s = modeled
            timings.tier_hit = "cloud"
            with self._lock:
                self.metrics["cloud_downloads"] += 1
                self.metrics["modeled_fetch_s"] += modeled
            return
        raise FileNotFoundError(f"model {key} not found in any tier")

    # ------------------------------------------------ CLOUD-tier write-back
    def _on_host_remove(self, event: str, entry):
        """Host-cache listener (fires under the host lock — enqueue only).

        A HOST victim whose payload was live is a *demotion to disk*; with
        ``writeback_to_cloud`` the MRM also publishes it to the CLOUD tier
        in the background so peers/cold nodes can fetch it without touching
        this node. Placeholder rollbacks (payload None) are not demotions.
        """
        if event == "remove" and entry.payload is not None:
            with self._wb_lock:
                if not self._wb_shutdown:
                    self._wb_queue.put(entry.key)

    def _writeback_worker(self):
        while True:
            key = self._wb_queue.get()
            if key is _WB_SENTINEL:
                self._wb_queue.task_done()
                return
            try:
                # models are version-keyed and immutable: a key already in
                # the object store needs no re-upload
                if self.disk.contains(key) and not self.objectstore.contains(key):
                    # codec=None means the store's own default
                    self.objectstore.put_file(key, self.disk.path_for(key),
                                              codec=self.cloud_codec)
                    with self._lock:
                        self.metrics["cloud_writebacks"] += 1
            except Exception:  # noqa: BLE001 — write-back stays best-effort,
                with self._lock:  # but failures are no longer invisible
                    self.metrics["cloud_writeback_errors"] += 1
            finally:
                self._wb_queue.task_done()

    def flush_writebacks(self):
        """Block until every queued CLOUD write-back has been processed."""
        if self._wb_queue is not None:
            self._wb_queue.join()

    def shutdown(self, timeout: Optional[float] = 5.0) -> None:
        """Drain and stop the background write-back worker (idempotent).

        New demotions stop enqueueing immediately; everything already
        queued is processed, then the worker exits on a sentinel. Safe to
        call on an MRM that never had write-back enabled."""
        with self._wb_lock:
            self._wb_shutdown = True
            thread, self._wb_thread = self._wb_thread, None
            if thread is not None:
                self._wb_queue.put(_WB_SENTINEL)
        if thread is not None:
            thread.join(timeout)

    def _shm_views(self, key, specs):
        """One segment with tensors packed back-to-back. ``specs`` is
        ``[(name, nbytes, np_dtype, shape)]``; returns (segment, views)
        where views maps name -> (memoryview slice, ndarray aliasing it).
        The single packing-layout authority for loads AND demotions — the
        wire protocol in shm_ipc assumes exactly this sequential layout."""
        from repro_torch.core.shm_ipc import ShmSegment
        seg = ShmSegment.create(key, sum(nb for _, nb, _, _ in specs))
        views = {}
        off = 0
        for name, nb, dtype, shape in specs:
            view = memoryview(seg.buf)[off:off + nb]
            count = int(np.prod(shape)) if shape else 1
            views[name] = (view,
                           np.frombuffer(view, dtype=dtype,
                                         count=count).reshape(shape))
            off += nb
        return seg, views

    def _host_sink(self, mf: ModelFile, key, nbytes: int):
        """(arrays, segments, write(name, raw)) — shm-backed when configured."""
        arrays: Dict[str, np.ndarray] = {}
        segs = []
        if self.use_shm:
            seg, views = self._shm_views(
                key, [(name, tm.nbytes, _np_dtype(tm.dtype), tm.shape)
                      for name, tm in mf.tensors.items()])
            segs = [seg]

            def write(name: str, raw: bytes):
                view, arr = views[name]
                view[: len(raw)] = raw
                arrays[name] = arr
        else:
            def write(name: str, raw: bytes):
                tm = mf.tensors[name]
                arrays[name] = np.frombuffer(
                    raw, dtype=_np_dtype(tm.dtype)).reshape(tm.shape)
        return arrays, segs, write

    def _disk_stages(self, mf: ModelFile, f, write,
                     fut: Optional[LoadFuture] = None):
        """The shared disk_read/deserialize pipeline stages: chunked reads
        through the open handle ``f``, deserialized via the sink's ``write``."""

        def read_chunk(names):
            if fut is not None:
                fut.stage = "disk_read"
            out = []
            for n in names:
                t = mf.tensors[n]
                f.seek(mf.payload_base + t.offset)
                out.append((n, f.read(t.nbytes)))
            return out

        def deser_chunk(items):
            if fut is not None:
                fut.stage = "deserialize"
            for n, raw in items:
                write(n, raw)
            return [n for n, _ in items]

        return ("disk_read", read_chunk), ("deserialize", deser_chunk)

    def _record_staging_models(self, timings, nbytes: int):
        timings.h2d_modeled_s = self.hw.h2d_time(nbytes)
        timings.staging_serial_modeled_s = self.hw.staging_serial_time(nbytes)
        timings.staging_pipelined_modeled_s = self.hw.staging_pipelined_time(
            nbytes, self.staging_chunk_bytes)

    def _maybe_simulate_h2d(self, timings):
        if self.simulate_h2d_time and timings.h2d_measured_s < timings.h2d_modeled_s:
            time.sleep(min(timings.h2d_modeled_s - timings.h2d_measured_s, 0.25))

    def _load_cold_pipelined(self, fut: LoadFuture) -> Optional[ModelHandle]:
        """HOST+DEVICE miss, device wanted: one three-stage chunk pipeline
        (disk read | deserialize | H2D) filling BOTH tiers as chunks flow —
        I/O overlaps deserialization overlaps device staging (DESIGN.md §4).
        """
        key, timings = fut.key, fut.timings
        self._ensure_on_disk(key, timings, ctx=fut.ctx)
        with self._evict_lock:
            self._demoted_keys.discard(key)  # any demoted copy lapsed
        mf = self.disk.open(key)
        nbytes = mf.total_bytes

        # reserve both tiers up front (device first: lock order DEVICE->HOST;
        # placeholders are pinned so another model's eviction pass cannot
        # reap a half-staged entry). Victims demote AFTER the device lock
        # drops — the D2H copy must not stall concurrent opens.
        with self.device.lock:
            evicted = self.tiers.make_room(Tier.DEVICE,
                                           nbytes + fut.activation_bytes)
            d_entry = self.device.insert(key, nbytes, payload=None)
            d_entry.pinned = True
        h_entry = None
        adopted = None
        segs = []
        try:
            # reserve HOST room for the incoming model BEFORE demoting the
            # device victims into it — demoting first would pay the D2H copy
            # for entries this very reservation may immediately evict
            with self.host.lock:
                existing = self.host.peek(key)
                if existing is not None and existing.payload is not None:
                    # a concurrent demotion (of OUR key, evicted by some
                    # other model's load) re-homed it in HOST between the
                    # host-miss check and this reservation. Models are
                    # immutable, so the copy is interchangeable: take a
                    # provisional ref and stage the device tier from it
                    # instead of colliding on the insert
                    existing.refcount += 1
                    adopted = existing
                else:
                    self.tiers.make_room(Tier.HOST, nbytes)
                    h_entry = self.host.insert(key, nbytes, payload=None)
                    h_entry.pinned = True
            demoted = self.tiers.demote_evicted(evicted)
            timings.demote_s = sum(self.hw.d2h_time(v.nbytes) for v in demoted)
            if demoted:
                with self._evict_lock:
                    self._demoted_keys.update(v.key for v in demoted)
            if adopted is not None:
                # hand our device reservation back (stage_device re-reserves
                # atomically) and run the warm HOST -> DEVICE chain
                with self.device.lock:
                    if self.device.peek(key) is d_entry:
                        self.device.remove(key)
                timings.tier_hit = "host"
                try:
                    dev_entry = self._stage_device(
                        key, adopted, fut.activation_bytes, timings, fut)
                finally:
                    with self.host.lock:
                        adopted.refcount -= 1
                return self._finish_entry(fut, self.device, dev_entry,
                                          unpin=True)

            arrays, segs, write = self._host_sink(mf, key, nbytes)
            weights: Dict[str, object] = {}
            chunks = plan_chunks(
                [(t.name, t.nbytes) for t in mf.tensors.values()],
                self.staging_chunk_bytes)

            def put_chunk(names):
                fut.stage = "h2d"
                for n in names:
                    weights[n] = self.device_put_fn(arrays[n])
                synchronize(self.device_name)  # busy time = finished copies
                return names

            with open(mf.path, "rb") as f:
                _, report = run_pipeline(
                    chunks,
                    [*self._disk_stages(mf, f, write, fut),
                     ("h2d", put_chunk)],
                    depth=self.pipeline_depth)
        except BaseException:
            # roll back both reservations or the pinned placeholders brick
            # the key (payload-None entries are treated as misses, but the
            # next loader's insert would collide)
            with self.device.lock:
                if self.device.peek(key) is d_entry:
                    self.device.remove(key)
            if h_entry is not None:
                with self.host.lock:
                    if self.host.peek(key) is h_entry:
                        self.host.remove(key)
            for seg in segs:
                seg.close_and_unlink()
            raise

        timings.disk_read_s = report.stage("disk_read").busy_s
        timings.deserialize_s = report.stage("deserialize").busy_s
        timings.h2d_measured_s = report.stage("h2d").busy_s
        timings.chunks = max(timings.chunks, report.n_chunks)
        timings.stage_overlap_s += report.overlap_s()  # adds to fetch overlap
        self._record_staging_models(timings, nbytes)
        self._maybe_simulate_h2d(timings)

        h_entry.payload = HostModel(arrays, nbytes, segs)
        d_entry.payload = weights
        with self.host.lock:
            h_entry.pinned = False
        with self._lock:
            self.metrics["disk_loads"] += 1
            self.metrics["bytes_from_disk"] += nbytes
            self.metrics["h2d_stages"] += 1
            self.metrics["bytes_h2d"] += nbytes
            self.metrics["pipelined_loads"] += 1
            self.metrics["modeled_stage_s"] += timings.staging_pipelined_modeled_s
        return self._finish_entry(fut, self.device, d_entry, unpin=True)

    def _load_host(self, key, timings, fut: Optional[LoadFuture] = None):
        """Disk/cloud -> host tier only (host-tier opens, or serial mode).

        Returns the entry STILL PINNED; the caller releases the pin once
        the handle refcount (or device staging) no longer needs it."""
        self._ensure_on_disk(key, timings,
                             ctx=fut.ctx if fut is not None else None)
        with self._evict_lock:
            self._demoted_keys.discard(key)  # any demoted copy lapsed
        mf = self.disk.open(key)
        nbytes = mf.total_bytes

        with self.host.lock:
            entry = self.host.peek(key)
            if entry is not None and entry.payload is not None:
                # a concurrent demotion re-homed this key between the
                # host-miss check and this reservation; the copy is
                # interchangeable (models are immutable) — adopt it,
                # pinned exactly as a fresh load would be
                entry.pinned = True
                timings.tier_hit = "host"
                return entry
            self.tiers.make_room(Tier.HOST, nbytes)
            entry = self.host.insert(key, nbytes, payload=None)
            entry.pinned = True

        segs = []
        try:
            arrays, segs, write = self._host_sink(mf, key, nbytes)
            if self.pipelined_staging:
                chunks = plan_chunks(
                    [(t.name, t.nbytes) for t in mf.tensors.values()],
                    self.staging_chunk_bytes)
                with open(mf.path, "rb") as f:
                    _, report = run_pipeline(
                        chunks, list(self._disk_stages(mf, f, write, fut)),
                        depth=self.pipeline_depth)
                timings.disk_read_s = report.stage("disk_read").busy_s
                timings.deserialize_s = report.stage("deserialize").busy_s
                timings.chunks = max(timings.chunks, report.n_chunks)
                timings.stage_overlap_s += report.overlap_s()
                hm = HostModel(arrays, nbytes, segs)
                with self._lock:
                    self.metrics["pipelined_loads"] += 1
            else:
                t0 = time.perf_counter()
                with open(mf.path, "rb") as f:
                    for name, tm in mf.tensors.items():
                        f.seek(mf.payload_base + tm.offset)
                        write(name, f.read(tm.nbytes))
                hm = HostModel(arrays, nbytes, segs)
                dt = time.perf_counter() - t0
                # attribute: raw I/O at measured disk bw, remainder = deserialize
                io_est = self.hw.disk_time(nbytes)
                timings.disk_read_s = min(dt, io_est)
                timings.deserialize_s = max(0.0, dt - timings.disk_read_s)
        except BaseException:
            with self.host.lock:
                if self.host.peek(key) is entry:
                    self.host.remove(key)
            for seg in segs:
                seg.close_and_unlink()
            raise

        entry.payload = hm
        with self._lock:
            self.metrics["disk_loads"] += 1
            self.metrics["bytes_from_disk"] += nbytes
            self.metrics["modeled_stage_s"] += (
                self.hw.disk_time(nbytes) + self.hw.deserialize_time(nbytes))
        return entry

    def _load_host_streaming(self, fut: LoadFuture) -> Optional[ModelHandle]:
        """Cold -> HOST with per-window readiness (DESIGN.md §9).

        Bytes deserialize as they become available instead of after the
        whole file lands: shard callbacks from the wire leg (gather /
        ObjectStore fetch) scatter verified payloads straight into live
        host arrays, and a demand-reorderable disk reader covers whatever
        the wire did not deliver (warm-disk opens, legacy sources, the
        tail of a partially-streamed fetch). Window readiness fires in
        execution order through ``fut.wait_prefix``.

        Components-filtered loads are private: they bypass the host cache
        (cached entries must always hold the full tensor set) and return a
        handle that owns its arrays outright.
        """
        from repro_torch.core.layerplan import StreamAssembler

        key, timings = fut.key, fut.timings
        private = fut.components is not None

        # size the reservation before bytes move; gather-only sources
        # (remote hook, size unknown here) defer it to header-parse time
        est = 0
        if self.disk.contains(key):
            est = self.disk.open(key).total_bytes
        elif self.objectstore is not None and self.objectstore.contains(key):
            est = int(self.objectstore.nbytes(key))
        elif not (self.remote_fetch is not None
                  and _accepts_kwarg(self.remote_fetch, "on_shard")):
            # no incremental wire source at all: land the file first and
            # stream only the deserialize leg
            self._ensure_on_disk(key, timings, ctx=fut.ctx)
            est = self.disk.open(key).total_bytes

        state = {"entry": None, "adopted": None}

        def reserve(nb):
            # mirrors _load_host's reservation: adoption check + pinned
            # placeholder under one cache lock, so concurrent eviction
            # passes can neither reap the in-flight entry nor double-home
            # the key
            with self.host.lock:
                e = self.host.peek(key)
                if e is not None and e.payload is not None:
                    e.pinned = True
                    state["adopted"] = e
                    return
                self.tiers.make_room(Tier.HOST, nb)
                entry = self.host.insert(key, nb, payload=None)
                entry.pinned = True
                state["entry"] = entry

        if not private and est:
            reserve(est)
            if state["adopted"] is not None:
                # a concurrent demotion re-homed the key: warm hit, nothing
                # to stream (plan stays None -> wait_prefix releases when
                # the future completes)
                timings.tier_hit = "host"
                return self._finish_entry(fut, self.host, state["adopted"],
                                          unpin=True)

        def on_plan(plan, arrays, meta):
            fut._set_plan(plan, arrays, meta)
            if not private and state["entry"] is None \
                    and state["adopted"] is None:
                reserve(sum(int(a.nbytes) for a in arrays.values()))

        def on_window(w):
            fut.stage = "deserialize"
            fut._mark_window(w.index)

        asm = StreamAssembler(on_plan, on_window, components=fut.components)
        try:
            fut.stage = "disk_read"
            self._ensure_on_disk(key, timings, on_shard=asm.feed_shard,
                                 ctx=fut.ctx)
            with self._evict_lock:
                self._demoted_keys.discard(key)  # any demoted copy lapsed
            mf = self.disk.open(key)
            asm.ensure_plan_from_file(mf)
            self._stream_windows_from_disk(mf, asm, fut)
            missing = [w.index for w in fut.plan
                       if asm.included(w) and not asm.window_complete(w.index)]
            if missing:
                raise IOError(f"streaming load of {key} left windows "
                              f"{missing} incomplete")
        except BaseException:
            with self.host.lock:
                entry = state["entry"]
                if entry is not None and self.host.peek(key) is entry:
                    self.host.remove(key)
            raise
        timings.deserialize_s += asm.scatter_s
        nbytes = sum(int(a.nbytes) for a in asm.arrays.values())
        with self._lock:
            self.metrics["disk_loads"] += 1
            self.metrics["stream_loads"] += 1
            self.metrics["bytes_from_disk"] += nbytes
            self.metrics["modeled_stage_s"] += (
                self.hw.disk_time(nbytes) + self.hw.deserialize_time(nbytes))
            if private:
                self.metrics["partial_loads"] += 1

        if private:
            if not fut.want_handle:
                timings.total_s = time.perf_counter() - fut._t_start
                return None
            timings.total_s = time.perf_counter() - fut._t_start
            h = ModelHandle(next(self._hid), key, dict(asm.arrays), nbytes,
                            timings, fut.granularity, tier="host",
                            private=True)
            with self._lock:
                self._handles[h.handle_id] = h
            return h

        adopted = state["adopted"]
        if adopted is not None:
            # deferred reservation lost to a concurrent re-homing: the
            # cached copy wins; our streamed arrays still back fut.arrays
            return self._finish_entry(fut, self.host, adopted, unpin=True)
        entry = state["entry"]
        entry.payload = HostModel(asm.arrays, nbytes, [])
        return self._finish_entry(fut, self.host, entry, unpin=True)

    def _stream_windows_from_disk(self, mf, asm, fut: LoadFuture) -> None:
        """Read the windows the wire leg did not deliver, in plan order,
        with ``fut.demand(i)`` jumping demanded windows to the queue head
        (the on-demand MoE-expert path)."""
        demand_lock = threading.Lock()
        demanded: deque = deque()
        pending = {w.index for w in asm.plan
                   if asm.included(w) and not asm.window_complete(w.index)}

        def demand(index: int) -> bool:
            with demand_lock:
                if index not in pending:
                    return False
                demanded.append(index)
                return True

        fut._demand = demand
        queue = deque(sorted(pending))
        by_index = {w.index: w for w in asm.plan}
        try:
            with open(mf.path, "rb") as f:
                while True:
                    with demand_lock:
                        if demanded:
                            idx = demanded.popleft()
                            if idx not in pending:
                                continue
                        else:
                            idx = None
                            while queue:
                                cand = queue.popleft()
                                if cand in pending:
                                    idx = cand
                                    break
                            if idx is None:
                                break
                        pending.discard(idx)
                    w = by_index[idx]
                    for off, n in w.ranges:
                        t0 = time.perf_counter()
                        f.seek(off)
                        data = f.read(n)
                        fut.timings.disk_read_s += time.perf_counter() - t0
                        asm.feed(off, data)
        finally:
            fut._demand = None

    def _stage_device(self, key, host_entry, activation_bytes, timings,
                      fut: Optional[LoadFuture] = None):
        """HOST hit -> device: chunked H2D (double-buffered when pipelined)."""
        nbytes = host_entry.nbytes
        need = nbytes + activation_bytes
        # reserve capacity atomically (make_room + insert under one lock):
        # concurrent stages of DIFFERENT models must not steal each other's
        # freed room between eviction and insertion; victims demote to HOST
        # after the lock drops (D2H copy must not stall other opens)
        with self.device.lock:
            evicted = self.tiers.make_room(Tier.DEVICE, need)
            entry = self.device.insert(key, nbytes, payload=None)
            entry.pinned = True

        hm: HostModel = host_entry.payload
        weights: Dict[str, object] = {}
        try:
            demoted = self.tiers.demote_evicted(evicted)
            timings.demote_s = sum(self.hw.d2h_time(v.nbytes) for v in demoted)
            if demoted:
                with self._evict_lock:
                    self._demoted_keys.update(v.key for v in demoted)
            if self.pipelined_staging:
                chunks = plan_chunks([(n, a.nbytes) for n, a in hm.arrays.items()],
                                     self.staging_chunk_bytes)

                def prep_chunk(names):
                    return [(n, hm.arrays[n]) for n in names]

                def put_chunk(items):
                    if fut is not None:
                        fut.stage = "h2d"
                    for n, a in items:
                        weights[n] = self.device_put_fn(a)
                    synchronize(self.device_name)  # busy time = finished copies
                    return [n for n, _ in items]

                _, report = run_pipeline(chunks, [("host_prep", prep_chunk),
                                                  ("h2d", put_chunk)],
                                         depth=self.pipeline_depth)
                timings.h2d_measured_s = report.stage("h2d").busy_s
                timings.chunks = max(timings.chunks, report.n_chunks)
                timings.stage_overlap_s += report.overlap_s()
            else:
                t0 = time.perf_counter()
                for n, a in hm.arrays.items():
                    weights[n] = self.device_put_fn(a)
                synchronize(self.device_name)
                timings.h2d_measured_s = time.perf_counter() - t0
        except BaseException:
            with self.device.lock:
                if self.device.peek(key) is entry:
                    self.device.remove(key)
            raise
        self._record_staging_models(timings, nbytes)
        self._maybe_simulate_h2d(timings)
        with self._lock:
            self.metrics["h2d_stages"] += 1
            self.metrics["bytes_h2d"] += nbytes
            self.metrics["modeled_stage_s"] += timings.h2d_modeled_s
        entry.payload = weights
        # still pinned: _finish_entry releases the pin atomically with the
        # handle refcount (or leaves a prefetch entry unpinned+evictable)
        return entry

    def _demote_device_payload(self, victim) -> Optional[HostModel]:
        """Eviction-as-demotion D2H: device arrays -> a HOST-tier payload.

        Called by the TierHierarchy with NO cache locks held (the copy must
        not stall other tier operations), so host-tier state may change
        during the copy — _demote re-checks residency/room before inserting.
        Returns None to drop the victim instead. bf16 tensors land as
        tagged uint16 bits. In shm mode each tensor is copied from the
        device straight into its view of the segment (one D2H copy, no
        intermediate host array); otherwise ``.cpu()`` makes the copy."""
        if not self.use_shm:
            arrays = {n: tensor_to_numpy(a) for n, a in victim.payload.items()}
            return HostModel(arrays, victim.nbytes, [])
        tensors = victim.payload
        seg, views = self._shm_views(
            victim.key, [(n, t.numel() * t.element_size(), numpy_dtype(t.dtype),
                          tuple(t.shape)) for n, t in tensors.items()])
        arrays = {n: tensor_into_numpy(t, views[n][1]) for n, t in tensors.items()}
        return HostModel(arrays, victim.nbytes, [seg])

    # ----------------------------------------------------------- inspection
    def resolvable(self, key: ModelKey) -> bool:
        """Whether some tier this MRM can reach directly (DISK or CLOUD)
        holds ``key`` — cluster peers are the ClusterNode's business."""
        key = ModelKey(*key)
        return (self.disk.contains(key)
                or (self.cloud is not None and self.cloud.contains(key))
                or (self.objectstore is not None
                    and self.objectstore.contains(key)))

    def resident(self, key: ModelKey, tier: Tier) -> bool:
        key = ModelKey(*key)
        cache = self.device if tier == Tier.DEVICE else self.host
        return cache.peek(key) is not None

    def refcount(self, key: ModelKey) -> int:
        e = self.device.peek(ModelKey(*key))
        return 0 if e is None else e.refcount
