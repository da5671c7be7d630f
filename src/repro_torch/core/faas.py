"""FaaS platform with container isolation (paper §3, §4.3).

Users deploy *functions* (arbitrary Python callables over a context object);
the platform provisions each into a :class:`Container` — an isolation context
with its own namespace token, capability-scoped handle table and resource
accounting. Functions reach models ONLY through ``ctx.load_model`` /
``ctx.predict``; handles are container-scoped, so one tenant can never reach
another tenant's handle (the paper's Docker-volume-plugin boundary, moved to
the runtime layer per DESIGN.md §2).

Multi-node (paper §4.2): :class:`Router` load-balances invocations across
several platforms, dispatching to the node holding the request's models at
the *warmest* tier (DESIGN.md §6) and issuing prefetch hints to the chosen
node; platforms backed by a ``core.cluster.ClusterNode`` additionally
resolve disk-cold models from peers or the CLOUD object store.

PyTorch port: weights land on the platform's ``device`` (the MRM's device
by default; CUDA when there is no MRM), through the MRM's device tier or,
for containers without TrIMS, through ``cold_load``'s torch device put.
"""
from __future__ import annotations

import itertools
import math
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cache import Tier
from repro_torch.core.client import LoadedModel, TrimsClient, cold_load, free_model
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.tenant import AdmissionError, RequestContext


class IsolationError(PermissionError):
    pass


class LatencyStats:
    """Bounded per-invoke latency accounting: streaming count/sum/min/max
    plus a fixed-size uniform reservoir for quantiles.

    Replaces the old unbounded ``List[float]`` (one float per invocation
    forever — a leak under sustained traffic). The first ``reservoir_size``
    samples are stored in arrival order, so early-request indexing
    (``latencies[0]`` cold vs ``latencies[1]`` warm) keeps working; beyond
    that, reservoir sampling keeps a uniform sample of the whole stream.
    Not internally locked — callers mutate under the container lock.
    """

    __slots__ = ("count", "total_s", "min_s", "max_s", "_sample", "_k", "_rng")

    def __init__(self, reservoir_size: int = 1024, seed: int = 0):
        self.count = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0
        self._sample: List[float] = []
        self._k = reservoir_size
        self._rng = random.Random(seed)

    def append(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        if len(self._sample) < self._k:
            self._sample.append(dt)
        else:  # reservoir: element i survives with probability k/i
            j = self._rng.randrange(self.count)
            if j < self._k:
                self._sample[j] = dt

    record = append  # preferred name; append keeps list-API compatibility

    def mean(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Empirical quantile (0..1) over the reservoir sample."""
        if not self._sample:
            return 0.0
        s = sorted(self._sample)
        return s[min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))]

    def __len__(self) -> int:
        return len(self._sample)

    def __getitem__(self, i):
        return self._sample[i]

    def __iter__(self):
        return iter(self._sample)


@dataclass
class Accounting:
    invocations: int = 0
    total_s: float = 0.0
    model_load_s: float = 0.0
    compute_s: float = 0.0
    bytes_loaded: int = 0
    cold_starts: int = 0
    latencies: LatencyStats = field(default_factory=LatencyStats)
    # SLO accounting: invocations that carried a deadline, how many blew
    # it, and the summed signed slack (deadline - latency; negative=late)
    slo_invocations: int = 0
    slo_violations: int = 0
    slo_slack_s: float = 0.0


class Container:
    """Isolation context for one deployed function."""

    _ids = itertools.count(1)

    def __init__(self, platform: "FaaSPlatform", fn_name: str,
                 allowed_models: Optional[Sequence[Tuple[str, str]]] = None,
                 use_trims: bool = True):
        self.cid = f"c{next(self._ids)}"
        self.platform = platform
        self.fn_name = fn_name
        self.allowed = set(allowed_models) if allowed_models is not None else None
        self.use_trims = use_trims
        self.acct = Accounting()
        self._models: Dict[ModelKey, LoadedModel] = {}
        self._trims = (TrimsClient(platform.mrm, client_id=self.cid)
                       if platform.mrm is not None and use_trims else None)
        self._lock = threading.RLock()
        # the invoking request's RequestContext, set by FaaSPlatform.invoke
        # for the duration of the function body (thread-local: concurrent
        # invokes of one container each see their own context)
        self._ctx_tls = threading.local()

    @property
    def current_ctx(self) -> Optional[RequestContext]:
        """The RequestContext of the request this thread is serving."""
        return getattr(self._ctx_tls, "ctx", None)

    # -- the API surface user functions see --------------------------------
    def load_model(self, framework: str, name: str, version: str = "1",
                   ctx: Optional[RequestContext] = None) -> LoadedModel:
        key = ModelKey(framework, name, version)
        if self.allowed is not None and (framework, name) not in self.allowed:
            raise IsolationError(
                f"{self.cid}: function {self.fn_name!r} is not entitled to {key}")
        if ctx is None:
            ctx = self.current_ctx  # the invoking request's context
        with self._lock:
            if key in self._models:
                return self._models[key]
            t0 = time.perf_counter()
            if self._trims is not None:
                h = self._trims.open(framework, name, version, ctx=ctx)
                m = LoadedModel(key, h.weights, h.nbytes, h.timings,
                                via_trims=True, handle=h)
            else:
                self.acct.cold_starts += 1
                m = cold_load(self.platform.disk, key,
                              objectstore=self.platform.objectstore,
                              device=self.platform.device)
            self.acct.model_load_s += time.perf_counter() - t0
            self.acct.bytes_loaded += m.nbytes
            self._models[key] = m
            return m

    def prefetch_models(self, models: Sequence[Tuple[str, ...]],
                        ctx: Optional[RequestContext] = None) -> list:
        """Warm entitled models toward the device tier without taking refs.

        Non-entitled or missing models are skipped (a warm-up hint must
        never fail a deploy). Returns the LoadFutures issued."""
        if self._trims is None:
            return []
        futs = []
        for m in models:
            fw, name = m[0], m[1]
            version = m[2] if len(m) > 2 else "1"
            if self.allowed is not None and (fw, name) not in self.allowed:
                continue
            if not self.platform.can_resolve(ModelKey(fw, name, version)):
                continue
            futs.append(self._trims.prefetch(fw, name, version, ctx=ctx))
        return futs

    def unload_model(self, m: LoadedModel):
        with self._lock:
            self._models.pop(m.key, None)
        free_model(m, self._trims)

    def teardown(self):
        with self._lock:
            models = list(self._models.values())
            self._models = {}
        for m in models:
            free_model(m, self._trims)
        if self._trims is not None:
            self._trims.close_all()

    # handles must not cross containers: expose an opaque check the platform
    # uses when functions exchange data
    def owns(self, m: LoadedModel) -> bool:
        return m.key in self._models


@dataclass
class FunctionSpec:
    name: str
    fn: Callable[["Container", Any], Any]
    allowed_models: Optional[Sequence[Tuple[str, str]]] = None


class FaaSPlatform:
    """One node: containers + (optionally) a TrIMS MRM."""

    def __init__(self, mrm: Optional[MRM], disk=None, name: str = "node0",
                 cluster_node=None, objectstore=None, tenants=None,
                 device=None):
        self.mrm = mrm
        # where cold (un-TrIMSed) loads put their weights: ``device`` when
        # given, else the MRM's device, else CUDA
        if device is None:
            device = mrm.device_name if mrm is not None else "cuda"
        self.device = device
        self.disk = disk if disk is not None else (mrm.disk if mrm else None)
        # CLOUD tier for the no-MRM baseline path (four-tier parity: an
        # un-TrIMSed cold load downloads from here on every DISK miss);
        # TrIMS platforms inherit the MRM's store
        self.objectstore = objectstore if objectstore is not None \
            else (mrm.objectstore if mrm else None)
        self.name = name
        # optional core.cluster.ClusterNode backing this platform — set when
        # the node participates in cluster-wide sharing (DESIGN.md §6)
        self.cluster_node = cluster_node
        # multi-tenant isolation (DESIGN.md §12): a TenantRegistry attaches
        # to the MRM (quota accounting + fair-share eviction weights) and
        # arms invoke-time admission control; None = single-tenant behavior
        self.tenants = tenants
        if tenants is not None and mrm is not None and mrm.tenants is not tenants:
            tenants.attach(mrm)
        self.functions: Dict[str, FunctionSpec] = {}
        self.containers: Dict[str, Container] = {}
        # per-tenant SLO accounting, keyed by RequestContext.tenant —
        # mutated under _acct_lock (a leaf lock; never hold it while
        # calling into the MRM or a container)
        self.tenant_acct: Dict[str, Accounting] = {}
        self._acct_lock = threading.Lock()
        self._lock = threading.RLock()

    def deploy(self, name: str, fn: Callable, allowed_models=None,
               use_trims: bool = True, prewarm: bool = True) -> Container:
        """Provision a function. With ``prewarm`` the platform prefetches the
        function's declared models at deploy time — the platform, not the
        tenant, owns load scheduling, so the first invocation finds its
        weights already staged (or staging) instead of paying a cold chain."""
        spec = FunctionSpec(name, fn, allowed_models)
        with self._lock:
            self.functions[name] = spec
            c = Container(self, name, allowed_models, use_trims=use_trims)
            self.containers[name] = c
        if prewarm and allowed_models:
            c.prefetch_models(allowed_models)
        return c

    def can_resolve(self, key: ModelKey) -> bool:
        """Whether this node can materialize ``key`` from ANY source: local
        disk, the CLOUD tier, or (when clustered) a peer node's copy."""
        key = ModelKey(*key)
        if self.mrm is None:
            return ((self.disk is not None and self.disk.contains(key))
                    or (self.objectstore is not None
                        and self.objectstore.contains(key)))
        if self.mrm.resolvable(key):
            return True
        return (self.cluster_node is not None
                and self.cluster_node.directory.warmest(
                    key, exclude=self.cluster_node.name) is not None)

    def prefetch_models(self, keys: Sequence[ModelKey],
                        ctx: Optional[RequestContext] = None) -> list:
        """Node-level warm-up (router pre-dispatch hint)."""
        if self.mrm is None:
            return []
        return [self.mrm.prefetch(ModelKey(*k), ctx=ctx) for k in keys
                if self.can_resolve(k)]

    def undeploy(self, name: str):
        with self._lock:
            c = self.containers.pop(name, None)
            self.functions.pop(name, None)
        if c is not None:
            c.teardown()

    def _tier_frac(self, cache) -> float:
        with cache.lock:
            return cache.used / cache.capacity if cache.capacity else 1.0

    def invoke(self, name: str, payload: Any = None,
               deadline_s: Optional[float] = None,
               ctx: Optional[RequestContext] = None) -> Any:
        """Run one request under an optional :class:`RequestContext`.

        ``ctx`` carries tenant/SLO class/deadline/priority; the legacy
        ``deadline_s=`` keyword still works and wraps into a
        default-tenant context (validated once, at the context boundary).
        The deadline seeds the MRM's eviction-policy horizon before the
        function runs (DESIGN.md §7) and is scored against the measured
        latency afterwards, into BOTH the container's and the tenant's
        accounting. With a :class:`~repro_torch.core.tenant.TenantRegistry`
        attached, batch-class work is admission-checked first and an
        :class:`AdmissionError` (action ``"shed"`` or ``"queue"``) is
        raised instead of running the function. The context is visible to
        the function body via ``container.current_ctx`` and flows into
        every ``load_model`` it performs."""
        ctx = RequestContext.coerce(ctx, deadline_s)
        deadline = ctx.deadline_s if ctx is not None else None
        with self._lock:
            spec = self.functions.get(name)
            c = self.containers.get(name)
        if spec is None or c is None:
            raise KeyError(f"function {name!r} not deployed")
        if self.tenants is not None and ctx is not None:
            device_frac = (self._tier_frac(self.mrm.device)
                           if self.mrm is not None else 0.0)
            host_frac = (self._tier_frac(self.mrm.host)
                         if self.mrm is not None else 0.0)
            verdict = self.tenants.admit(ctx, device_frac, host_frac)
            if verdict != "admit":
                raise AdmissionError(verdict, ctx, "tiers under pressure")
        if deadline is not None and self.mrm is not None:
            self.mrm.note_deadline(deadline)
        prev = getattr(c._ctx_tls, "ctx", None)
        c._ctx_tls.ctx = ctx
        t0 = time.perf_counter()
        try:
            out = spec.fn(c, payload)
        finally:
            c._ctx_tls.ctx = prev
        dt = time.perf_counter() - t0
        # accounting mutates under the container lock: concurrent invokes
        # of one function must not lose updates (read-modify-write races)
        with c._lock:
            c.acct.invocations += 1
            c.acct.total_s += dt
            c.acct.latencies.append(dt)
            if deadline is not None:
                c.acct.slo_invocations += 1
                c.acct.slo_slack_s += deadline - dt
                if dt > deadline:
                    c.acct.slo_violations += 1
        if ctx is not None:
            with self._acct_lock:
                ta = self.tenant_acct.setdefault(ctx.tenant, Accounting())
                ta.invocations += 1
                ta.total_s += dt
                ta.latencies.append(dt)
                if deadline is not None:
                    ta.slo_invocations += 1
                    ta.slo_slack_s += deadline - dt
                    if dt > deadline:
                        ta.slo_violations += 1
        return out

    def invoke_pipeline(self, names: Sequence[str], payload: Any = None) -> Any:
        """Chained functions — the paper's image->scene-description pipeline."""
        for n in names:
            payload = self.invoke(n, payload)
        return payload

    def advertised_models(self) -> List[ModelKey]:
        """Models currently warm on this node (paper §4.2 multi-node)."""
        if self.mrm is None:
            return []
        with self.mrm.device.lock:
            return list(self.mrm.device.entries.keys())

    def residency(self, key: ModelKey) -> float:
        """Graded residency score for routing (DESIGN.md §8): the
        ``Tier.warmth`` rank of a full local copy, else — for sharded
        models — the fraction of shard bytes held in this node's local
        shard cache, weighted at DISK warmth. A node holding 60% of a
        model's shards scores 0.6 against a full-disk node's 1.0 and an
        empty node's 0.0, so the router steers a gather toward the node
        that has the least left to fetch instead of treating residency as
        a boolean."""
        key = ModelKey(*key)
        w = self.warmth(key)
        if w > 0:
            return float(w)
        if self.cluster_node is None:
            return 0.0
        return Tier.DISK.warmth * self.cluster_node.shard_fraction(key)

    def warmth(self, key: ModelKey) -> int:
        """``Tier.warmth`` rank of the warmest tier holding ``key`` here:
        DEVICE=3, HOST=2, DISK=1, absent (CLOUD-only)=0. An entry whose
        staging is still in flight counts — the router should keep sending
        requests for that model to the node already paying for it."""
        if self.mrm is None:
            return (Tier.DISK.warmth
                    if self.disk is not None and self.disk.contains(ModelKey(*key))
                    else 0)
        key = ModelKey(*key)
        if self.mrm.device.peek(key) is not None:
            return Tier.DEVICE.warmth
        if self.mrm.host.peek(key) is not None:
            return Tier.HOST.warmth
        return Tier.DISK.warmth if self.mrm.disk.contains(key) else 0

    def _model_nbytes(self, key: ModelKey) -> int:
        """Best-effort size of ``key`` from the warmest source that knows
        it (tier entry, local file, CLOUD manifest); 0 when nobody does."""
        if self.mrm is not None:
            for cache in (self.mrm.device, self.mrm.host):
                e = cache.peek(key)
                if e is not None:
                    return e.nbytes
        disk = self.disk
        if disk is not None and disk.contains(key):
            try:
                return os.path.getsize(disk.path_for(key))
            except OSError:
                pass
        obj = self.objectstore
        if obj is not None and hasattr(obj, "stat"):
            st = obj.stat(key)
            if st:
                return st.get("nbytes", 0)
        return 0

    def estimated_ready_s(self, keys: Sequence[ModelKey]) -> float:
        """Modeled seconds until every model in ``keys`` could be
        DEVICE-resident here, priced from each one's current warmest tier
        (0 for device hits, H2D for host, the pipelined staging chain for
        disk, cloud fetch on top for absent). The router's deadline-slack
        signal: a node's slack on a request is ``deadline - this``."""
        if self.mrm is None:
            return 0.0
        hw = self.mrm.hw
        total = 0.0
        for k in keys:
            key = ModelKey(*k)
            w = self.warmth(key)
            if w >= Tier.DEVICE.warmth:
                continue
            nbytes = self._model_nbytes(key)
            if w == Tier.HOST.warmth:
                total += hw.h2d_time(nbytes)
            elif w == Tier.DISK.warmth:
                total += hw.staging_pipelined_time(nbytes)
            else:
                total += (hw.cloud_fetch_time(nbytes)
                          + hw.staging_pipelined_time(nbytes))
        return total

    def load(self) -> int:
        return sum(c.acct.invocations for c in self.containers.values())


class Router:
    """Model-affinity load balancer over several FaaS nodes.

    ``policy="affinity"`` (default) dispatches to the node holding the
    request's models at the warmest tier — a device-warm node beats a
    host-warm node beats a disk-cold one, and partial residency counts:
    a node holding a fraction of a sharded model's bytes scores that
    fraction of DISK warmth (``FaaSPlatform.residency``, DESIGN.md §8) —
    falling back to least-loaded on ties, and issues prefetch hints to
    the chosen node so staging overlaps dispatch. A request carrying ``deadline_s`` breaks affinity ties by
    *deadline slack* instead: among equally-warm nodes, the one whose
    modeled time-to-model-ready (``estimated_ready_s``) leaves the most
    slack before the deadline wins. ``policy="round_robin"`` is the
    affinity-blind baseline the cluster benchmark ablates against.

    Dispatch bookkeeping is guarded by an internal lock — concurrent
    ``invoke`` calls from many client threads must not lose counts.
    """

    def __init__(self, nodes: Sequence[FaaSPlatform], policy: str = "affinity"):
        if policy not in ("affinity", "round_robin"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.nodes = list(nodes)
        self.policy = policy
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self.dispatches: Dict[str, int] = {n.name: 0 for n in self.nodes}

    def route(self, fn_name: str, needed_models: Sequence[ModelKey] = (),
              deadline_s: Optional[float] = None,
              ctx: Optional[RequestContext] = None) -> FaaSPlatform:
        ctx = RequestContext.coerce(ctx, deadline_s)
        deadline_s = ctx.deadline_s if ctx is not None else None
        candidates = [n for n in self.nodes if fn_name in n.functions]
        if not candidates:
            raise KeyError(f"function {fn_name!r} not deployed on any node")
        if self.policy == "round_robin":
            return candidates[next(self._rr) % len(candidates)]

        def score(node: FaaSPlatform):
            # graded partial residency (§8), not boolean can-resolve: a
            # node holding most of a sharded model's bytes outranks an
            # empty one even though neither has a full copy
            affinity = sum(node.residency(ModelKey(*k))
                           for k in needed_models)
            if deadline_s is not None:
                # slack = deadline - estimated_ready; the deadline is the
                # same for every candidate, so ranking by smallest modeled
                # ready time IS ranking by largest slack
                return (-affinity, node.estimated_ready_s(needed_models),
                        node.load())
            return (-affinity, node.load())

        return min(candidates, key=score)

    def invoke(self, fn_name: str, payload=None, needed_models=(),
               deadline_s: Optional[float] = None,
               ctx: Optional[RequestContext] = None):
        """Route, issue prefetch for the needed models on the chosen node,
        then dispatch — staging overlaps the dispatch/queueing latency.
        The request's context (or the legacy bare ``deadline_s``, which
        wraps into one) flows into routing (slack tie-break), the prefetch
        hint's tenant attribution, and the node's SLO accounting."""
        ctx = RequestContext.coerce(ctx, deadline_s)
        node = self.route(fn_name, needed_models, ctx=ctx)
        with self._lock:
            self.dispatches[node.name] = self.dispatches.get(node.name, 0) + 1
        if needed_models:
            node.prefetch_models(needed_models, ctx=ctx)
        return node.invoke(fn_name, payload, ctx=ctx)
