"""Multi-tenant isolation: request context, quotas, admission (DESIGN.md §12).

The FaaS setting is inherently multi-tenant — TrIMS shares one model store
across mutually untrusting functions (paper §III) — yet the tiers alone
cannot tell a latency-critical tenant's hot set from a batch scanner's
one-shot sweep. This module supplies the two halves the sharing layer
needs:

  * :class:`RequestContext` — who is asking and how urgently (tenant id,
    SLO class, deadline, priority). It is the *single* validation boundary
    for deadlines: every layer below (``SLOState.note_deadline``, the MRM,
    the FaaS invoke path) trusts a context it receives and no longer
    re-guards. The context is optional everywhere — legacy callers that
    never build one see byte-identical behavior.
  * :class:`TenantRegistry` — per-tenant byte accounting over the shared
    DEVICE/HOST tiers (maintained by cache residency listeners), explicit
    byte quotas plus share-based fair splits, eviction weights that make
    an over-quota tenant's bytes the preferred victims, and admission
    control that sheds or queues batch-class work under pressure.

Lock order: the registry lock is a *leaf* (DESIGN.md §6) — residency
listeners fire under a tier-cache lock and only ever take the registry
lock below it; registry methods never touch a cache lock.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, Hashable, Optional, Tuple

SLO_CLASSES = ("critical", "batch")
DEFAULT_TENANT = "default"

# eviction weight = 1 + OVERAGE_WEIGHT_K * share-overage: a tenant at 2x its
# fair share has its entries score 1/(1+k) as valuable, so the policy drains
# the overage first without ever hard-excluding an under-quota tenant
OVERAGE_WEIGHT_K = 4.0

# admission treats a tier as "under pressure" above this used fraction
PRESSURE_FRAC = 0.95

# attribution map bound: key->tenant entries beyond this are pruned oldest
# first (attribution then falls back to DEFAULT_TENANT, which only softens
# fairness, never breaks accounting)
_KEY_TENANT_CAP = 65536


def _valid_deadline(deadline_s) -> Optional[float]:
    """Normalize a deadline: None passes through, anything else must be a
    positive finite number of seconds. This is THE deadline guard: no other
    module re-checks deadlines."""
    if deadline_s is None:
        return None
    d = float(deadline_s)
    if not math.isfinite(d) or d <= 0:
        raise ValueError(f"deadline_s must be positive and finite, got {deadline_s!r}")
    return d


@dataclass(frozen=True)
class RequestContext:
    """Who is asking, and how urgently — carried through every layer.

    Flows ``TrimsClient`` -> shm_ipc wire frames -> ``Container``/
    ``FaaSPlatform`` -> ``Router`` -> ``MRM.open_async/open_stream`` ->
    eviction -> ``ClusterNode`` gather and transport RPC metadata, so a
    remote daemon serving a shard sees the same tenant/deadline the local
    open carries. Optional everywhere: ``ctx=None`` means anonymous
    default-tenant traffic with no deadline, exactly the pre-context
    behavior.
    """
    tenant: str = DEFAULT_TENANT
    slo_class: str = "critical"
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError(f"tenant must be a non-empty string, got {self.tenant!r}")
        if self.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"slo_class must be one of {SLO_CLASSES}, got {self.slo_class!r}")
        object.__setattr__(self, "deadline_s", _valid_deadline(self.deadline_s))
        object.__setattr__(self, "priority", int(self.priority))

    # -- wire form (msgpack-safe plain dict) --------------------------------
    def to_wire(self) -> dict:
        d = {"tenant": self.tenant, "slo_class": self.slo_class,
             "priority": self.priority}
        if self.deadline_s is not None:
            d["deadline_s"] = self.deadline_s
        return d

    @classmethod
    def from_wire(cls, d) -> Optional["RequestContext"]:
        """Parse an optional wire dict; ``None``/missing -> ``None``.
        Unknown keys are ignored so old daemons interoperate with new
        clients and vice versa."""
        if d is None:
            return None
        return cls(tenant=d.get("tenant", DEFAULT_TENANT),
                   slo_class=d.get("slo_class", "critical"),
                   deadline_s=d.get("deadline_s"),
                   priority=d.get("priority", 0))

    @classmethod
    def coerce(cls, ctx: Optional["RequestContext"] = None,
               deadline_s: Optional[float] = None) -> Optional["RequestContext"]:
        """Back-compat bridge for the legacy ``deadline_s=`` keyword.

        An explicit context wins; a bare deadline wraps into a
        default-tenant context; both ``None`` stays ``None``. Validation
        happens here (via the constructor), once.
        """
        if ctx is not None:
            if not isinstance(ctx, cls):
                raise TypeError(f"ctx must be a RequestContext, got {type(ctx).__name__}")
            return ctx
        if deadline_s is not None:
            return cls(deadline_s=deadline_s)
        return None


class AdmissionError(RuntimeError):
    """Raised by ``FaaSPlatform.invoke`` when admission control refuses a
    request. ``action`` is ``"shed"`` (drop it) or ``"queue"`` (retry
    later — the caller owns the retry clock)."""

    def __init__(self, action: str, ctx: RequestContext, reason: str = ""):
        super().__init__(f"{action}: {reason or 'admission control'} "
                         f"(tenant={ctx.tenant}, class={ctx.slo_class})")
        self.action = action
        self.ctx = ctx


@dataclass
class TenantQuota:
    """Per-tenant limits. ``device_bytes``/``host_bytes`` are hard caps for
    admission (None = uncapped); ``share`` is the weight used for the
    fair-share split that drives eviction weighting."""
    device_bytes: Optional[int] = None
    host_bytes: Optional[int] = None
    share: float = 1.0


@dataclass
class _TenantCounters:
    admitted: int = 0
    queued: int = 0
    shed: int = 0
    degraded: int = 0


class TenantRegistry:
    """Fair-share byte accounting + admission over one MRM's tiers.

    ``attach(mrm)`` subscribes residency listeners on the DEVICE and HOST
    caches (so usage tracks inserts/evictions/demotions exactly, including
    loads the registry never saw an open for — those charge to the default
    tenant) and wires :class:`~repro_torch.core.cache.CostAware` eviction weights
    so an over-share tenant's entries are drained first.
    """

    def __init__(self, overage_weight_k: float = OVERAGE_WEIGHT_K,
                 pressure_frac: float = PRESSURE_FRAC):
        self.overage_weight_k = float(overage_weight_k)
        self.pressure_frac = float(pressure_frac)
        self._lock = threading.Lock()  # leaf lock: safe under any cache lock
        self.quotas: Dict[str, TenantQuota] = {}
        self._usage: Dict[Tuple[str, str], int] = {}   # (tier, tenant) -> bytes
        self._key_tenant: Dict[Hashable, str] = {}
        self._counters: Dict[str, _TenantCounters] = {}
        self._capacity: Dict[str, int] = {}            # tier -> bytes
        self._attached = []

    # -- configuration ------------------------------------------------------
    def set_quota(self, tenant: str, quota: Optional[TenantQuota] = None,
                  **kw) -> TenantQuota:
        q = quota if quota is not None else TenantQuota(**kw)
        with self._lock:
            self.quotas[tenant] = q
        return q

    # -- attribution --------------------------------------------------------
    def note_open(self, key: Hashable, tenant: str) -> None:
        """Record which tenant asked for ``key`` — the attribution used when
        the key's bytes later land in (or leave) a tier."""
        with self._lock:
            self._key_tenant[key] = tenant
            self._counters.setdefault(tenant, _TenantCounters())
            if len(self._key_tenant) > _KEY_TENANT_CAP:
                # bounded map: drop the oldest attribution (dict preserves
                # insertion order); its bytes just re-attribute to default
                self._key_tenant.pop(next(iter(self._key_tenant)))

    def tenant_of(self, key: Hashable) -> str:
        with self._lock:
            return self._key_tenant.get(key, DEFAULT_TENANT)

    # -- residency accounting (fires under a cache lock) --------------------
    def _listener(self, tier_name: str):
        def on_event(event, entry):
            with self._lock:
                tenant = self._key_tenant.get(entry.key, DEFAULT_TENANT)
                k = (tier_name, tenant)
                if event == "insert":
                    self._usage[k] = self._usage.get(k, 0) + entry.nbytes
                elif event == "remove":
                    self._usage[k] = max(0, self._usage.get(k, 0) - entry.nbytes)
        return on_event

    def attach(self, mrm) -> "TenantRegistry":
        """Wire this registry into an MRM: residency listeners, CostAware
        eviction weights, and the MRM-side admission hooks."""
        from repro_torch.core.cache import CostAware
        for tier_name, cache in (("device", mrm.device), ("host", mrm.host)):
            cache.add_listener(self._listener(tier_name))
            with self._lock:
                self._capacity[tier_name] = cache.capacity
            with cache.lock:  # backfill entries resident before attach
                for e in cache.entries.values():
                    with self._lock:
                        k = (tier_name, self._key_tenant.get(e.key, DEFAULT_TENANT))
                        self._usage[k] = self._usage.get(k, 0) + e.nbytes
            if isinstance(cache.policy, CostAware):
                cache.policy.weight_fn = self._make_weight_fn(tier_name)
        mrm.tenants = self
        self._attached.append(mrm)
        return self

    def _make_weight_fn(self, tier_name: str):
        def weight(entry):
            return self.eviction_weight(entry.key, tier_name)
        return weight

    # -- shares & quotas ----------------------------------------------------
    def usage_bytes(self, tenant: str, tier: str = "device") -> int:
        with self._lock:
            return self._usage.get((tier, tenant), 0)

    def quota_bytes(self, tenant: str, tier: str = "device") -> Optional[int]:
        """Hard byte cap for admission, or None if uncapped."""
        with self._lock:
            q = self.quotas.get(tenant)
            if q is None:
                return None
            return q.device_bytes if tier == "device" else q.host_bytes

    def fair_bytes(self, tenant: str, tier: str = "device") -> float:
        """The tenant's fair share of the tier: its explicit quota when set,
        else ``capacity * share / sum(shares)`` over every known tenant."""
        with self._lock:
            cap = self._capacity.get(tier, 0)
            q = self.quotas.get(tenant)
            hard = (q.device_bytes if tier == "device" else q.host_bytes) if q else None
            if hard is not None:
                return float(hard)
            tenants = set(self.quotas) | {t for (tr, t) in self._usage if tr == tier}
            tenants.add(tenant)
            total = sum(self.quotas.get(t, TenantQuota()).share or 1.0
                        for t in tenants)
            share = self.quotas.get(tenant, TenantQuota()).share or 1.0
            return cap * share / max(total, 1e-9)

    def overage(self, tenant: str, tier: str = "device") -> float:
        """How far past its fair share the tenant sits (0.0 = within)."""
        fair = self.fair_bytes(tenant, tier)
        if fair <= 0:
            return 0.0
        return max(0.0, self.usage_bytes(tenant, tier) / fair - 1.0)

    def eviction_weight(self, key: Hashable, tier: str = "device") -> float:
        """CostAware divides a victim's score by this: >1 for bytes owned by
        an over-share tenant, so a scanner's flood evicts its own bytes
        first. Runs under the evicting cache's lock — only touches the
        registry leaf lock."""
        return 1.0 + self.overage_weight_k * self.overage(self.tenant_of(key), tier)

    def would_exceed(self, tenant: str, tier: str, nbytes: int) -> bool:
        """True if staging ``nbytes`` more for ``tenant`` would break its
        hard quota on ``tier`` (no-op when the tenant is uncapped)."""
        cap = self.quota_bytes(tenant, tier)
        if cap is None:
            return False
        return self.usage_bytes(tenant, tier) + nbytes > cap

    # -- admission ----------------------------------------------------------
    def admit(self, ctx: Optional[RequestContext],
              device_frac: float = 0.0, host_frac: float = 0.0) -> str:
        """Admission verdict for one invoke: ``"admit" | "queue" | "shed"``.

        Critical-class work always admits (the MRM degrades its *staging
        tier* instead when a deadline or quota says device is pointless).
        Batch-class work under pressure on BOTH shared tiers queues when
        the tenant is within its fair share and sheds when it is already
        over — an over-share scanner hammering a saturated store gets
        dropped before it burns staging bandwidth.
        """
        if ctx is None or ctx.slo_class == "critical":
            if ctx is not None:
                self._count(ctx.tenant, "admitted")
            return "admit"
        pressured = (device_frac >= self.pressure_frac
                     and host_frac >= self.pressure_frac)
        if not pressured:
            self._count(ctx.tenant, "admitted")
            return "admit"
        verdict = "shed" if self.overage(ctx.tenant, "device") > 0 else "queue"
        self._count(ctx.tenant, verdict if verdict == "shed" else "queued")
        return verdict

    def note_degraded(self, tenant: str) -> None:
        self._count(tenant, "degraded")

    def _count(self, tenant: str, what: str) -> None:
        with self._lock:
            c = self._counters.setdefault(tenant, _TenantCounters())
            setattr(c, what, getattr(c, what) + 1)

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            tenants = sorted(set(self.quotas)
                             | {t for (_, t) in self._usage}
                             | set(self._counters))
            out = {}
            for t in tenants:
                c = self._counters.get(t, _TenantCounters())
                out[t] = {
                    "device_bytes": self._usage.get(("device", t), 0),
                    "host_bytes": self._usage.get(("host", t), 0),
                    "admitted": c.admitted, "queued": c.queued,
                    "shed": c.shed, "degraded": c.degraded,
                }
            return out
