"""Tier caches with pluggable eviction (paper §4.1.2).

Invariants (property-tested):
  * used_bytes == sum of resident entry sizes, always <= capacity after fit()
  * entries with refcount > 0 are never eviction candidates
  * eviction order follows the configured policy
"""
from __future__ import annotations

import math
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Hashable, List, Optional


class Tier(Enum):
    DEVICE = 0   # TPU HBM (GPU memory in the paper)
    HOST = 1     # host DRAM (CPU memory)
    DISK = 2     # local storage
    CLOUD = 3    # object store (paper §3 "cloud storage")
    REMOTE = 3   # legacy alias for CLOUD

    @property
    def warmth(self) -> int:
        """Rank for affinity scoring: warmer (closer to compute) is higher —
        DEVICE=3, HOST=2, DISK=1, CLOUD=0."""
        return 3 - self.value


@dataclass
class CacheEntry:
    key: Hashable
    nbytes: int
    refcount: int = 0
    pinned: bool = False
    inserted_at: float = field(default_factory=time.monotonic)
    last_used: float = field(default_factory=time.monotonic)
    use_count: int = 0
    payload: object = None  # tier-specific (device pytree / host buffers / path)

    def touch(self):
        self.last_used = time.monotonic()
        self.use_count += 1


class EvictionPolicy(ABC):
    name = "base"

    @abstractmethod
    def order(self, entries: List[CacheEntry]) -> List[CacheEntry]:
        """Victims-first ordering of evictable entries."""


class LRU(EvictionPolicy):
    name = "lru"

    def order(self, entries):
        return sorted(entries, key=lambda e: e.last_used)


class LCU(EvictionPolicy):
    """Least-commonly-used (paper's LCU)."""
    name = "lcu"

    def order(self, entries):
        return sorted(entries, key=lambda e: (e.use_count, e.last_used))


class FIFO(EvictionPolicy):
    name = "fifo"

    def order(self, entries):
        return sorted(entries, key=lambda e: e.inserted_at)


class Largest(EvictionPolicy):
    """Evict the largest first — frees space with fewest evictions."""
    name = "largest"

    def order(self, entries):
        return sorted(entries, key=lambda e: -e.nbytes)


class CostAware(EvictionPolicy):
    """SLO/cost-aware eviction (DESIGN.md §7, Torpor/FaaSwap direction).

    Scores every candidate by ``expected reload cost x probability of
    reuse within the deadline horizon``, normalized per byte freed
    (GreedyDual-Size/Landlord family): eviction buys capacity, so victims
    are ordered by how little deadline-relevant reload cost each freed
    byte gives up. Without the normalization a hot small model is always
    a "cheap" victim in absolute seconds and gets churned endlessly to
    admit cold giants. Ties fall back to LRU order, so with no arrival
    signal (uniform gaps, uniform per-byte costs) the policy degrades to
    LRU instead of thrashing.

    ``predictor`` is a :class:`repro_torch.core.slo.NextUsePredictor` (a default
    one is built when omitted — standalone TierCaches then score from
    entry recency alone); ``cost_fn(entry) -> seconds`` prices the reload
    (the MRM wires a :class:`repro_torch.core.slo.ReloadCostEstimator`; the
    fallback uses entry bytes as a byte-proportional proxy);
    ``horizon_fn() -> seconds`` supplies the live deadline horizon.
    ``cost_fn`` runs under the evicting cache's lock and must only take
    locks *below* it in the DEVICE -> HOST -> leaf order.

    ``weight_fn(entry) -> float`` (optional) divides the score: a weight
    above 1 makes the entry a *preferred* victim. The tenant registry
    (DESIGN.md §12) wires this to each owner's fair-share overage so a
    scanning tenant's flood drains its own bytes first. Same lock rule as
    ``cost_fn``: it fires under the cache lock and may only take leaf
    locks.
    """
    name = "slo"

    def __init__(self, predictor=None, cost_fn=None, horizon_fn=None,
                 weight_fn=None):
        if predictor is None:
            from repro_torch.core.slo import NextUsePredictor
            predictor = NextUsePredictor()
        self.predictor = predictor
        self.cost_fn = cost_fn
        self.horizon_fn = horizon_fn
        self.weight_fn = weight_fn

    def _horizon_s(self) -> float:
        if self.horizon_fn is not None:
            return self.horizon_fn()
        from repro_torch.core.slo import DEFAULT_HORIZON_S
        return DEFAULT_HORIZON_S

    def score(self, e: CacheEntry, now: float = None) -> float:
        """Expected deadline-relevant reload seconds lost *per byte freed*
        by evicting ``e`` now — the policy's victims-first sort key."""
        now = self.predictor.clock() if now is None else now
        horizon = self._horizon_s()
        p = self.predictor.reuse_probability(e.key, horizon, now=now)
        if p is None:
            # no arrival stream recorded (standalone cache): idle time as
            # the gap estimate — staler entries look less likely to return
            gap = max(now - e.last_used, self.predictor.default_gap_s)
            p = 1.0 - math.exp(-horizon / gap)
        cost = self.cost_fn(e) if self.cost_fn is not None else float(e.nbytes)
        s = cost * p / max(1, e.nbytes)
        if self.weight_fn is not None:
            s /= max(1e-9, self.weight_fn(e))
        return s

    def order(self, entries):
        now = self.predictor.clock()
        return sorted(entries, key=lambda e: (self.score(e, now), e.last_used))


POLICIES = {p.name: p for p in (LRU(), LCU(), FIFO(), Largest())}


def make_policy(policy: "EvictionPolicy | str") -> EvictionPolicy:
    """Resolve a policy name to an instance. Stateless policies share the
    module singletons; ``"slo"`` constructs a fresh :class:`CostAware`
    (it carries a per-cache predictor unless the caller wires its own)."""
    if isinstance(policy, EvictionPolicy):
        return policy
    if policy == CostAware.name:
        return CostAware()
    return POLICIES[policy]


class CapacityError(RuntimeError):
    pass


class TierCache:
    """Byte-capacity cache for one tier. Thread-safe."""

    def __init__(self, tier: Tier, capacity_bytes: int,
                 policy: EvictionPolicy | str = "lru"):
        self.tier = tier
        self.capacity = int(capacity_bytes)
        self.policy = make_policy(policy)
        self.entries: Dict[Hashable, CacheEntry] = {}
        self.used = 0
        self.lock = threading.RLock()
        # residency listeners: fn(event, entry) with event "insert"/"remove",
        # called under the cache lock — listeners must only touch leaf locks
        # (the cluster directory, a writeback queue), never another tier cache
        self.listeners: List = []
        # metrics
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_evicted = 0

    def add_listener(self, fn) -> None:
        """Subscribe to insert/remove events (cluster directory, write-back).

        ``fn(event, entry)`` fires under the cache lock; it must be fast and
        must not acquire any tier-cache lock (see DESIGN.md §6 lock order).
        """
        with self.lock:
            self.listeners.append(fn)

    def remove_listener(self, fn) -> None:
        """Unsubscribe (no-op if ``fn`` was never added)."""
        with self.lock:
            if fn in self.listeners:
                self.listeners.remove(fn)

    def _notify(self, event: str, entry: CacheEntry) -> None:
        for fn in self.listeners:
            fn(event, entry)

    # -- queries ------------------------------------------------------------
    def get(self, key) -> Optional[CacheEntry]:
        with self.lock:
            e = self.entries.get(key)
            if e is not None:
                self.hits += 1
                e.touch()
            else:
                self.misses += 1
            return e

    def peek(self, key) -> Optional[CacheEntry]:
        with self.lock:
            return self.entries.get(key)

    def free_bytes(self) -> int:
        with self.lock:
            return self.capacity - self.used

    # -- mutation -----------------------------------------------------------
    def make_room(self, nbytes: int) -> List[CacheEntry]:
        """Evict unreferenced entries (policy order) until ``nbytes`` fits.

        Returns the evicted entries (caller demotes/frees payloads).
        Raises CapacityError if the bytes cannot fit even after evicting
        everything evictable.
        """
        with self.lock:
            if nbytes > self.capacity:
                raise CapacityError(
                    f"{self.tier.name}: object of {nbytes}B exceeds capacity {self.capacity}B")
            evicted: List[CacheEntry] = []
            if self.used + nbytes <= self.capacity:
                return evicted
            candidates = [e for e in self.entries.values()
                          if e.refcount == 0 and not e.pinned]
            for victim in self.policy.order(candidates):
                if self.used + nbytes <= self.capacity:
                    break
                self._remove_locked(victim.key)
                evicted.append(victim)
                self.evictions += 1
                self.bytes_evicted += victim.nbytes
            if self.used + nbytes > self.capacity:
                # roll forward is impossible; caller decides (all in use)
                raise CapacityError(
                    f"{self.tier.name}: cannot free {nbytes}B "
                    f"({self.used}B used, all remaining entries referenced)")
            return evicted

    def insert(self, key, nbytes: int, payload=None, refcount: int = 0) -> CacheEntry:
        with self.lock:
            if key in self.entries:
                raise KeyError(f"{key} already resident in {self.tier.name}")
            if self.used + nbytes > self.capacity:
                raise CapacityError(f"{self.tier.name}: insert without room")
            e = CacheEntry(key=key, nbytes=nbytes, payload=payload, refcount=refcount)
            self.entries[key] = e
            self.used += nbytes
            self._notify("insert", e)
            return e

    def _remove_locked(self, key) -> CacheEntry:
        e = self.entries.pop(key)
        self.used -= e.nbytes
        self._notify("remove", e)
        return e

    def remove(self, key) -> CacheEntry:
        with self.lock:
            return self._remove_locked(key)

    def stats(self) -> dict:
        with self.lock:
            return {
                "tier": self.tier.name, "capacity": self.capacity,
                "used": self.used, "n_entries": len(self.entries),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "bytes_evicted": self.bytes_evicted,
                "policy": self.policy.name,
            }


class TierHierarchy:
    """The DEVICE -> HOST -> DISK tier chain as one object (DESIGN.md §2).

    The CLOUD tier below DISK is not a cache — the MRM falls through to it
    (``ObjectStore``/peer fetch, DESIGN.md §6) when DISK misses.

    Eviction is *demotion*: a victim pushed out of DEVICE is re-homed in the
    HOST tier (via ``demote_fn``, which performs the D2H payload conversion)
    instead of being dropped, so the next open is a host hit rather than a
    disk reload. HOST victims simply fall back to disk — the store below
    already holds every model, so releasing the payload *is* the demotion.
    Demotion is best-effort: if the host tier cannot make room (everything
    referenced/pinned) the victim is dropped, never an error.

    Lock order is always DEVICE before HOST; ``make_room(DEVICE)`` nests the
    host lock while demoting, and nothing acquires them in reverse.
    """

    def __init__(self, device: TierCache, host: TierCache,
                 demote_fn=None, demote_on_evict: bool = True):
        self.device = device
        self.host = host
        self.demote_fn = demote_fn
        self.demote_on_evict = demote_on_evict
        self.demotions = 0
        self.bytes_demoted = 0
        self.demotion_drops = 0

    def cache(self, tier: Tier) -> TierCache:
        if tier == Tier.DEVICE:
            return self.device
        if tier == Tier.HOST:
            return self.host
        raise KeyError(f"no cache for tier {tier}")

    # -- eviction-as-demotion ----------------------------------------------
    def make_room(self, tier: Tier, nbytes: int):
        """``TierCache.make_room`` on ``tier``; HOST victims' payloads are
        released (the disk tier below already holds them). DEVICE victims
        are only evicted here — the caller demotes them with
        :meth:`demote_evicted` AFTER dropping the device lock, so the D2H
        payload copy never stalls other tier operations. Returns the
        evicted entries; raises CapacityError exactly as the tier cache
        does."""
        cache = self.cache(tier)
        with cache.lock:
            evicted = cache.make_room(nbytes)
            if tier == Tier.HOST:
                for victim in evicted:
                    payload = victim.payload
                    victim.payload = None
                    if payload is not None and hasattr(payload, "release"):
                        payload.release()
            return evicted

    def demote_evicted(self, victims) -> list:
        """Demote DEVICE victims into HOST; call with NO cache locks held.
        Returns the entries that were actually copied down."""
        return [v for v in victims if self._demote(v)]

    def _demote(self, victim: CacheEntry) -> bool:
        if (not self.demote_on_evict or self.demote_fn is None
                or victim.payload is None):
            return False
        with self.host.lock:
            held = self.host.peek(victim.key)
            if held is not None:
                # host still holds it — no copy needed, but the model was
                # device-hot until this instant: refresh its recency so the
                # host tier doesn't turn around and evict it next
                held.touch()
                return False
            try:
                # make room BEFORE paying for the copy: a doomed demotion
                # (host can't fit the victim) must cost nothing
                self.make_room(Tier.HOST, victim.nbytes)
            except CapacityError:
                self.demotion_drops += 1
                return False
        # D2H copy outside both cache locks: a multi-GB demotion must not
        # block concurrent hits/stagings on either tier
        payload = self.demote_fn(victim)
        if payload is None:
            self.demotion_drops += 1
            return False
        with self.host.lock:
            if self.host.peek(victim.key) is not None:
                # a concurrent load brought it back while we copied
                if hasattr(payload, "release"):
                    payload.release()
                return False
            try:
                self.make_room(Tier.HOST, victim.nbytes)  # re-check: races
                self.host.insert(victim.key, victim.nbytes, payload=payload)
            except CapacityError:
                self.demotion_drops += 1
                if hasattr(payload, "release"):
                    payload.release()
                return False
        self.demotions += 1
        self.bytes_demoted += victim.nbytes
        return True

    # -- pinning ------------------------------------------------------------
    def pin(self, key, tier: Tier = Tier.DEVICE) -> bool:
        cache = self.cache(tier)
        with cache.lock:
            e = cache.peek(key)
            if e is None:
                return False
            e.pinned = True
            return True

    def unpin(self, key, tier: Tier = Tier.DEVICE) -> bool:
        cache = self.cache(tier)
        with cache.lock:
            e = cache.peek(key)
            if e is None:
                return False
            e.pinned = False
            return True

    # -- queries ------------------------------------------------------------
    def resident_tier(self, key) -> Optional[Tier]:
        """Highest tier where ``key`` is resident with a live payload."""
        for cache in (self.device, self.host):
            e = cache.peek(key)
            if e is not None and e.payload is not None:
                return cache.tier
        return None

    def stats(self) -> dict:
        return {"demotions": self.demotions,
                "bytes_demoted": self.bytes_demoted,
                "demotion_drops": self.demotion_drops}
