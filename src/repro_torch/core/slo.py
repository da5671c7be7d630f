"""SLO-aware eviction signals (Torpor/FaaSwap direction, DESIGN.md §7).

Under the paper's oversubscribed regime (total model bytes >> device
capacity) recency is a poor eviction signal: the quantity that matters is
the reload cost we will pay at a victim's *next use*, weighted by how
likely that use lands before the deadline of the request paying it. This
module produces both signals:

  * :class:`NextUsePredictor` — per-key EWMA of inter-arrival gaps, fed
    from the MRM's open stream (one record per handle-carrying open —
    prefetch hints don't count as usage). Predicts time-to-next-use and a
    probability of reuse within a deadline horizon (exponential arrival
    model with an overdue decay, so a key whose stream stopped fades out
    instead of pinning its slot forever).
  * :class:`ReloadCostEstimator` — prices re-promotion to DEVICE from the
    entry's warmest *backing* tier via the existing
    :class:`~repro_torch.core.costmodel.HardwareModel`: a host-backed victim
    costs one H2D pass, a disk-backed one the pipelined staging chain, a
    CLOUD-only one the cloud fetch on top.

The :class:`~repro_torch.core.cache.CostAware` policy multiplies the two —
expected reload cost x probability-of-reuse-before-deadline — and evicts
cheapest-first. :class:`SLOState` bundles one predictor + estimator +
clock per MRM (the clock is injectable so benchmarks can drive a virtual
modeled timeline deterministically).
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Optional

from repro_torch.core.cache import Tier
from repro_torch.core.costmodel import HardwareModel

# EWMA smoothing for inter-arrival gaps: ~86% weight on the last 8 gaps
GAP_ALPHA = 0.25
# silence beyond OVERDUE_DECAY_GAPS x ewma_gap past the predicted next use
# decays the reuse probability by 1/e. Deliberately gentle: its only job
# is to eventually retire streams that *stopped* — an aggressive decay
# would flush hot short-gap keys during every scan burst (their overdue
# grows fastest), which is exactly the LRU pathology this policy exists
# to avoid. The exponential term is otherwise memoryless, as a Poisson
# arrival model should be.
OVERDUE_DECAY_GAPS = 32.0
# default deadline horizon when no request has declared one (seconds)
DEFAULT_HORIZON_S = 0.1


@dataclass
class _KeyStats:
    last_arrival: float
    ewma_gap_s: Optional[float] = None  # None until the second arrival
    arrivals: int = 1


class NextUsePredictor:
    """Per-key EWMA inter-arrival predictor. Thread-safe (leaf lock).

    ``clock`` defaults to ``time.monotonic``; benchmarks inject a virtual
    clock so the arrival process runs on the modeled timeline instead of
    host wall time (deterministic sweeps).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 alpha: float = GAP_ALPHA,
                 default_gap_s: float = DEFAULT_HORIZON_S,
                 max_keys: int = 4096):
        self.clock = clock
        self.alpha = alpha
        self.default_gap_s = default_gap_s
        self.max_keys = max_keys
        self.evicted_streams = 0  # cap-evictions of multi-arrival streams
        self._stats: Dict[Hashable, _KeyStats] = {}
        self._lock = threading.Lock()

    # -- feeding ------------------------------------------------------------
    def _evict_for_capacity_locked(self) -> None:
        """Make room for a new key: prefer the stalest *single-arrival*
        record (a scan key that never came back) so a flood of one-shot
        keys cannot flush an established stream's gap history; only when
        every slot holds a real stream does the stalest stream go, and
        ``evicted_streams`` counts those losses."""
        stale = None
        stale_t = math.inf
        for k, rec in self._stats.items():
            if rec.arrivals == 1 and rec.last_arrival < stale_t:
                stale, stale_t = k, rec.last_arrival
        if stale is None:
            stale = min(self._stats,
                        key=lambda k: self._stats[k].last_arrival)
            self.evicted_streams += 1
        del self._stats[stale]

    def record(self, key: Hashable, now: Optional[float] = None) -> None:
        """One arrival of ``key`` (an MRM open or prefetch)."""
        now = self.clock() if now is None else now
        with self._lock:
            rec = self._stats.get(key)
            if rec is None:
                if len(self._stats) >= self.max_keys:
                    self._evict_for_capacity_locked()
                self._stats[key] = _KeyStats(last_arrival=now)
                return
            gap = max(1e-9, now - rec.last_arrival)
            rec.ewma_gap_s = (gap if rec.ewma_gap_s is None
                              else (1 - self.alpha) * rec.ewma_gap_s
                              + self.alpha * gap)
            rec.last_arrival = now
            rec.arrivals += 1

    # -- queries ------------------------------------------------------------
    def mean_gap_s(self, key: Hashable) -> Optional[float]:
        """EWMA inter-arrival gap, or None for an unseen/single-shot key."""
        with self._lock:
            rec = self._stats.get(key)
            return rec.ewma_gap_s if rec is not None else None

    def arrivals(self, key: Hashable) -> int:
        with self._lock:
            rec = self._stats.get(key)
            return rec.arrivals if rec is not None else 0

    def predict_next_use_s(self, key: Hashable,
                           now: Optional[float] = None) -> Optional[float]:
        """Seconds from ``now`` until the predicted next use (>= 0), or
        None for a key with no recorded arrivals. A single-shot key uses
        its elapsed idle time as the gap estimate (the longer it sits, the
        further away we predict its return)."""
        now = self.clock() if now is None else now
        with self._lock:
            rec = self._stats.get(key)
            if rec is None:
                return None
            gap = rec.ewma_gap_s
            if gap is None:
                gap = max(now - rec.last_arrival, self.default_gap_s)
            return max(0.0, rec.last_arrival + gap - now)

    def reuse_probability(self, key: Hashable, horizon_s: float,
                          now: Optional[float] = None) -> Optional[float]:
        """P(key is used again within ``horizon_s`` seconds of ``now``).

        Exponential arrival model at rate ``1/ewma_gap`` —
        ``1 - exp(-horizon/gap)`` — times an overdue decay
        ``exp(-overdue / (OVERDUE_DECAY_GAPS * gap))`` where overdue is how
        far past the predicted next use the key already is. Hot streams
        (overdue ~ 0) keep the full exponential probability; a stream that
        stopped arriving decays toward 0 instead of parking in the cache.
        Returns None for a key with no recorded arrivals.
        """
        now = self.clock() if now is None else now
        with self._lock:
            rec = self._stats.get(key)
            if rec is None:
                return None
            gap = rec.ewma_gap_s
            if gap is None:
                gap = max(now - rec.last_arrival, self.default_gap_s)
            gap = max(gap, 1e-9)
            overdue = max(0.0, (now - rec.last_arrival) - gap)
            decay = math.exp(-overdue / (OVERDUE_DECAY_GAPS * gap))
            return decay * (1.0 - math.exp(-max(0.0, horizon_s) / gap))

    def forget(self, key: Hashable) -> None:
        """Drop ``key``'s arrival history (model deregistered/removed).
        Slots are bounded (``max_keys``); deregistration paths that skip
        this leak a slot until capacity eviction reclaims it — possibly
        at a live stream's expense."""
        with self._lock:
            self._stats.pop(key, None)

    def stats(self) -> dict:
        with self._lock:
            return {"keys": len(self._stats), "max_keys": self.max_keys,
                    "evicted_streams": self.evicted_streams}

    def __len__(self) -> int:
        with self._lock:
            return len(self._stats)


class ReloadCostEstimator:
    """Prices re-promoting an evicted entry back to DEVICE.

    ``backing_tier_fn(key, nbytes) -> Tier | None`` names the warmest tier
    that would still hold the key *after* the eviction under consideration
    (HOST for a device victim that will demote, DISK when only the local
    store holds it, CLOUD/None when a fetch is needed first). The price is
    the modeled promotion chain from that tier (DESIGN.md §4/§6 cost
    model); callers must ensure ``backing_tier_fn`` only touches locks
    below the evicting cache in the lock order (DEVICE -> HOST -> leaves).
    """

    def __init__(self, hw: HardwareModel,
                 backing_tier_fn: Callable[[Hashable, int], Optional[Tier]]):
        self.hw = hw
        self.backing_tier_fn = backing_tier_fn

    def reload_cost_s(self, key: Hashable, nbytes: int) -> float:
        tier = self.backing_tier_fn(key, nbytes)
        if tier == Tier.DEVICE:
            return 0.0
        if tier == Tier.HOST:
            return self.hw.h2d_time(nbytes)
        cost = self.hw.staging_pipelined_time(nbytes)
        if tier != Tier.DISK:  # CLOUD / unknown: fetch before staging
            cost += self.hw.cloud_fetch_time(nbytes)
        return cost


class SLOState:
    """One MRM's SLO machinery: the shared predictor, one reload-cost
    estimator per evicting tier, and the deadline horizon.

    ``note_deadline`` folds observed request deadlines into an EWMA
    horizon, so the eviction score's probability-of-reuse-before-deadline
    tracks what the serving layer actually promises. The horizon is also
    the window used to classify an eviction as *mispredicted* (the key
    returned within one horizon of being evicted).
    """

    def __init__(self, hw: HardwareModel,
                 device_backing_fn: Callable[[Hashable, int], Optional[Tier]],
                 host_backing_fn: Optional[
                     Callable[[Hashable, int], Optional[Tier]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 horizon_s: float = DEFAULT_HORIZON_S):
        self.predictor = NextUsePredictor(clock=clock)
        self.estimator = ReloadCostEstimator(hw, device_backing_fn)
        self.host_estimator = (
            ReloadCostEstimator(hw, host_backing_fn)
            if host_backing_fn is not None else None)
        self.horizon_s = horizon_s
        self._lock = threading.Lock()

    def now(self) -> float:
        return self.predictor.clock()

    def note_deadline(self, deadline_s: float) -> None:
        # no None/<=0 guard here: deadlines are validated once, at the
        # RequestContext boundary (repro_torch.core.tenant) — callers hand this
        # method an already-vetted positive float
        with self._lock:
            self.horizon_s = ((1 - GAP_ALPHA) * self.horizon_s
                              + GAP_ALPHA * deadline_s)
