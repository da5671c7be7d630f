"""Predictive fleet-wide placement planner (DESIGN.md §13).

TrIMS's latency win requires the model to already be resident when the
request lands; everything below this module is *reactive* — per-node
prefetch hints, warmest-peer pulls, router affinity — so the first wave
of every diurnal or bursty workload still eats the cold-start. The
Transformer-based cold-start work (PAPERS.md) shows FaaS invocations are
predictable ahead of time, and Torpor/FaaSwap argue placement should be
a fleet-level decision. This module closes that loop:

  * :class:`ArrivalHistory` — per-key binned arrival histogram plus
    per-node origin counts (which nodes the opens and gathers came from).
  * a periodic/diurnal detector — consecutive active bins group into
    bursts; >= ``min_bursts`` bursts whose inter-start gaps agree within
    ``max_period_cv`` declare a :class:`PeriodicPattern` (period, phase,
    duty). The EWMA baseline (:class:`~repro_torch.core.slo.NextUsePredictor`)
    stays the cheap always-on signal; the histogram is only consulted for
    keys with enough arrivals.
  * :class:`PlacementPlanner` — turns patterns into
    :class:`PlacementAction`s: **preposition** whole models on their top
    origin nodes shortly before a predicted burst, **replicate** a
    sharded model's shards toward the nodes generating its gather
    traffic, and **rebalance** shard placements when the directory's
    membership ``generation`` moves (a holder died). ``apply`` drives the
    real :class:`~repro_torch.core.cluster.Cluster` — ``scatter`` for shards,
    per-node MRM ``prefetch`` for whole models.

Planner traffic is speculative by construction, so every action it
issues carries a **batch-class** :class:`~repro_torch.core.tenant.RequestContext`
(tenant :data:`PLANNER_TENANT`): under the tenancy rules (DESIGN.md §12) the MRM
refuses batch prefetches outright while either tier is under admission
pressure (``prefetch_suppressed``), so pre-positioning can never starve
or displace a critical demand open. A key with no detected pattern
produces **no** action — on a uniform workload the planner is inert and
the reactive baseline is untouched (the no-regression half of the §13
bench contract).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple

from repro_torch.core.mrm import ModelKey
from repro_torch.core.slo import NextUsePredictor
from repro_torch.core.tenant import RequestContext

__all__ = ["ArrivalHistory", "PeriodicPattern", "PlacementAction",
           "PlannerConfig", "PlacementPlanner", "PLANNER_TENANT",
           "planner_ctx"]

# the tenant every planner-issued prefetch/scatter runs under: batch
# class, so tenancy admission (DESIGN.md §12) can shed it under pressure
PLANNER_TENANT = "placement-planner"


def planner_ctx(deadline_s: Optional[float] = None) -> RequestContext:
    """A batch-class context for planner-issued work."""
    return RequestContext(tenant=PLANNER_TENANT, slo_class="batch",
                          deadline_s=deadline_s)


@dataclass(frozen=True)
class PeriodicPattern:
    """A detected periodic arrival pattern for one key."""
    period_s: float          # mean gap between burst starts
    last_start_s: float      # start time of the most recent burst
    duty_s: float            # mean burst length
    bursts: int              # bursts observed in the window
    cv: float                # coefficient of variation of the gaps

    def next_start_s(self, now: float) -> float:
        """Predicted start of the next burst at or after ``now``."""
        if now <= self.last_start_s:
            return self.last_start_s
        k = math.ceil((now - self.last_start_s) / self.period_s)
        return self.last_start_s + k * self.period_s


@dataclass(frozen=True)
class PlacementAction:
    """One planner decision. ``kind`` is ``preposition`` (whole-model
    host warm-up on ``nodes`` ahead of a predicted burst),
    ``replicate`` (scatter shards toward the gather-origin ``nodes``), or
    ``rebalance`` (re-scatter after membership churn). ``at_s`` is the
    virtual/real time the action targets (the predicted burst start for
    prepositions; the plan time otherwise)."""
    kind: str
    key: ModelKey
    nodes: Tuple[str, ...]
    at_s: float
    reason: str = ""


@dataclass
class PlannerConfig:
    """Detector + actuation knobs. ``bin_s`` sets the histogram's time
    resolution; everything that reasons about periods is expressed in
    bins, so the same planner serves second-scale benches and hour-scale
    diurnal traffic by scaling this one knob."""
    bin_s: float = 1.0
    history_bins: int = 4096     # histogram window = bin_s * history_bins
    min_bursts: int = 3          # bursts needed to declare a period
    max_period_cv: float = 0.25  # inter-burst-gap agreement tolerance
    min_arrivals: int = 6        # histogram arrivals before detecting
    merge_gap_bins: int = 1      # empty bins tolerated inside one burst
    active_frac: float = 0.25    # bin is burst-active at >= this fraction
                                 # of the key's peak bin (filters the thin
                                 # background under a bursty stream)
    lead_s: float = 1.0          # pre-position this far before a burst
    fanout: int = 2              # nodes pre-warmed per predicted burst
    replicate_min_gathers: int = 3   # gathers from one node -> replicate
    max_actions: int = 64        # per plan() call
    max_keys: int = 2048         # tracked arrival histories (LRU-ish cap)


class ArrivalHistory:
    """One key's arrival record: a sparse binned histogram over the last
    ``history_bins`` bins plus bounded per-node origin counters for opens
    and gather events."""

    __slots__ = ("bins", "origins", "gather_origins", "total", "last_s")

    def __init__(self) -> None:
        self.bins: Dict[int, int] = {}
        self.origins: Dict[str, int] = {}
        self.gather_origins: Dict[str, int] = {}
        self.total = 0
        self.last_s = 0.0

    def record(self, now: float, cfg: PlannerConfig,
               node: Optional[str] = None, kind: str = "open") -> None:
        b = int(now / cfg.bin_s)
        if kind == "gather":
            if node is not None:
                self.gather_origins[node] = \
                    self.gather_origins.get(node, 0) + 1
            return
        self.bins[b] = self.bins.get(b, 0) + 1
        self.total += 1
        self.last_s = max(self.last_s, now)
        if node is not None:
            self.origins[node] = self.origins.get(node, 0) + 1
        if len(self.bins) > cfg.history_bins:
            floor = b - cfg.history_bins
            for stale in [i for i in self.bins if i < floor]:
                del self.bins[stale]

    def top_origins(self, k: int, gathers: bool = False) -> List[str]:
        src = self.gather_origins if gathers else self.origins
        return [n for n, _ in sorted(src.items(),
                                     key=lambda it: (-it[1], it[0]))[:k]]

    # -- the periodic/diurnal detector --------------------------------------
    def bursts(self, merge_gap_bins: int = 1,
               min_count: int = 1) -> List[Tuple[int, int]]:
        """Group active bins into ``(start_bin, length)`` runs, oldest
        first; runs separated by at most ``merge_gap_bins`` sub-threshold
        bins merge into one burst (a sparse arrival stream leaves holes
        inside a genuine duty window). A bin is active when it holds at
        least ``min_count`` arrivals — callers raise this above 1 to
        reject the thin background traffic that would otherwise weld
        every burst into one unbroken run."""
        out: List[Tuple[int, int]] = []
        for b in sorted(self.bins):
            if self.bins[b] < min_count:
                continue
            if out and b - (out[-1][0] + out[-1][1]) <= merge_gap_bins:
                out[-1] = (out[-1][0], b - out[-1][0] + 1)
            else:
                out.append((b, 1))
        return out

    def pattern(self, cfg: PlannerConfig) -> Optional[PeriodicPattern]:
        """Declare a period when enough bursts repeat at a consistent
        gap. Uniform traffic fails this two ways: a saturating stream is
        one giant burst (too few), and a sparse Poisson stream's gaps
        have high variance (fails the CV gate) — either way: no pattern,
        no action."""
        if self.total < cfg.min_arrivals:
            return None
        peak = max(self.bins.values(), default=0)
        floor = max(1, math.ceil(peak * cfg.active_frac))
        runs = self.bursts(cfg.merge_gap_bins, min_count=floor)
        if len(runs) < cfg.min_bursts:
            return None
        starts = [s for s, _ in runs]
        gaps = [b - a for a, b in zip(starts, starts[1:])]
        mean = sum(gaps) / len(gaps)
        if mean <= 1.0:
            return None  # back-to-back runs, not a periodic signal
        var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
        cv = math.sqrt(var) / mean
        if cv > cfg.max_period_cv:
            return None
        duty = sum(ln for _, ln in runs) / len(runs)
        return PeriodicPattern(period_s=mean * cfg.bin_s,
                               last_start_s=starts[-1] * cfg.bin_s,
                               duty_s=duty * cfg.bin_s,
                               bursts=len(runs), cv=cv)


class PlacementPlanner:
    """Fleet-wide proactive placement (DESIGN.md §13). Thread-safe.

    Feed it the demand stream with :meth:`observe` (one call per open,
    plus one per multi-source gather with ``kind="gather"``), then call
    :meth:`plan` periodically — it returns the :class:`PlacementAction`s
    due now, deduplicated so one predicted burst is acted on once.
    :meth:`apply` executes them against a real
    :class:`~repro_torch.core.cluster.Cluster`; simulators (fleetsim) consume
    the actions directly and model the transfers themselves.

    ``directory`` is optional but enables the membership watch: when its
    ``generation`` moves between plans, sharded keys are re-checked and
    holderless shards produce ``rebalance`` actions.
    """

    def __init__(self, directory=None, cfg: Optional[PlannerConfig] = None,
                 clock=None, predictor: Optional[NextUsePredictor] = None):
        self.directory = directory
        self.cfg = cfg or PlannerConfig()
        self.clock = clock
        # the cheap EWMA baseline rides along (shared with the MRM's SLO
        # state when the caller passes it in): hot-key ranking + next-use
        self.predictor = predictor or NextUsePredictor(
            clock=clock or (lambda: 0.0))
        self._hist: Dict[Hashable, ArrivalHistory] = {}
        self._acted: Dict[Tuple[Hashable, int], float] = {}  # burst dedupe
        self._last_generation: Optional[int] = None
        self._lock = threading.Lock()
        self.metrics = {
            "observed": 0, "plans": 0, "patterns_detected": 0,
            "prepositions": 0, "replications": 0, "rebalances": 0,
            "actions_applied": 0, "apply_errors": 0,
        }

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        if self.clock is not None:
            return self.clock()
        raise ValueError("planner needs an explicit now= or a clock")

    # -- feeding ------------------------------------------------------------
    def observe(self, key: Hashable, node: Optional[str] = None,
                now: Optional[float] = None, kind: str = "open") -> None:
        """One demand event for ``key`` originating at ``node``.
        ``kind="open"`` records into the histogram + EWMA baseline;
        ``kind="gather"`` only marks the node as gather-origin traffic
        (the replicate signal) — a gather is already counted as the open
        that triggered it."""
        now = self._now(now)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                if len(self._hist) >= self.cfg.max_keys:
                    coldest = min(self._hist,
                                  key=lambda k: self._hist[k].last_s)
                    del self._hist[coldest]
                h = self._hist[key] = ArrivalHistory()
            h.record(now, self.cfg, node=node, kind=kind)
            self.metrics["observed"] += 1
        if kind == "open":
            self.predictor.record(key, now=now)

    def pattern(self, key: Hashable) -> Optional[PeriodicPattern]:
        with self._lock:
            h = self._hist.get(key)
            return h.pattern(self.cfg) if h is not None else None

    def forget(self, key: Hashable) -> None:
        """Deregistration hook: drop the histogram and the EWMA stream."""
        with self._lock:
            self._hist.pop(key, None)
        self.predictor.forget(key)

    # -- planning -----------------------------------------------------------
    def plan(self, now: Optional[float] = None) -> List[PlacementAction]:
        """The actions due at ``now``: membership rebalances first (they
        repair availability), then burst prepositions whose predicted
        start falls within ``lead_s``, then gather-driven replications.
        Every decision is pure directory/histogram reads — the transfers
        happen in :meth:`apply` (or the simulator)."""
        now = self._now(now)
        cfg = self.cfg
        actions: List[PlacementAction] = []
        with self._lock:
            self.metrics["plans"] += 1
            items = list(self._hist.items())
        actions.extend(self._plan_rebalance(now))
        for key, h in items:
            if len(actions) >= cfg.max_actions:
                break
            pat = h.pattern(cfg)
            if pat is None:
                continue
            with self._lock:
                self.metrics["patterns_detected"] += 1
            nxt = pat.next_start_s(now)
            if not (now < nxt <= now + cfg.lead_s):
                continue
            burst_id = int(round(nxt / pat.period_s))
            with self._lock:
                if self._acted.get((key, burst_id)) is not None:
                    continue
                self._acted[(key, burst_id)] = now
                if len(self._acted) > 4 * cfg.max_keys:
                    for stale in sorted(self._acted,
                                        key=self._acted.get)[:cfg.max_keys]:
                        del self._acted[stale]
            gather_to = tuple(sorted(
                n for n, c in h.gather_origins.items()
                if c >= cfg.replicate_min_gathers))
            if gather_to:
                # a local shard set makes this node's gathers (near-)free,
                # which strictly dominates warming a whole second copy
                actions.append(PlacementAction(
                    "replicate", ModelKey(*key), gather_to,
                    at_s=nxt, reason="gather traffic origin"))
                with self._lock:
                    self.metrics["replications"] += 1
            targets = tuple(n for n in h.top_origins(cfg.fanout)
                            if n not in gather_to)
            if targets:
                actions.append(PlacementAction(
                    "preposition", ModelKey(*key), targets, at_s=nxt,
                    reason=f"burst in {nxt - now:.3f}s "
                           f"(period {pat.period_s:.3f}s x{pat.bursts})"))
                with self._lock:
                    self.metrics["prepositions"] += 1
        return actions[:cfg.max_actions]

    def _plan_rebalance(self, now: float) -> List[PlacementAction]:
        """Membership watch: when the directory generation moved since
        the last plan, any sharded key left with a holderless shard gets
        re-scattered across the surviving nodes."""
        d = self.directory
        if d is None:
            return []
        gen = d.generation
        if self._last_generation is None:
            self._last_generation = gen
            return []
        if gen == self._last_generation:
            return []
        self._last_generation = gen
        alive = tuple(sorted(n.name for n in d.nodes()))
        if not alive:
            return []
        out = []
        for key in d.shard_keys():
            # a key needs a rebalance if any index in its published shard
            # range lost all holders (drop_node purged the dead node's
            # hints, leaving a hole in 0..max(index))
            held = {idx for n in alive for idx in d.shards_on(key, n)}
            n_idx = max(held, default=-1) + 1
            missing = [i for i in range(n_idx) if i not in held]
            if missing or not held:
                out.append(PlacementAction(
                    "rebalance", ModelKey(*key), alive, at_s=now,
                    reason=f"generation {gen}: shards {missing} holderless"))
                with self._lock:
                    self.metrics["rebalances"] += 1
        return out

    # -- actuation ----------------------------------------------------------
    def apply(self, cluster, actions: Optional[List[PlacementAction]] = None,
              now: Optional[float] = None,
              tier: str = "host") -> List[PlacementAction]:
        """Execute ``actions`` (default: ``plan(now)``) against a real
        cluster. Prepositions become per-node MRM prefetches into
        ``tier``; replicate/rebalance become ``Cluster.scatter`` toward
        the action's nodes. All traffic is batch-class (it yields under
        pressure) and a single failed action never aborts the rest."""
        if actions is None:
            actions = self.plan(now)
        ctx = planner_ctx()
        applied = []
        for act in actions:
            nodes = [n for n in act.nodes if n in cluster.nodes]
            if not nodes:
                continue
            try:
                if act.kind == "preposition":
                    for name in nodes:
                        cluster.nodes[name].mrm.prefetch(
                            act.key, tier=tier, ctx=ctx)
                else:  # replicate / rebalance
                    cluster.scatter(act.key, node_names=nodes)
            except Exception:
                with self._lock:
                    self.metrics["apply_errors"] += 1
                continue
            applied.append(act)
            with self._lock:
                self.metrics["actions_applied"] += 1
        return applied

    def stats(self) -> dict:
        with self._lock:
            return {**self.metrics, "tracked_keys": len(self._hist),
                    **{f"predictor_{k}": v
                       for k, v in self.predictor.stats().items()}}
