"""Virtual-clock fleet simulator for the directory control plane
(DESIGN.md §10).

100+ simulated cluster nodes drive opens / multi-source gathers /
evictions / drop_node events against a REAL placement directory (either
:class:`~repro_torch.core.cluster.ClusterDirectory` or the sharded scale-out —
anything satisfying :class:`~repro_torch.core.directory.DirectoryProtocol`),
on a deterministic virtual clock: every request arrival is pre-generated
from one seed, every latency is a cost-model term, and event ties break
on a monotonic sequence number — so a trace replays *identically* across
directory policies (the A/B requirement from bench_slo's modeled-clock
technique, extended fleet-wide).

What is real vs modeled: the directory data structures, their hint
semantics, membership tombstones and anti-entropy merges are the real
code under test; the data plane (which node holds which model) is a
simulated truth table, and all transfer/service times come from
:class:`~repro_torch.core.costmodel.HardwareModel` — peer/cloud/gather link
models for fetches, ``dir_op_s``/``dir_rtt`` for placement ops queued at
the owning directory shard, ``directory_sync_time`` for anti-entropy
rounds. The single-map baseline is the degenerate one-shard case: every
op serializes on one queue, which is exactly what its one lock does.

Injectable faults (:class:`Fault`):

* ``kill_hot_owner`` — the §10 failover probe: invalidate the fleet's
  cached whole copies of the hot *sharded* model (a registry redeploy),
  then kill the node owning its scattered shards **mid-gather**; every
  in-flight gather sourcing the dead node must complete via re-plan
  (per-shard CLOUD fallback), and the report carries the failover time
  until both directory views stop listing the dead node for the hot key.
* ``stale_flood`` — inject placement hints for copies that do not exist;
  stale probes must stay cheap (one wasted RTT + a corrective withdraw).
* ``partition`` — anti-entropy between the two directory views stops for
  a window; staleness-induced mis-fetches accumulate and the views must
  reconcile within a bounded number of rounds after the heal.
* ``churn`` — drop an arbitrary node (mid-gather membership churn).

Staleness is *measured*, not assumed: a directory answer is checked
against the simulated truth at probe time, every dead/stale probe counts
one mis-fetch, and ``misfetch_rate`` = stale probes / cold opens.
"""
from __future__ import annotations

import heapq
import random
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.cache import Tier
from repro_torch.core.costmodel import HardwareModel
from repro_torch.core.directory import make_directory
from repro_torch.core.mrm import ModelKey
from repro_torch.core.placement import PlacementPlanner, PlannerConfig

__all__ = ["Fault", "FleetConfig", "FleetSim", "SimMember"]

# modeled dispatch floor for a warm hit (same constant the modeled-clock
# benches use): a request that finds its model resident still pays the
# router/dispatch path
DISPATCH_S = 1e-3


@dataclass(frozen=True)
class Fault:
    """One injected fault. ``kind`` is one of ``kill_hot_owner`` /
    ``stale_flood`` / ``partition`` / ``churn``; ``at_s`` is the virtual
    time it fires, ``duration_s`` the partition window, ``count`` the
    number of flooded hints."""
    kind: str
    at_s: float
    duration_s: float = 0.0
    count: int = 100


DEFAULT_FAULTS = (
    Fault("stale_flood", at_s=3.0, count=120),
    Fault("partition", at_s=5.0, duration_s=2.0),
    Fault("kill_hot_owner", at_s=8.0),
    Fault("churn", at_s=11.0),
)


@dataclass
class FleetConfig:
    """Knobs for one simulated fleet run. The workload half (nodes,
    models, requests, seed, zipf) must be identical across the directory
    policies being compared — :func:`FleetSim.trace` is a pure function
    of it, so equal configs replay equal traces."""
    n_nodes: int = 100
    n_models: int = 60
    n_sharded: int = 4          # models stored sharded (gather path);
                                # the hot key (zipf rank 0) is one of them
    data_shards: int = 8        # shards per sharded model
    n_requests: int = 6000
    rate_rps: float = 400.0     # fleet-wide arrival rate (virtual clock)
    seed: int = 7
    zipf_s: float = 1.1
    min_model_mb: int = 48
    max_model_mb: int = 384
    node_capacity: int = 6      # LRU-resident models per node
    directory: str = "sharded"  # "single" | "sharded"
    n_dir_shards: int = 32
    vnodes: int = 8
    n_views: int = 2            # replicated directory views (sharded);
                                # the single baseline always runs one
    sync_every_s: float = 0.25  # anti-entropy cadence between the views
    faults: Tuple[Fault, ...] = DEFAULT_FAULTS
    # -- workload shape (DESIGN.md §13) -- the trace stays a pure function
    # of these knobs, so a planner/no-planner A/B replays the same trace
    workload: str = "poisson"   # "poisson" | "diurnal" | "bursty"
    period_s: float = 6.0       # burst period for diurnal/bursty keys
    duty_frac: float = 0.2      # active fraction of each period (diurnal)
    burst_len_s: float = 0.4    # arrival spread of one bursty spike
    n_phases: int = 4           # models stagger across this many phases
    n_home_nodes: int = 3       # per-model affinity set (router locality)
    stray_frac: float = 0.05    # arrivals routed off the home set
    # -- predictive placement (DESIGN.md §13) --
    planner: bool = False
    plan_every_s: float = 0.25
    planner_cfg: Optional[PlannerConfig] = None
    steady_after_s: float = 0.0  # p99_steady_s grades arrivals after this
                                 # (excludes the planner's learning phase)


class SimMember:
    """Registry stand-in for a ClusterNode: the directory only needs a
    ``name`` and an idempotent ``detach()``."""

    __slots__ = ("name", "detached")

    def __init__(self, name: str):
        self.name = name
        self.detached = 0

    def detach(self) -> None:
        self.detached += 1


class _SimNode:
    __slots__ = ("name", "idx", "view", "alive", "resident", "member",
                 "pending")

    def __init__(self, name: str, idx: int, view: int):
        self.name = name
        self.idx = idx
        self.view = view            # which directory view this node talks to
        self.alive = True
        self.resident: "OrderedDict[ModelKey, bool]" = OrderedDict()  # LRU
        self.member = SimMember(name)
        # keys with a fetch/gather in flight -> demand arrival times
        # coalesced onto it (the MRM LoadFuture semantics: one load, many
        # waiters); resolved when the fetch completes
        self.pending: Dict[ModelKey, List[float]] = {}


class _Gather:
    __slots__ = ("key", "node", "sources", "done_t", "replanned")

    def __init__(self, key, node, sources, done_t):
        self.key = key
        self.node = node
        self.sources: Set[str] = sources
        self.done_t = done_t
        self.replanned = False


class FleetSim:
    """One deterministic fleet run against one directory policy."""

    def __init__(self, cfg: FleetConfig, hw: Optional[HardwareModel] = None):
        self.cfg = cfg
        # datasheet constants: the run must be identical on every host
        self.hw = hw or HardwareModel()
        self.keys = [ModelKey("jax", f"m{i:03d}") for i in range(cfg.n_models)]
        rng = random.Random(cfg.seed * 1000003 + 1)
        lo, hi = cfg.min_model_mb << 20, cfg.max_model_mb << 20
        self.sizes = {k: rng.randrange(lo, hi) for k in self.keys}
        self.sharded: Set[ModelKey] = set(self.keys[:cfg.n_sharded])
        self.hot_key = self.keys[0]
        self.n_views = 1 if cfg.directory == "single" else max(1, cfg.n_views)
        self.views = [make_directory(cfg.directory)
                      if cfg.directory == "single"
                      else make_directory(cfg.directory,
                                          n_shards=cfg.n_dir_shards,
                                          vnodes=cfg.vnodes, name=f"view{v}")
                      for v in range(self.n_views)]
        self.nodes = [_SimNode(f"node{i:03d}", i, i % self.n_views)
                      for i in range(cfg.n_nodes)]
        # simulated data-plane truth the directory answers are graded on
        self.truth: Dict[ModelKey, Set[str]] = {k: set() for k in self.keys}
        self.shard_truth: Dict[Tuple[ModelKey, int], Set[str]] = {}
        # per-(view, dir-shard) service queues: busy-until + busy total
        self.q_free: Dict[Tuple[int, int], float] = {}
        self.q_busy: Dict[Tuple[int, int], float] = {}
        self.metrics = {
            "opens": 0, "warm_hits": 0, "cold_opens": 0,
            "peer_fetches": 0, "cloud_fetches": 0, "misfetches": 0,
            "corrective_withdraws": 0, "dir_ops": 0,
            "gathers_started": 0, "gathers_completed": 0,
            "gathers_interrupted": 0, "gathers_replanned": 0,
            "gathers_failed": 0, "sync_rounds": 0, "sync_records": 0,
            "sync_time_s": 0.0, "drops": 0, "flood_hints": 0,
            # predictive placement (DESIGN.md §13): planner-driven work
            # is accounted separately — it is background traffic, never a
            # demand cold-open
            "planner_prefetches": 0, "planner_shard_copies": 0,
            "planner_rebalanced_shards": 0, "planner_actions": 0,
            "coalesced_opens": 0,
        }
        # per-request (arrival time, modeled service latency): warm
        # dispatch floor, or the wait until the coalesced fetch/gather
        # completes — the p99 surface the §13 bench grades
        self.lat_events: List[Tuple[float, float]] = []
        self.planner: Optional[PlacementPlanner] = None
        if cfg.planner:
            # bin = one duty window: a whole burst lands in 1-2 bins, so
            # sparse tail models still read as solid periodic runs. The
            # duty window depends on the workload: diurnal keys are
            # active for duty_frac of each period, bursty spikes span
            # burst_len_s.
            duty_s = (cfg.burst_len_s if cfg.workload == "bursty"
                      else cfg.period_s * cfg.duty_frac)
            pcfg = cfg.planner_cfg or PlannerConfig(
                bin_s=max(0.05, duty_s),
                lead_s=max(2 * cfg.plan_every_s, duty_s),
                fanout=cfg.n_home_nodes,
                replicate_min_gathers=2,
                min_arrivals=4)
            self.planner = PlacementPlanner(directory=self.views[0],
                                            cfg=pcfg,
                                            clock=lambda: self._now)
        self._rng = random.Random(cfg.seed * 1000003 + 2)
        self._partition_until = -1.0
        self._armed_kill: Optional[str] = None
        self._kill_time: Optional[float] = None
        self._hot_clean_t: Optional[float] = None
        self._hot_open_after_kill_t: Optional[float] = None
        self._inflight: List[_Gather] = []
        self._events: List[tuple] = []
        self._seq = 0
        self._now = 0.0

    # ------------------------------------------------------------ trace
    def trace(self) -> List[Tuple[float, int, int]]:
        """The seeded arrival trace ``(time, node index, key index)`` —
        a pure function of the workload config, byte-identical across
        directory policies and across the planner A/B (the comparability
        contract). ``poisson`` is the §10 uniform fleet-wide stream;
        ``diurnal`` confines each model's arrivals to a periodic duty
        window; ``bursty`` fires tight periodic spikes over a thin
        background — both periodic shapes route through a per-model home
        -node set (router affinity), which is what gives the planner a
        placement target."""
        cfg = self.cfg
        rng = random.Random(cfg.seed)
        weights = [1.0 / (r + 1) ** cfg.zipf_s for r in range(cfg.n_models)]
        if cfg.workload == "poisson":
            t = 0.0
            out = []
            for _ in range(cfg.n_requests):
                t += rng.expovariate(cfg.rate_rps)
                out.append((t, rng.randrange(cfg.n_nodes),
                            rng.choices(range(cfg.n_models),
                                        weights=weights)[0]))
            return out
        if cfg.workload not in ("diurnal", "bursty"):
            raise ValueError(f"unknown workload {cfg.workload!r}")
        horizon = cfg.n_requests / cfg.rate_rps
        wsum = sum(weights)
        homes = {m: rng.sample(range(cfg.n_nodes),
                               min(cfg.n_home_nodes, cfg.n_nodes))
                 for m in range(cfg.n_models)}

        def pick_node(m: int) -> int:
            if rng.random() < cfg.stray_frac:
                return rng.randrange(cfg.n_nodes)
            hs = homes[m]
            return rng.choices(hs, weights=[2.0 ** (len(hs) - j)
                                            for j in range(len(hs))])[0]

        events: List[Tuple[float, int, int]] = []
        for m in range(cfg.n_models):
            mean_rate = cfg.rate_rps * weights[m] / wsum
            phase = (m % cfg.n_phases) * cfg.period_s / cfg.n_phases
            if cfg.workload == "diurnal":
                # all of the model's traffic lands inside its duty window
                window = cfg.duty_frac * cfg.period_s
                in_rate = mean_rate / cfg.duty_frac
                start = phase
                while start < horizon:
                    t = start
                    while True:
                        t += rng.expovariate(in_rate)
                        if t >= start + window:
                            break
                        events.append((t, pick_node(m), m))
                    start += cfg.period_s
            else:  # bursty: periodic spikes over a thin poisson background
                burst_n = max(1, round(0.8 * mean_rate * cfg.period_s))
                start = phase
                while start < horizon:
                    for _ in range(burst_n):
                        events.append((start + rng.uniform(0, cfg.burst_len_s),
                                       pick_node(m), m))
                    start += cfg.period_s
                bg_rate = 0.2 * mean_rate
                t = 0.0
                while True:
                    t += rng.expovariate(bg_rate)
                    if t >= horizon:
                        break
                    events.append((t, pick_node(m), m))
        events.sort(key=lambda e: e[0])
        return events

    # ------------------------------------------------- directory op costs
    def _qid(self, view: int, key: Optional[ModelKey]) -> Tuple[int, int]:
        d = self.views[view]
        sid = d.shard_of(key) if key is not None and hasattr(d, "shard_of") \
            else 0
        return (view, sid)

    def _charge_op(self, view: int, key: Optional[ModelKey],
                   now: float) -> float:
        """Queue one placement op at the owning shard of ``key`` on
        ``view``; returns the client-observed completion time."""
        qid = self._qid(view, key)
        start = max(now, self.q_free.get(qid, 0.0))
        self.q_free[qid] = start + self.hw.dir_op_s
        self.q_busy[qid] = self.q_busy.get(qid, 0.0) + self.hw.dir_op_s
        self.metrics["dir_ops"] += 1
        return self.hw.directory_op_time(queue_s=start - now) + now

    def _charge_broadcast(self, view: int, now: float) -> float:
        """A membership op (drop_node) touches EVERY shard of a view —
        the single-map directory pays it once on its only queue, which
        is also the queue every other op waits behind."""
        d = self.views[view]
        n = getattr(d, "n_shards", 1)
        done = now
        for sid in range(n):
            qid = (view, sid)
            start = max(now, self.q_free.get(qid, 0.0))
            self.q_free[qid] = start + self.hw.dir_op_s
            self.q_busy[qid] = self.q_busy.get(qid, 0.0) + self.hw.dir_op_s
            done = max(done, self.hw.directory_op_time(queue_s=start - now)
                       + now)
        self.metrics["dir_ops"] += n
        return done

    # ------------------------------------------------------- event plumbing
    def _push(self, t: float, kind: str, payload) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, kind, payload))

    # ---------------------------------------------------------- data plane
    def _reachable(self, view: int, now: float) -> List[int]:
        """Replica views a client on ``view`` can write through to.
        Placement writes go to ALL views best-effort (read-one /
        write-all-reachable, anti-entropy as the repair path); during a
        partition only the client's own view is reachable, and the
        divergence accrued in that window is what anti-entropy — and the
        mis-fetch meter — must absorb after the heal."""
        if now < self._partition_until:
            return [view]
        return list(range(self.n_views))

    def _publish(self, node: _SimNode, key: ModelKey, now: float) -> float:
        done = now
        for v in self._reachable(node.view, now):
            done = max(done, self._charge_op(v, key, now))
            self.views[v].publish(node.name, key, Tier.HOST)
            self.views[v].publish(node.name, key, Tier.DISK)
        return done

    def _withdraw(self, view: int, name: str, key: ModelKey,
                  now: float) -> None:
        for v in self._reachable(view, now):
            self._charge_op(v, key, now)
            self.views[v].withdraw(name, key, Tier.HOST)
            self.views[v].withdraw(name, key, Tier.DISK)

    def _insert_resident(self, node: _SimNode, key: ModelKey,
                         now: float) -> None:
        node.resident[key] = True
        node.resident.move_to_end(key)
        self.truth[key].add(node.name)
        self._publish(node, key, now)
        while len(node.resident) > self.cfg.node_capacity:
            victim, _ = node.resident.popitem(last=False)  # LRU
            self.truth[victim].discard(node.name)
            self._withdraw(node.view, node.name, victim, now)

    def _probe_holders(self, node: _SimNode, key: ModelKey,
                       answer: List[Tuple[str, Tier]],
                       now: float) -> Tuple[Optional[str], float]:
        """Walk the directory's answer until a holder checks out against
        the truth. Every dead/stale entry costs one wasted peer RTT, one
        mis-fetch count, and a corrective withdraw (negative feedback —
        the probe knows the hint is wrong, so the view stops serving it;
        the shard-cache analogue is ``_forget_local_shard``)."""
        penalty = 0.0
        for name, tier in answer:
            if name == node.name:
                continue
            if name in self.truth[key]:
                return name, penalty
            penalty += self.hw.peer_rtt
            self.metrics["misfetches"] += 1
            self.metrics["corrective_withdraws"] += 1
            self._withdraw(node.view, name, key, now)
        return None, penalty

    # --------------------------------------------------------------- opens
    def _handle_arrival(self, now: float, node: _SimNode,
                        key: ModelKey) -> None:
        if not node.alive:
            return  # requests routed to a dead node are re-dispatched
        self.metrics["opens"] += 1
        if self.planner is not None:
            self.planner.observe(key, node=node.name, now=now)
        if key in node.resident:
            node.resident.move_to_end(key)
            self.metrics["warm_hits"] += 1
            self.lat_events.append((now, DISPATCH_S))
            if (key == self.hot_key and self._kill_time is not None
                    and self._hot_open_after_kill_t is None):
                self._hot_open_after_kill_t = now
            return
        self.metrics["cold_opens"] += 1
        waiting = node.pending.get(key)
        if waiting is not None:
            # a fetch/gather for this key is already in flight here:
            # coalesce (LoadFuture semantics) instead of double-fetching
            waiting.append(now)
            self.metrics["coalesced_opens"] += 1
            return
        d = self.views[node.view]
        lookup_done = self._charge_op(node.view, key, now)
        answer = d.holders(key, exclude=node.name)
        src, penalty = self._probe_holders(node, key, answer, now)
        nbytes = self.sizes[key]
        t0 = lookup_done + penalty
        if src is None and key in self.sharded:
            self._start_gather(node, key, t0, now)
            return
        if src is not None:
            # resident copies are HOST-warm: the peer streams at link rate
            fetch_s = self.hw.peer_fetch_time(nbytes, peer_disk=False)
            self.metrics["peer_fetches"] += 1
        else:
            fetch_s = self.hw.cloud_fetch_time(nbytes)
            self.metrics["cloud_fetches"] += 1
        node.pending[key] = [now]
        self._push(t0 + fetch_s, "fetch_done", (node.idx, key))

    def _start_gather(self, node: _SimNode, key: ModelKey, t0: float,
                      now: float) -> None:
        """Multi-source shard gather (§8 semantics on the sim's truth):
        one directory op returns the shard table's holders; scattered
        shard-cache copies stream disk-capped in parallel, holderless
        shards fall through to CLOUD."""
        self._charge_op(node.view, key, now)  # shard_holders: one shard view
        if self.planner is not None:
            self.planner.observe(key, node=node.name, now=now,
                                 kind="gather")
        d = self.views[node.view]
        per = self.sizes[key] // self.cfg.data_shards
        loads: Dict[str, float] = {}
        sources: Set[str] = set()
        wire = 0
        for i in range(self.cfg.data_shards):
            if node.name in self.shard_truth.get((key, i), ()):
                continue  # local shard-cache copy: free, no wire bytes (§8)
            holders = [n for n, _ in d.shard_holders(key, i,
                                                     exclude=node.name)
                       if n in self.shard_truth.get((key, i), ())]
            if holders:
                name = holders[0]
                loads[name] = loads.get(name, 0.0) \
                    + self.hw.peer_fetch_time(per, peer_disk=True)
                sources.add(name)
            else:
                loads["__cloud__"] = loads.get("__cloud__", 0.0) \
                    + self.hw.cloud_fetch_time(per)
            wire += per
        gather_s = self.hw.gather_time(loads.values(), wire)
        node.pending[key] = [now]
        g = _Gather(key, node.idx, sources, t0 + gather_s)
        self._inflight.append(g)
        self.metrics["gathers_started"] += 1
        if self._armed_kill is not None and self._armed_kill in sources:
            # the armed owner-death fires mid-gather, deterministically
            victim = self._armed_kill
            self._armed_kill = None
            self._push(t0 + 0.3 * max(gather_s, 1e-6), "kill", victim)
        self._push(g.done_t, "gather_done", g)

    def _handle_fetch_done(self, now: float, node_idx: int,
                           key: ModelKey) -> None:
        node = self.nodes[node_idx]
        if not node.alive:
            return
        # every open that coalesced onto this load waited until now
        for t_arr in node.pending.pop(key, []):
            self.lat_events.append((t_arr, now - t_arr))
        self._insert_resident(node, key, now)
        if (key == self.hot_key and self._kill_time is not None
                and self._hot_open_after_kill_t is None):
            self._hot_open_after_kill_t = now

    def _handle_gather_done(self, now: float, g: _Gather) -> None:
        if g.done_t > now + 1e-12:
            self._push(g.done_t, "gather_done", g)  # re-planned: fire later
            return
        self._inflight.remove(g)
        self.metrics["gathers_completed"] += 1
        self._handle_fetch_done(now, g.node, g.key)

    # ------------------------------------------------- predictive placement
    def _node_by_name(self, name: str) -> Optional[_SimNode]:
        for n in self.nodes:
            if n.name == name:
                return n
        return None

    def _handle_plan(self, now: float) -> None:
        """One planner tick (DESIGN.md §13): prepositions become modeled
        background fetches that land in the node's LRU like any other
        copy (they evict, they publish, they cost link time) — but they
        are never counted as demand cold-opens, and the trace is
        untouched, so the A/B against the reactive baseline is pure."""
        for act in self.planner.plan(now):
            self.metrics["planner_actions"] += 1
            key = act.key
            if act.kind == "preposition":
                for name in act.nodes:
                    node = self._node_by_name(name)
                    if (node is None or not node.alive
                            or key in node.resident
                            or key in node.pending):
                        continue
                    nbytes = self.sizes.get(key)
                    if nbytes is None:
                        continue
                    warm = any(n != name for n in self.truth[key])
                    fetch_s = (self.hw.peer_fetch_time(nbytes,
                                                       peer_disk=False)
                               if warm else self.hw.cloud_fetch_time(nbytes))
                    self.metrics["planner_prefetches"] += 1
                    # later demand arrivals coalesce onto this background
                    # fetch exactly as they would onto an MRM prefetch
                    node.pending[key] = []
                    self._push(now + fetch_s, "plan_fetch_done",
                               (node.idx, key))
            elif key in self.sharded:
                self._plan_shards(now, act)

    def _plan_shards(self, now: float, act) -> None:
        """Shard-level actuation: ``replicate`` copies the full shard set
        toward each gather-origin node; ``rebalance`` re-homes only the
        holderless shards round-robin across the survivors (CLOUD is the
        only source left for those)."""
        key, per = act.key, self.sizes[act.key] // self.cfg.data_shards
        jobs: Dict[str, List[int]] = {}
        if act.kind == "replicate":
            for name in act.nodes:
                missing = [i for i in range(self.cfg.data_shards)
                           if name not in self.shard_truth.get((key, i), ())]
                if missing:
                    jobs[name] = missing
        else:  # rebalance
            targets = [n for n in act.nodes
                       if self._node_by_name(n) is not None]
            if not targets:
                return
            holderless = [i for i in range(self.cfg.data_shards)
                          if not self.shard_truth.get((key, i))]
            for j, i in enumerate(holderless):
                jobs.setdefault(targets[j % len(targets)], []).append(i)
        counter = ("planner_shard_copies" if act.kind == "replicate"
                   else "planner_rebalanced_shards")
        for name, indices in jobs.items():
            node = self._node_by_name(name)
            if node is None or not node.alive:
                continue
            src_warm = any(self.shard_truth.get((key, i)) for i in indices)
            nbytes = per * len(indices)
            fetch_s = (self.hw.peer_fetch_time(nbytes, peer_disk=True)
                       if src_warm else self.hw.cloud_fetch_time(nbytes))
            self._push(now + fetch_s, "plan_shards_done",
                       (node.idx, key, tuple(indices), counter))

    def _handle_plan_fetch_done(self, now: float, node_idx: int,
                                key: ModelKey) -> None:
        node = self.nodes[node_idx]
        if not node.alive:
            return
        for t_arr in node.pending.pop(key, []):
            self.lat_events.append((t_arr, now - t_arr))
        if key not in node.resident:
            self._insert_resident(node, key, now)

    def _handle_plan_shards_done(self, now: float, payload) -> None:
        node_idx, key, indices, counter = payload
        node = self.nodes[node_idx]
        if not node.alive:
            return
        for i in indices:
            self.shard_truth.setdefault((key, i), set()).add(node.name)
            for v in self._reachable(node.view, now):
                self._charge_op(v, key, now)
                self.views[v].publish_shard(node.name, key, i, Tier.DISK)
        self.metrics[counter] += len(indices)

    # --------------------------------------------------------------- faults
    def _kill_node(self, now: float, name: str) -> None:
        node = next(n for n in self.nodes if n.name == name)
        if not node.alive:
            return
        node.alive = False
        self.metrics["drops"] += 1
        for key in list(node.resident):
            self.truth[key].discard(name)
        node.resident.clear()
        node.pending.clear()  # waiters die with the node (re-dispatched)
        for (key, idx), holders in self.shard_truth.items():
            holders.discard(name)
        # the failure detector reports to ONE view; the other learns the
        # death by anti-entropy (or pays mis-fetches until it does)
        self._charge_broadcast(0, now)
        self.views[0].drop_node(name)
        if name == self._victim_name():
            self._kill_time = now
            self._check_hot_clean(now)  # single view: clean at the drop
        # in-flight gathers sourcing the dead node re-plan the lost
        # shards onto CLOUD — they complete later, they never fail
        for g in list(self._inflight):
            if name in g.sources:
                g.sources.discard(name)
                per = self.sizes[g.key] // self.cfg.data_shards
                # each dead source carried ~1/n of the shards; re-plan
                # its share onto the cloud link
                share = max(1, self.cfg.data_shards
                            // max(1, len(g.sources) + 1))
                g.done_t = max(g.done_t, now) \
                    + self.hw.cloud_fetch_time(per * share)
                g.replanned = True
                self.metrics["gathers_interrupted"] += 1
                self.metrics["gathers_replanned"] += 1

    def _victim_name(self) -> Optional[str]:
        holders = self.shard_truth.get((self.hot_key, 0))
        return next(iter(holders)) if holders else self._last_victim

    def _handle_fault(self, now: float, fault: Fault) -> None:
        if fault.kind == "stale_flood":
            rng = random.Random(self.cfg.seed * 1000003 + 3)
            alive = [n for n in self.nodes if n.alive]
            for _ in range(fault.count):
                node = rng.choice(alive)
                key = self.keys[rng.randrange(len(self.keys))]
                if node.name in self.truth[key]:
                    continue  # a true hint is not a flood
                self.metrics["flood_hints"] += 1
                self._charge_op(node.view, key, now)
                self.views[node.view].publish(node.name, key, Tier.HOST)
        elif fault.kind == "partition":
            self._partition_until = now + fault.duration_s
        elif fault.kind == "kill_hot_owner":
            # a registry redeploy invalidates the fleet's cached whole
            # copies of the hot sharded model, forcing gathers; the shard
            # owner is then killed mid-gather (armed, fired at the next
            # gather start that sources it)
            victim = self._victim_name()
            if victim is None:
                return
            self._last_victim = victim
            for node in self.nodes:
                if node.alive and self.hot_key in node.resident:
                    del node.resident[self.hot_key]
                    self.truth[self.hot_key].discard(node.name)
                    self._withdraw(node.view, node.name, self.hot_key, now)
            self._armed_kill = victim
        elif fault.kind == "churn":
            rng = random.Random(self.cfg.seed * 1000003 + 4)
            candidates = [n.name for n in self.nodes
                          if n.alive and n.name != self._victim_name()]
            if candidates:
                self._kill_node(now, rng.choice(candidates))
        else:
            raise ValueError(f"unknown fault kind {fault.kind!r}")

    # ----------------------------------------------------------------- sync
    def _handle_sync(self, now: float) -> None:
        if self.n_views < 2:
            return
        if now < self._partition_until:
            return  # partitioned: the views keep drifting
        n = self.views[0].sync_with(self.views[1])
        self.metrics["sync_rounds"] += 1
        self.metrics["sync_records"] += n
        self.metrics["sync_time_s"] += self.hw.directory_sync_time(n)
        self._check_hot_clean(now)

    def _check_hot_clean(self, now: float) -> None:
        """Failover clock: the hot key's owner has failed over once no
        view lists the dead node for the hot key or any of its shards."""
        if self._kill_time is None or self._hot_clean_t is not None:
            return
        dead = self._last_victim
        if all(dead not in dict(v.holders(self.hot_key))
               and all(dead not in dict(v.shard_holders(self.hot_key, i))
                       for i in range(self.cfg.data_shards))
               for v in self.views):
            self._hot_clean_t = now

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        cfg = self.cfg
        self._last_victim: Optional[str] = None
        for v in self.views:
            for node in self.nodes:
                v.register(node.member)
        # scatter the sharded models' shard caches round-robin and
        # publish the placements to every view (pre-partition state)
        for key in sorted(self.sharded, key=self.keys.index):
            for i in range(cfg.data_shards):
                owner = self.nodes[(self.keys.index(key) + i)
                                   % len(self.nodes)]
                self.shard_truth[(key, i)] = {owner.name}
                for v in self.views:
                    v.publish_shard(owner.name, key, i, Tier.DISK)
        trace = self.trace()
        horizon = trace[-1][0]
        for t, node_idx, key_idx in trace:
            self._push(t, "arrival", (node_idx, key_idx))
        if self.n_views > 1:
            k = 1
            while k * cfg.sync_every_s < horizon + 1.0:
                self._push(k * cfg.sync_every_s, "sync", None)
                k += 1
        if self.planner is not None:
            k = 1
            while k * cfg.plan_every_s < horizon:
                self._push(k * cfg.plan_every_s, "plan", None)
                k += 1
        for fault in cfg.faults:
            self._push(fault.at_s, "fault", fault)
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            self._now = t
            if kind == "arrival":
                node_idx, key_idx = payload
                self._handle_arrival(t, self.nodes[node_idx],
                                     self.keys[key_idx])
            elif kind == "fetch_done":
                node_idx, key = payload
                self._handle_fetch_done(t, node_idx, key)
            elif kind == "gather_done":
                self._handle_gather_done(t, payload)
            elif kind == "plan":
                self._handle_plan(t)
            elif kind == "plan_fetch_done":
                node_idx, key = payload
                self._handle_plan_fetch_done(t, node_idx, key)
            elif kind == "plan_shards_done":
                self._handle_plan_shards_done(t, payload)
            elif kind == "sync":
                self._handle_sync(t)
            elif kind == "fault":
                self._handle_fault(t, payload)
            elif kind == "kill":
                self._kill_node(t, payload)
        # drain: converge the views, then grade them against each other
        for _ in range(2):
            self._handle_sync(self._now + cfg.sync_every_s)
            self._now += cfg.sync_every_s
        return self._report(horizon)

    # --------------------------------------------------------------- report
    def _views_agree(self) -> bool:
        if self.n_views < 2:
            return True
        a, b = self.views[0], self.views[1]
        for key in self.keys:
            if dict(a.holders(key)) != dict(b.holders(key)):
                return False
        for key in sorted(self.sharded, key=self.keys.index):
            for i in range(self.cfg.data_shards):
                if dict(a.shard_holders(key, i)) != \
                        dict(b.shard_holders(key, i)):
                    return False
        return True

    def _report(self, horizon: float) -> dict:
        m = dict(self.metrics)
        busy_max = max(self.q_busy.values(), default=0.0)

        def _p99(samples: List[float]) -> float:
            if not samples:
                return 0.0
            s = sorted(samples)
            return s[int(0.99 * (len(s) - 1))]

        lats = [lat for _, lat in self.lat_events]
        steady = [lat for t, lat in self.lat_events
                  if t >= self.cfg.steady_after_s]
        m.update({
            "policy": self.cfg.directory,
            "n_nodes": self.cfg.n_nodes,
            "n_views": self.n_views,
            "horizon_s": horizon,
            "planner": self.cfg.planner,
            "workload": self.cfg.workload,
            "cold_rate": m["cold_opens"] / max(1, m["opens"]),
            "mean_lat_s": (sum(lats) / len(lats)) if lats else 0.0,
            "p99_s": _p99(lats),
            # steady-state p99: arrivals after the planner's learning
            # window (>= min_bursts observed periods) — the §13 bench
            # grades this slice so a short trace's unavoidable first
            # cold wave doesn't drown the signal
            "p99_steady_s": _p99(steady),
            "dir_busy_max_s": busy_max,
            # batch-queue throughput: the ops the loaded shard serves per
            # busy second bound the whole directory's sustainable rate
            "dir_throughput_ops_s": (m["dir_ops"] / busy_max
                                     if busy_max > 0 else 0.0),
            "misfetch_rate": m["misfetches"] / max(1, m["cold_opens"]),
            "failover_s": (self._hot_clean_t - self._kill_time
                           if self._hot_clean_t is not None
                           and self._kill_time is not None else None),
            "hot_reopen_s": (self._hot_open_after_kill_t - self._kill_time
                             if self._hot_open_after_kill_t is not None
                             and self._kill_time is not None else None),
            "views_agree": self._views_agree(),
            "gathers_outstanding": len(self._inflight),
        })
        d = self.views[0]
        if hasattr(d, "shard_ops"):
            ops = d.shard_ops()
            mean = sum(ops) / max(1, len(ops))
            m["shard_balance"] = (max(ops) / mean) if mean else 0.0
        return m


def compare_policies(cfg: FleetConfig,
                     hw: Optional[HardwareModel] = None) -> Dict[str, dict]:
    """Run the SAME seeded trace against the single-map baseline and the
    sharded scale-out; returns ``{"single": report, "sharded": report}``."""
    out = {}
    for policy in ("single", "sharded"):
        sim = FleetSim(replace(cfg, directory=policy), hw=hw)
        out[policy] = sim.run()
    return out
