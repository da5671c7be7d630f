"""Directory scale-out: consistent-hash sharding + anti-entropy replication
(DESIGN.md §10).

The single-map :class:`~repro_torch.core.cluster.ClusterDirectory` serializes
every placement hint and lookup behind one lock — fine at 3 nodes, a
bottleneck and a single point of failure at fleet scale. This module
scales the control plane out while keeping the exact hint semantics the
cluster layer already relies on:

* :class:`DirectoryProtocol` — the surface ``ClusterNode``/``Cluster``
  (and the fleet simulator) program against. The single-map class
  satisfies it unchanged and stays available as the ``policy="single"``
  baseline via :func:`make_directory`.
* :class:`HashRing` — an N-virtual-node consistent-hash ring mapping each
  model key to the directory shard that owns its placement records.
  Removing a shard only re-homes the keys it owned.
* :class:`ShardedClusterDirectory` — placement state split across
  ``n_shards`` independently-locked shard views. Each shard carries its
  own ``generation`` epoch (seeded from the membership epoch, bumped by
  every drop that touches it) and versions every record with a lamport
  ``(counter, origin)`` pair plus the holding node's membership
  *incarnation*, so two divergent replicas of the directory can
  reconcile by anti-entropy (:meth:`ShardedClusterDirectory.sync_with`)
  without ever resurrecting a dropped node's hints: a membership
  tombstone out-versions every placement record of the dead incarnation.

Consistency model (unchanged from DESIGN.md §6): directory entries are
*hints*. A stale hint costs a re-planned fetch, never a wrong answer —
which is exactly why replicas may serve stale views during a partition
and reconcile after it heals instead of coordinating on every write.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, Iterable, List, Optional, Protocol, Set, Tuple

from repro_torch.core.cache import Tier
from repro_torch.core.mrm import ModelKey


class DirectoryProtocol(Protocol):
    """What the cluster layer needs from a placement directory.

    Both :class:`~repro_torch.core.cluster.ClusterDirectory` (``single``) and
    :class:`ShardedClusterDirectory` (``sharded``) satisfy this; the
    fleet simulator and the differential-oracle test drive either
    implementation through it interchangeably.
    """

    @property
    def generation(self) -> int: ...          # membership epoch (bumped per drop)

    def register(self, node) -> None: ...
    def node(self, name: str): ...
    def nodes(self) -> list: ...
    def drop_node(self, name: str) -> None: ...
    def publish(self, node_name: str, key: ModelKey, tier: Tier) -> None: ...
    def withdraw(self, node_name: str, key: ModelKey, tier: Tier) -> None: ...
    def publish_shard(self, node_name: str, key: ModelKey, index: int,
                      tier: Tier) -> None: ...
    def withdraw_shard(self, node_name: str, key: ModelKey, index: int,
                       tier: Optional[Tier] = None) -> None: ...
    def holders(self, key: ModelKey,
                exclude: Optional[str] = None) -> List[Tuple[str, Tier]]: ...
    def warmest(self, key: ModelKey,
                exclude: Optional[str] = None) -> Optional[Tuple[str, Tier]]: ...
    def tier_on(self, key: ModelKey, node_name: str) -> Optional[Tier]: ...
    def shard_holders(self, key: ModelKey, index: int,
                      exclude: Optional[str] = None) -> List[Tuple[str, Tier]]: ...
    def shards_on(self, key: ModelKey, node_name: str) -> List[int]: ...
    def shard_keys(self) -> List[ModelKey]: ...
    def stats(self) -> dict: ...


def _ring_hash(token: str) -> int:
    """Stable 64-bit ring position (blake2b — independent of PYTHONHASHSEED,
    so ownership is identical across processes and replicas)."""
    return int.from_bytes(
        hashlib.blake2b(token.encode(), digest_size=8).digest(), "big")


def _key_token(key: ModelKey) -> str:
    fw, name, ver = key
    return f"{fw}/{name}@{ver}"


class HashRing:
    """Consistent-hash ring: ``vnodes`` virtual points per shard id.

    ``owner(token)`` walks clockwise to the next virtual point. Removing
    a shard removes only its points, so only the keys it owned re-home
    (the property that makes directory-shard failover cheap)."""

    def __init__(self, shard_ids: Iterable[int], vnodes: int = 8):
        self.vnodes = vnodes
        self._points: List[Tuple[int, int]] = []   # (position, shard_id)
        for sid in shard_ids:
            self.add(sid)

    def add(self, sid: int) -> None:
        for v in range(self.vnodes):
            pos = _ring_hash(f"shard{sid}#{v}")
            bisect.insort(self._points, (pos, sid))

    def remove(self, sid: int) -> None:
        self._points = [(p, s) for p, s in self._points if s != sid]

    def shard_ids(self) -> Set[int]:
        return {s for _, s in self._points}

    def owner(self, token: str) -> int:
        if not self._points:
            raise LookupError("empty hash ring")
        pos = _ring_hash(token)
        i = bisect.bisect_right(self._points, (pos, -1))
        if i == len(self._points):
            i = 0  # wrap: first point clockwise
        return self._points[i][1]


class _Member:
    """Membership record: the node reference, a monotonically increasing
    incarnation (bumped by every drop AND every re-register), and the
    alive flag. Dead members stay as tombstones so anti-entropy can
    out-version a peer replica's stale placement hints."""

    __slots__ = ("node", "inc", "alive")

    def __init__(self, node, inc: int, alive: bool):
        self.node = node
        self.inc = inc
        self.alive = alive


class _ShardView:
    """One directory shard: its own lock, placement maps, lamport version
    counter and generation epoch. Records carry ``(ver, inc)`` — the
    lamport version of the write and the incarnation of the holding node
    at publish time — and an emptied-out record is kept as a tombstone so
    withdraws propagate through anti-entropy."""

    __slots__ = ("sid", "lock", "where", "shards", "gen", "ver", "ops")

    def __init__(self, sid: int, gen: int):
        self.sid = sid
        self.lock = threading.Lock()
        # key -> node name -> (tiers set, lamport ver, incarnation)
        self.where: Dict[ModelKey, Dict[str, list]] = {}
        # key -> shard index -> node name -> (tiers, ver, inc)
        self.shards: Dict[ModelKey, Dict[int, Dict[str, list]]] = {}
        self.gen = gen      # per-owner epoch, seeded from the membership epoch
        self.ver = 0        # lamport counter for records written here
        self.ops = 0        # placement ops served (bench accounting)

    def next_ver(self) -> int:
        self.ver += 1
        return self.ver


class ShardedClusterDirectory:
    """Consistent-hash-sharded placement directory (DESIGN.md §10).

    Placement state is split across ``n_shards`` :class:`_ShardView`\\ s
    by :class:`HashRing` ownership of the model key; each shard has its
    own lock, so hints and lookups for different keys never contend.
    Membership is a small global map under its own leaf lock (every shard
    consults it, no shard lock is ever held while taking it the other
    way: the order is always membership -> shard or shard only).

    Replication is by **anti-entropy**, not write coordination: a peer
    instance (a second view of the same logical directory) converges via
    :meth:`sync_with`, which merges membership first (higher incarnation
    wins; a tombstone beats a live record of the same incarnation) and
    then placement records (higher lamport version wins, ties broken by
    origin name; records of dead or superseded incarnations are purged).
    A partition simply means no sync calls — both views keep serving
    their (increasingly stale) hints, which is safe because hints only
    cost re-planned fetches — and a bounded number of sync rounds after
    the heal makes the views answer identically.

    ``generation`` keeps the generation contract of DESIGN.md §6: bumped by every
    ``drop_node``, compared by in-flight source plans. ``generation_of``
    exposes the owning shard's finer-grained epoch.
    """

    def __init__(self, n_shards: int = 32, vnodes: int = 8,
                 name: str = "dir0"):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.name = name
        self.n_shards = n_shards
        self.ring = HashRing(range(n_shards), vnodes=vnodes)
        self._member_lock = threading.Lock()   # leaf: never held over a shard
        self._members: Dict[str, _Member] = {}
        self._membership_epoch = 0
        self._views = [_ShardView(sid, 0) for sid in range(n_shards)]
        self._sync_stats = {"sync_rounds": 0, "records_merged": 0,
                            "records_purged": 0}

    # -- ownership ----------------------------------------------------------
    def shard_of(self, key: ModelKey) -> int:
        """Ring owner of ``key``'s placement records — the fleet simulator
        charges each directory op to this shard's service queue."""
        return self.ring.owner(_key_token(ModelKey(*key)))

    def _view(self, key: ModelKey) -> _ShardView:
        return self._views[self.shard_of(key)]

    # -- membership ---------------------------------------------------------
    @property
    def generation(self) -> int:
        """Membership epoch: bumped by every ``drop_node`` (DESIGN.md §6 —
        in-flight source plans snapshot and re-validate against it)."""
        with self._member_lock:
            return self._membership_epoch

    def generation_of(self, key: ModelKey) -> int:
        """The owning shard's epoch — bumped only by drops that touched
        that shard, so a plan over one key's sources can re-validate
        without being invalidated by unrelated membership churn."""
        v = self._view(ModelKey(*key))
        with v.lock:
            return v.gen

    def register(self, node) -> None:
        with self._member_lock:
            m = self._members.get(node.name)
            if m is not None and m.alive:
                raise KeyError(f"node {node.name!r} already registered")
            if m is None:
                self._members[node.name] = _Member(node, 1, True)
            else:  # re-register after a drop: a fresh incarnation, so any
                   # stale records of the old one stay dead through merges
                m.node, m.inc, m.alive = node, m.inc + 1, True

    def node(self, name: str):
        with self._member_lock:
            m = self._members.get(name)
            return m.node if m is not None and m.alive else None

    def nodes(self) -> list:
        with self._member_lock:
            return [m.node for m in self._members.values()
                    if m.alive and m.node is not None]

    def _alive_inc(self, name: str) -> Optional[int]:
        with self._member_lock:
            m = self._members.get(name)
            return m.inc if m is not None and m.alive else None

    def drop_node(self, name: str) -> None:
        """Tombstone the member, purge every placement record pointing at
        it, and bump the membership epoch plus each touched shard's
        epoch. Unknown names still move the epoch (cheap, safe — matches
        the single-map baseline)."""
        with self._member_lock:
            self._membership_epoch += 1
            m = self._members.get(name)
            node = m.node if m is not None else None
            if m is not None and m.alive:
                m.inc += 1
                m.alive = False
                m.node = None
        for v in self._views:
            with v.lock:
                v.gen += 1
                self._purge_name_locked(v, name)
        if node is not None:
            node.detach()

    @staticmethod
    def _purge_name_locked(v: _ShardView, name: str) -> None:
        for key in list(v.where):
            v.where[key].pop(name, None)
            if not v.where[key]:
                del v.where[key]
        for key in list(v.shards):
            table = v.shards[key]
            for idx in list(table):
                table[idx].pop(name, None)
                if not table[idx]:
                    del table[idx]
            if not table:
                del v.shards[key]

    # -- placement hints ----------------------------------------------------
    def _recheck_alive(self, node_name: str, inc: int, v: _ShardView,
                       key: ModelKey, index: Optional[int] = None) -> None:
        """Close the publish/drop race without nesting locks: the alive
        check ran before the shard write, so a concurrent ``drop_node``
        may have purged the shard *between* the two. Re-reading the
        incarnation after the write and purging our own record on
        mismatch restores the single-map atomicity (drop marks the
        member dead before purging, so one of the two purges wins)."""
        if self._alive_inc(node_name) == inc:
            return
        with v.lock:
            if index is None:
                holders = v.where.get(key, {})
            else:
                holders = v.shards.get(key, {}).get(index, {})
            rec = holders.get(node_name)
            if rec is not None and rec[2] == inc:
                del holders[node_name]

    def publish(self, node_name: str, key: ModelKey, tier: Tier) -> None:
        key = ModelKey(*key)
        inc = self._alive_inc(node_name)
        if inc is None:
            return  # dropped (or never-registered) nodes stay gone
        v = self._view(key)
        with v.lock:
            v.ops += 1
            rec = v.where.setdefault(key, {}).get(node_name)
            if rec is None or rec[2] != inc:
                rec = [set(), 0, inc]
                v.where[key][node_name] = rec
            rec[0].add(tier)
            rec[1] = v.next_ver()
        self._recheck_alive(node_name, inc, v, key)

    def withdraw(self, node_name: str, key: ModelKey, tier: Tier) -> None:
        key = ModelKey(*key)
        v = self._view(key)
        with v.lock:
            v.ops += 1
            rec = v.where.get(key, {}).get(node_name)
            if rec is None:
                return
            rec[0].discard(tier)
            rec[1] = v.next_ver()  # tombstone (empty tiers) must out-version

    def publish_shard(self, node_name: str, key: ModelKey, index: int,
                      tier: Tier) -> None:
        key = ModelKey(*key)
        inc = self._alive_inc(node_name)
        if inc is None:
            return
        v = self._view(key)
        with v.lock:
            v.ops += 1
            holders = v.shards.setdefault(key, {}).setdefault(index, {})
            rec = holders.get(node_name)
            if rec is None or rec[2] != inc:
                rec = [set(), 0, inc]
                holders[node_name] = rec
            rec[0].add(tier)
            rec[1] = v.next_ver()
        self._recheck_alive(node_name, inc, v, key, index)

    def withdraw_shard(self, node_name: str, key: ModelKey, index: int,
                       tier: Optional[Tier] = None) -> None:
        key = ModelKey(*key)
        v = self._view(key)
        with v.lock:
            v.ops += 1
            rec = v.shards.get(key, {}).get(index, {}).get(node_name)
            if rec is None:
                return
            if tier is None:
                rec[0].clear()
            else:
                rec[0].discard(tier)
            rec[1] = v.next_ver()

    # -- queries ------------------------------------------------------------
    @staticmethod
    def _warmest(tiers: Set[Tier]) -> Tier:
        return min(tiers, key=lambda t: t.value)

    def holders(self, key: ModelKey,
                exclude: Optional[str] = None) -> List[Tuple[str, Tier]]:
        key = ModelKey(*key)
        v = self._view(key)
        with v.lock:
            v.ops += 1
            out = [(name, self._warmest(rec[0]))
                   for name, rec in v.where.get(key, {}).items()
                   if rec[0] and name != exclude]
        return sorted(out, key=lambda nt: (nt[1].value, nt[0]))

    def warmest(self, key: ModelKey,
                exclude: Optional[str] = None) -> Optional[Tuple[str, Tier]]:
        held = self.holders(key, exclude=exclude)
        return held[0] if held else None

    def tier_on(self, key: ModelKey, node_name: str) -> Optional[Tier]:
        key = ModelKey(*key)
        v = self._view(key)
        with v.lock:
            v.ops += 1
            rec = v.where.get(key, {}).get(node_name)
            return self._warmest(rec[0]) if rec and rec[0] else None

    def shard_holders(self, key: ModelKey, index: int,
                      exclude: Optional[str] = None) -> List[Tuple[str, Tier]]:
        key = ModelKey(*key)
        v = self._view(key)
        with v.lock:
            v.ops += 1
            out = [(name, self._warmest(rec[0]))
                   for name, rec in v.shards.get(key, {}).get(index, {}).items()
                   if rec[0] and name != exclude]
        return sorted(out, key=lambda nt: (nt[1].value, nt[0]))

    def shards_on(self, key: ModelKey, node_name: str) -> List[int]:
        key = ModelKey(*key)
        v = self._view(key)
        with v.lock:
            v.ops += 1
            return sorted(idx for idx, holders
                          in v.shards.get(key, {}).items()
                          if node_name in holders and holders[node_name][0])

    def shard_keys(self) -> List[ModelKey]:
        """Keys with at least one live shard placement, across every
        directory shard — the placement planner's rebalance scan
        (DESIGN.md §13). One op charged per shard view walked."""
        out = set()
        for v in self._views:
            with v.lock:
                v.ops += 1
                out.update(key for key, table in v.shards.items()
                           if any(rec[0] for holders in table.values()
                                  for rec in holders.values()))
        return sorted(out)

    def stats(self) -> dict:
        models: Set[ModelKey] = set()
        placements = shard_placements = ops = 0
        for v in self._views:
            with v.lock:
                models.update(k for k, h in v.where.items()
                              if any(rec[0] for rec in h.values()))
                placements += sum(
                    1 for h in v.where.values()
                    for rec in h.values() if rec[0])
                shard_placements += sum(
                    1 for table in v.shards.values()
                    for holders in table.values()
                    for rec in holders.values() if rec[0])
                ops += v.ops
        with self._member_lock:
            n_nodes = sum(1 for m in self._members.values() if m.alive)
            gen = self._membership_epoch
        return {"models": len(models), "nodes": n_nodes,
                "placements": placements,
                "shard_placements": shard_placements, "generation": gen,
                "n_shards": self.n_shards, "placement_ops": ops,
                **self._sync_stats}

    # -- anti-entropy (DESIGN.md §10) ---------------------------------------
    def _export_members(self) -> Dict[str, Tuple[object, int, bool]]:
        with self._member_lock:
            return {name: (m.node, m.inc, m.alive)
                    for name, m in self._members.items()}

    def _import_members(self, snap: Dict[str, Tuple[object, int, bool]]
                        ) -> List[object]:
        """Merge a peer's membership view: higher incarnation wins; at the
        same incarnation a tombstone beats a live record (a drop is the
        stronger claim). Returns node refs newly learned dead, so the
        caller can detach them outside the lock."""
        to_detach = []
        with self._member_lock:
            for name, (node, inc, alive) in snap.items():
                m = self._members.get(name)
                if m is None:
                    self._members[name] = _Member(node, inc, alive)
                    continue
                if inc > m.inc or (inc == m.inc and m.alive and not alive):
                    if m.alive and not alive and m.node is not None:
                        to_detach.append(m.node)
                    m.inc, m.alive = inc, alive
                    m.node = node if alive else None
                elif m.node is None and alive and inc == m.inc:
                    m.node = node  # learn the in-process ref for a member
        return to_detach

    def _export_shard(self, sid: int):
        v = self._views[sid]
        with v.lock:
            where = {key: {n: (set(rec[0]), rec[1], rec[2])
                           for n, rec in holders.items()}
                     for key, holders in v.where.items()}
            shards = {key: {idx: {n: (set(rec[0]), rec[1], rec[2])
                                  for n, rec in holders.items()}
                            for idx, holders in table.items()}
                      for key, table in v.shards.items()}
            return where, shards, v.gen, v.ver

    @staticmethod
    def _merge_records(mine: Dict[str, list],
                       theirs: Dict[str, tuple],
                       alive_inc: Dict[str, int], v: _ShardView,
                       stats: dict) -> None:
        for name, (tiers, ver, inc) in theirs.items():
            cur_inc = alive_inc.get(name)
            if cur_inc is None or inc != cur_inc:
                stats["records_purged"] += 1
                continue  # dead or superseded incarnation: never resurrect
            rec = mine.get(name)
            if rec is None or (ver, inc) > (rec[1], rec[2]):
                mine[name] = [set(tiers), ver, inc]
                stats["records_merged"] += 1
            elif (ver, inc) == (rec[1], rec[2]) and tiers - rec[0]:
                # exact version tie from two origins: the union is the only
                # commutative resolution — both views converge to it, and a
                # later withdraw out-versions whatever was wrong
                rec[0] |= tiers
                stats["records_merged"] += 1

    def _import_shard(self, sid: int, where, shards, gen: int,
                      ver: int) -> None:
        alive_inc: Dict[str, int] = {}
        with self._member_lock:
            for name, m in self._members.items():
                if m.alive:
                    alive_inc[name] = m.inc
        v = self._views[sid]
        with v.lock:
            v.gen = max(v.gen, gen)
            v.ver = max(v.ver, ver)  # lamport: merged writes stay ordered
            for key, holders in where.items():
                self._merge_records(v.where.setdefault(key, {}), holders,
                                    alive_inc, v, self._sync_stats)
            for key, table in shards.items():
                mine_t = v.shards.setdefault(key, {})
                for idx, holders in table.items():
                    self._merge_records(mine_t.setdefault(idx, {}), holders,
                                        alive_inc, v, self._sync_stats)
            # purge records of nodes this view now knows are dead/superseded
            for key in list(v.where):
                for name in list(v.where[key]):
                    if alive_inc.get(name) != v.where[key][name][2]:
                        del v.where[key][name]
                        self._sync_stats["records_purged"] += 1
                if not v.where[key]:
                    del v.where[key]
            for key in list(v.shards):
                table = v.shards[key]
                for idx in list(table):
                    for name in list(table[idx]):
                        if alive_inc.get(name) != table[idx][name][2]:
                            del table[idx][name]
                            self._sync_stats["records_purged"] += 1
                    if not table[idx]:
                        del table[idx]
                if not table:
                    del v.shards[key]

    # -- wire-serializable anti-entropy (DESIGN.md §11) ---------------------
    def export_snapshot(self,
                        shard_ids: Optional[Iterable[int]] = None) -> dict:
        """Msgpack-safe snapshot of membership plus the selected shards'
        records (all shards when None) — the transport-carried half of
        :meth:`sync_with`, so two directory replicas in *separate
        processes* can reconcile by exchanging snapshots over RPC. Keys
        become 3-lists, tiers their enum values; node refs are replaced
        by the member's advertised transport address (None for purely
        in-process members)."""
        members = {}
        with self._member_lock:
            for name, m in self._members.items():
                members[name] = [m.inc, m.alive,
                                 getattr(m.node, "address", None)]
        views = {}
        sids = range(self.n_shards) if shard_ids is None else shard_ids
        for sid in sids:
            where, shards, gen, ver = self._export_shard(sid)
            views[sid] = {
                "gen": gen, "ver": ver,
                "where": [[list(key), n, sorted(t.value for t in rec[0]),
                           rec[1], rec[2]]
                          for key, holders in where.items()
                          for n, rec in holders.items()],
                "shards": [[list(key), idx, n,
                            sorted(t.value for t in rec[0]), rec[1], rec[2]]
                           for key, table in shards.items()
                           for idx, holders in table.items()
                           for n, rec in holders.items()],
            }
        with self._member_lock:
            epoch = self._membership_epoch
        return {"n_shards": self.n_shards, "epoch": epoch,
                "members": members, "views": views}

    def merge_snapshot(self, snap: dict, resolver=None) -> int:
        """Merge a peer replica's :meth:`export_snapshot` (the receive
        half of transport-carried anti-entropy). ``resolver(name,
        address)`` supplies a node-like object (a ``PeerStub``) for
        members learned with a transport address; without one, remotely
        learned members resolve to None until they register locally.
        Same conflict rules as :meth:`sync_with`. Returns the number of
        records merged or purged."""
        if snap.get("n_shards") != self.n_shards:
            raise ValueError("peer views must agree on n_shards")
        before = (self._sync_stats["records_merged"]
                  + self._sync_stats["records_purged"])
        member_snap = {}
        for name, (inc, alive, address) in snap["members"].items():
            node = None
            if alive and address and resolver is not None:
                node = resolver(name, address)
            member_snap[name] = (node, inc, alive)
        for node in self._import_members(member_snap):
            node.detach()
        with self._member_lock:
            self._membership_epoch = max(self._membership_epoch,
                                         snap.get("epoch", 0))
        for sid_raw, view in snap["views"].items():
            sid = int(sid_raw)  # JSON-ish carriers stringify int keys
            where: Dict[ModelKey, Dict[str, tuple]] = {}
            for key3, name, tiers, ver, inc in view["where"]:
                where.setdefault(ModelKey(*key3), {})[name] = \
                    ({Tier(t) for t in tiers}, ver, inc)
            shards: Dict[ModelKey, Dict[int, Dict[str, tuple]]] = {}
            for key3, idx, name, tiers, ver, inc in view["shards"]:
                shards.setdefault(ModelKey(*key3), {}) \
                    .setdefault(idx, {})[name] = \
                    ({Tier(t) for t in tiers}, ver, inc)
            self._import_shard(sid, where, shards, view["gen"], view["ver"])
        self._sync_stats["sync_rounds"] += 1
        after = (self._sync_stats["records_merged"]
                 + self._sync_stats["records_purged"])
        return after - before

    def sync_with(self, other: "ShardedClusterDirectory",
                  shard_ids: Optional[Iterable[int]] = None) -> int:
        """One anti-entropy round against a peer view: merge membership
        both ways, then the selected shards' records both ways (all
        shards when ``shard_ids`` is None — a *partition* is simply the
        absence of these calls, or a subset of shards while it is
        partial). Snapshots are exchanged, never nested locks, so two
        concurrent rounds cannot deadlock. Returns the number of records
        exchanged (merge + purge on both sides) — the fleet simulator
        charges ``hw.directory_sync_time`` on it."""
        if other.n_shards != self.n_shards:
            raise ValueError("peer views must agree on n_shards")
        before = (self._sync_stats["records_merged"]
                  + self._sync_stats["records_purged"]
                  + other._sync_stats["records_merged"]
                  + other._sync_stats["records_purged"])
        for node in other._import_members(self._export_members()):
            node.detach()
        for node in self._import_members(other._export_members()):
            node.detach()
        with self._member_lock:
            epoch = self._membership_epoch
        with other._member_lock:
            epoch = max(epoch, other._membership_epoch)
            other._membership_epoch = epoch
        with self._member_lock:
            self._membership_epoch = epoch
        sids = range(self.n_shards) if shard_ids is None else shard_ids
        for sid in sids:
            mine = self._export_shard(sid)
            theirs = other._export_shard(sid)
            self._import_shard(sid, *theirs)
            other._import_shard(sid, *mine)
        self._sync_stats["sync_rounds"] += 1
        other._sync_stats["sync_rounds"] += 1
        after = (self._sync_stats["records_merged"]
                 + self._sync_stats["records_purged"]
                 + other._sync_stats["records_merged"]
                 + other._sync_stats["records_purged"])
        return after - before

    def shard_ops(self) -> List[int]:
        """Per-shard op counts (directory-load balance accounting)."""
        out = []
        for v in self._views:
            with v.lock:
                out.append(v.ops)
        return out


def make_directory(policy: str = "single", **kw) -> DirectoryProtocol:
    """Directory factory: ``"single"`` is the lock-guarded single map (the
    drop-in baseline), ``"sharded"`` the consistent-hash scale-out.
    Keyword args go to the sharded constructor (``n_shards``, ``vnodes``,
    ``name``)."""
    if policy == "single":
        from repro_torch.core.cluster import ClusterDirectory
        return ClusterDirectory()
    if policy == "sharded":
        return ShardedClusterDirectory(**kw)
    raise ValueError(f"unknown directory policy {policy!r}")
