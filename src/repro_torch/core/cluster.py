"""Cluster-wide model sharing (paper §4.2 multi-node, DESIGN.md §6, §8).

Single-node TrIMS makes every process on a machine share one copy of a
model; this module makes every *machine* in a cluster share the work of
fetching one. A :class:`ClusterDirectory` tracks which node holds which
model (and which **shards** of it) at which tier, and each
:class:`ClusterNode` plugs a source-selection hook into its MRM's
DISK-miss path: pull the model over the modeled peer link from a node that
already holds it when the cost model says that beats the CLOUD tier, or —
for sharded manifests — **gather** the shards from several sources in
parallel (peer A ∥ peer B ∥ cloud), assembling them into one local file
(DESIGN.md §8 collective staging).

Directory consistency (DESIGN.md §6): entries are *hints*, maintained by
tier-cache listeners (publish on insert, withdraw on remove) plus a DISK
publish whenever a model lands on a node's local store. A stale hint is
safe — peer fetch re-verifies the peer's disk copy before transferring and
returns the miss to the MRM's CLOUD fall-through; a stale *shard* hint
falls back to the CLOUD copy of that shard without aborting the gather.
Every ``drop_node`` bumps the directory ``generation``; source plans carry
the generation they were made at and re-validate on mismatch, so an
in-flight fetch never charges a link to a node that has left the cluster.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.cache import Tier
from repro_torch.core.codec import get_codec, sample_ratio
from repro_torch.core.mrm import MRM, ModelKey, _accepts_kwarg
from repro_torch.core.objectstore import shard_ranges
from repro_torch.core.pipeline import PipelineReport, run_pipeline
from repro_torch.core.store import atomic_dest_file


class _StaleSourceError(LookupError):
    """A planned fetch source went away (dropped node / vanished copy)."""


class ClusterDirectory:
    """Cluster-wide map: model key -> {node name -> tiers held}, plus the
    per-shard table key -> shard index -> {node -> tiers}. Thread-safe.

    The directory lock is a *leaf* lock: publish/withdraw are called from
    tier-cache listeners (under a cache lock) and never call back into any
    cache, so the only lock order is cache -> directory.

    Hints can never resurrect a dropped node: ``publish``/``publish_shard``
    ignore node names that are not currently registered, and ``drop_node``
    bumps :attr:`generation` so in-flight source plans re-validate.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._where: Dict[ModelKey, Dict[str, Set[Tier]]] = {}
        self._shards: Dict[ModelKey, Dict[int, Dict[str, Set[Tier]]]] = {}
        self._nodes: Dict[str, "ClusterNode"] = {}
        self._generation = 0

    @property
    def generation(self) -> int:
        """Monotonic membership epoch: bumped by every ``drop_node``.
        Source plans snapshot it and re-validate on mismatch (§8)."""
        with self._lock:
            return self._generation

    # -- membership ---------------------------------------------------------
    def register(self, node: "ClusterNode"):
        with self._lock:
            if node.name in self._nodes:
                raise KeyError(f"node {node.name!r} already registered")
            self._nodes[node.name] = node

    def node(self, name: str) -> Optional["ClusterNode"]:
        with self._lock:
            return self._nodes.get(name)

    def nodes(self) -> List["ClusterNode"]:
        with self._lock:
            return list(self._nodes.values())

    def drop_node(self, name: str):
        """Remove a node and every placement hint (whole-model and shard)
        pointing at it; the node's cache listeners and remote-fetch hook
        are detached so it cannot republish itself into the directory, and
        the directory generation is bumped so in-flight source plans
        re-validate instead of charging the dead link."""
        with self._lock:
            node = self._nodes.pop(name, None)
            self._generation += 1
            for key in list(self._where):
                self._where[key].pop(name, None)
                if not self._where[key]:
                    del self._where[key]
            for key in list(self._shards):
                table = self._shards[key]
                for idx in list(table):
                    table[idx].pop(name, None)
                    if not table[idx]:
                        del table[idx]
                if not table:
                    del self._shards[key]
        if node is not None:
            node.detach()

    # -- placement hints ------------------------------------------------------
    def publish(self, node_name: str, key: ModelKey, tier: Tier):
        key = ModelKey(*key)
        with self._lock:
            if node_name not in self._nodes:
                return  # dropped (or never-registered) nodes stay gone
            self._where.setdefault(key, {}).setdefault(node_name, set()).add(tier)

    def withdraw(self, node_name: str, key: ModelKey, tier: Tier):
        key = ModelKey(*key)
        with self._lock:
            holders = self._where.get(key)
            if not holders:
                self._where.pop(key, None)  # prune an emptied-out entry
                return
            tiers = holders.get(node_name)
            if tiers is None:
                return
            tiers.discard(tier)
            if not tiers:
                del holders[node_name]
            if not holders:
                del self._where[key]

    def publish_shard(self, node_name: str, key: ModelKey, index: int,
                      tier: Tier):
        """Record that ``node_name`` holds shard ``index`` of ``key`` at
        ``tier`` (same hint semantics as :meth:`publish`)."""
        key = ModelKey(*key)
        with self._lock:
            if node_name not in self._nodes:
                return
            self._shards.setdefault(key, {}).setdefault(index, {}) \
                .setdefault(node_name, set()).add(tier)

    def withdraw_shard(self, node_name: str, key: ModelKey, index: int,
                       tier: Optional[Tier] = None):
        """Drop ``node_name``'s hint for one shard (all tiers when
        ``tier`` is None)."""
        key = ModelKey(*key)
        with self._lock:
            table = self._shards.get(key)
            if not table or index not in table:
                return
            tiers = table[index].get(node_name)
            if tiers is None:
                return
            if tier is None:
                tiers.clear()
            else:
                tiers.discard(tier)
            if not tiers:
                del table[index][node_name]
            if not table[index]:
                del table[index]
            if not table:
                del self._shards[key]

    # -- queries --------------------------------------------------------------
    def holders(self, key: ModelKey,
                exclude: Optional[str] = None) -> List[Tuple[str, Tier]]:
        """``(node_name, warmest_tier)`` per holding node, warmest first."""
        key = ModelKey(*key)
        with self._lock:
            out = [(name, min(tiers, key=lambda t: t.value))
                   for name, tiers in self._where.get(key, {}).items()
                   if tiers and name != exclude]
        return sorted(out, key=lambda nt: (nt[1].value, nt[0]))

    def warmest(self, key: ModelKey,
                exclude: Optional[str] = None) -> Optional[Tuple[str, Tier]]:
        held = self.holders(key, exclude=exclude)
        return held[0] if held else None

    def tier_on(self, key: ModelKey, node_name: str) -> Optional[Tier]:
        """Warmest tier ``node_name`` holds ``key`` at, or None."""
        key = ModelKey(*key)
        with self._lock:
            tiers = self._where.get(key, {}).get(node_name)
            return min(tiers, key=lambda t: t.value) if tiers else None

    def shard_holders(self, key: ModelKey, index: int,
                      exclude: Optional[str] = None) -> List[Tuple[str, Tier]]:
        """``(node_name, warmest_tier)`` per node holding shard ``index``
        of ``key`` (explicit shard placements only — whole-model holders
        serve every shard and are listed by :meth:`holders`)."""
        key = ModelKey(*key)
        with self._lock:
            table = self._shards.get(key, {}).get(index, {})
            out = [(name, min(tiers, key=lambda t: t.value))
                   for name, tiers in table.items()
                   if tiers and name != exclude]
        return sorted(out, key=lambda nt: (nt[1].value, nt[0]))

    def shards_on(self, key: ModelKey, node_name: str) -> List[int]:
        """Shard indices ``node_name`` holds explicit placements for."""
        key = ModelKey(*key)
        with self._lock:
            return sorted(idx for idx, holders
                          in self._shards.get(key, {}).items()
                          if node_name in holders and holders[node_name])

    def shard_keys(self) -> List[ModelKey]:
        """Keys with at least one live shard placement — the planner's
        rebalance scan walks this instead of guessing the catalogue
        (DESIGN.md §13)."""
        with self._lock:
            return sorted(key for key, table in self._shards.items()
                          if any(holders.get(n)
                                 for holders in table.values()
                                 for n in holders))

    def stats(self) -> dict:
        with self._lock:
            return {"models": len(self._where), "nodes": len(self._nodes),
                    "placements": sum(len(h) for h in self._where.values()),
                    "shard_placements": sum(
                        len(holders) for table in self._shards.values()
                        for holders in table.values()),
                    "generation": self._generation}


class ClusterNode:
    """One machine in the cluster: an MRM plus directory/peer-fetch wiring.

    Construction registers the node with the directory, publishes its disk
    contents, subscribes listeners on the MRM's DEVICE/HOST tier caches, and
    installs :meth:`fetch_for` as the MRM's ``remote_fetch`` hook so every
    DISK miss source-selects between the peer link, a multi-source shard
    gather (§8), and the CLOUD tier.
    """

    #: in-process peers keep modeled link times; ``noded.PeerStub`` (the
    #: same surface over a socket) sets True and its reads are *measured*
    remote = False

    def __init__(self, name: str, mrm: MRM,
                 directory: "ClusterDirectory",  # any DirectoryProtocol impl
                 peer_fetch: bool = True,
                 peer_codec=None,  # codec name or a tuned Codec instance
                 gather: bool = True,
                 address: Optional[str] = None):
        self.name = name
        self.mrm = mrm
        self.directory = directory
        # transport address peers reach this node's daemon at (None for
        # purely in-process clusters); carried through directory
        # registration so remote planners can build PeerStubs
        self.address = address
        self.hw = mrm.hw
        self.peer_fetch_enabled = peer_fetch
        self.gather_enabled = gather
        # wire codec for peer transfers (None = raw copy). The cost compare
        # estimates the ratio from the CLOUD manifest when it knows the key
        # (falls back to sampling the peer's file), and the actual transfer
        # runs compress/decompress as overlapped pipeline stages.
        # keep the Codec OBJECT (a tuned instance must not be flattened to
        # its registry default via the name); peer_codec exposes the name
        self._peer_codec = get_codec(peer_codec) if peer_codec else None
        self.peer_codec = self._peer_codec.name if self._peer_codec else None
        # per-key wire-ratio cache: models are version-keyed and immutable,
        # so a sampled estimate never goes stale — without it every DISK
        # miss would re-compress a 1 MiB sample per candidate holder
        self._ratio_cache: Dict[ModelKey, float] = {}
        # cloud downloads are counted by the MRM (metrics["cloud_downloads"])
        # — the node only tracks the peer traffic it originates/serves
        self.metrics = {"peer_fetches": 0, "peer_serves": 0,
                        "bytes_from_peers": 0, "bytes_on_wire": 0,
                        # §8 collective staging
                        "gather_fetches": 0, "gather_coalesced": 0,
                        "shards_from_peers": 0, "shards_from_cloud": 0,
                        "shards_local": 0, "shard_serves": 0,
                        "gather_fallbacks": 0, "plan_replans": 0}
        self._metrics_lock = threading.Lock()  # leaf; never held over another
        # concurrent gathers of one key coalesce onto one set of shard
        # fetches: key -> Event carrying .ok once the primary finishes
        self._gather_lock = threading.Lock()
        self._gather_inflight: Dict[ModelKey, threading.Event] = {}
        # shard_fraction cache (router hot path): key -> locally-held
        # shard bytes, invalidated whenever the local shard set changes
        # — without it every Router.score stats every shard file
        self._shard_held: Dict[ModelKey, int] = {}
        self._shard_held_lock = threading.Lock()  # leaf
        directory.register(self)
        for key in mrm.disk.keys():
            directory.publish(name, ModelKey(*key), Tier.DISK)
        self._listeners = [(mrm.device, self._listener(Tier.DEVICE)),
                           (mrm.host, self._listener(Tier.HOST))]
        for cache, fn in self._listeners:
            cache.add_listener(fn)
        mrm.remote_fetch = self.fetch_for

    def detach(self) -> None:
        """Disconnect from the cluster: stop publishing residency changes
        and stop resolving DISK misses via peers. Idempotent; called by
        ``ClusterDirectory.drop_node``."""
        for cache, fn in self._listeners:
            cache.remove_listener(fn)
        self._listeners = []
        if self.mrm.remote_fetch == self.fetch_for:
            self.mrm.remote_fetch = None

    def _listener(self, tier: Tier):
        """Tier-cache listener keeping the directory in sync (fires under
        the cache lock; the directory lock is a leaf, so this is safe)."""
        def on_event(event: str, entry):
            if event == "insert":
                self.directory.publish(self.name, entry.key, tier)
                # a model entering DEVICE/HOST is necessarily on this
                # node's disk (the cold chain lands it there first)
                self.directory.publish(self.name, entry.key, Tier.DISK)
            else:
                self.directory.withdraw(self.name, entry.key, tier)
        return on_event

    # -- queries --------------------------------------------------------------
    def resident_tier(self, key: ModelKey) -> Optional[Tier]:
        """Warmest local tier holding ``key`` (DEVICE/HOST/DISK), or None."""
        key = ModelKey(*key)
        t = self.mrm.tiers.resident_tier(key)
        if t is not None:
            return t
        return Tier.DISK if self.mrm.disk.contains(key) else None

    # -- peer data-plane surface (DESIGN.md §11) ------------------------------
    # The narrow surface peers consume: ClusterNode serves it in-process,
    # and ``noded.PeerStub`` carries the identical surface over a
    # transport — so ``_pull_from_peer``, ``plan_shard_sources``, and the
    # gather's shard reads run unmodified against either.
    def has_model(self, key: ModelKey) -> bool:
        """Whole-model copy on this peer's local disk (hint verification)."""
        return self.mrm.disk.contains(ModelKey(*key))

    def model_nbytes(self, key: ModelKey) -> Optional[int]:
        """Size of the peer's whole-model copy, None when absent."""
        try:
            return os.path.getsize(self.mrm.disk.path_for(ModelKey(*key)))
        except OSError:
            return None

    def local_model_path(self, key: ModelKey) -> Optional[str]:
        """Filesystem path of the peer's copy — in-process-only escape
        hatch for the compressed peer wire (which reads the source file
        directly) and ratio sampling. Remote peers return None; their
        transfers stream raw chunks instead."""
        key = ModelKey(*key)
        path = self.mrm.disk.path_for(key)
        return path if os.path.exists(path) else None

    def read_model(self, key: ModelKey, write,
                   chunk_bytes: int = 4 << 20, ctx=None) -> int:
        """Serve the whole model file into ``write(bytes)`` chunk by
        chunk; returns the byte count. One ``peer_serves``. ``ctx`` is the
        requesting side's RequestContext (DESIGN.md §12): the serving node
        folds its deadline into its own eviction horizon, exactly as the
        socket daemon does for remote peers."""
        self._note_ctx(ctx)
        key = ModelKey(*key)
        total = 0
        with open(self.mrm.disk.path_for(key), "rb") as f:
            while True:
                chunk = f.read(chunk_bytes)
                if not chunk:
                    break
                write(chunk)
                total += len(chunk)
        self._note_serve("peer_serves")
        return total

    def read_model_ranges(self, key: ModelKey, ranges, ctx=None) -> bytes:
        """Serve byte ranges sliced out of the whole-model file (a
        shard's ranges, or a layer window). One ``shard_serves``."""
        self._note_ctx(ctx)
        key = ModelKey(*key)
        parts = []
        with open(self.mrm.disk.path_for(key), "rb") as f:
            for ro, rn in ranges:
                f.seek(ro)
                parts.append(f.read(rn))
        self._note_serve("shard_serves")
        return b"".join(parts)

    def read_shard(self, key: ModelKey, index: int, ctx=None) -> bytes:
        """Serve one shard-cache copy. One ``shard_serves``."""
        self._note_ctx(ctx)
        key = ModelKey(*key)
        with open(self._shard_path(key, index), "rb") as f:
            data = f.read()
        self._note_serve("shard_serves")
        return data

    def _note_serve(self, counter: str) -> None:
        with self._metrics_lock:
            self.metrics[counter] += 1

    def _note_ctx(self, ctx) -> None:
        """A data-plane serve carrying a RequestContext shapes THIS node's
        eviction horizon too — remote daemons see the same context local
        calls do (the socket server parses it off the wire frame)."""
        if ctx is not None and ctx.deadline_s is not None:
            self.mrm.note_deadline(ctx.deadline_s)

    # -- local shard cache (§8) ----------------------------------------------
    def _shard_path(self, key: ModelKey, index: int) -> str:
        fw, name, ver = key
        return os.path.join(self.mrm.disk.root, ".shards", fw,
                            f"{name}@{ver}", f"{index:06d}.shard")

    def has_shard(self, key: ModelKey, index: int) -> bool:
        return os.path.exists(self._shard_path(ModelKey(*key), index))

    def store_shard(self, key: ModelKey, index: int, data: bytes) -> None:
        """Pre-position one shard of ``key`` in this node's local shard
        cache and publish the placement (the scatter half of §8)."""
        key = ModelKey(*key)
        with atomic_dest_file(self._shard_path(key, index),
                              prefix=".shard-") as (fd, _):
            with os.fdopen(fd, "wb") as f:
                f.write(data)
        self.directory.publish_shard(self.name, key, index, Tier.DISK)
        with self._shard_held_lock:
            self._shard_held.pop(key, None)  # refreshed on next query

    def local_shards(self, key: ModelKey) -> List[int]:
        """Shard indices present in this node's local shard cache."""
        key = ModelKey(*key)
        d = os.path.dirname(self._shard_path(key, 0))
        if not os.path.isdir(d):
            return []
        out = []
        for fn in os.listdir(d):
            if fn.endswith(".shard"):
                try:
                    out.append(int(fn[:-len(".shard")]))
                except ValueError:
                    continue
        return sorted(out)

    def shard_fraction(self, key: ModelKey) -> float:
        """Fraction of ``key``'s bytes present in the local shard cache —
        the router's partial-residency signal (0.0 without a sharded
        CLOUD manifest to size against). Held bytes are cached per key
        and invalidated on every shard-set change, so the dispatch hot
        path pays one dict lookup, not one stat() per shard."""
        key = ModelKey(*key)
        obj = self.mrm.objectstore
        if obj is None or not hasattr(obj, "stat"):
            return 0.0
        with self._shard_held_lock:
            held = self._shard_held.get(key)
        if held is not None and held == 0:
            return 0.0  # common case: node holds nothing — skip the stat
        st = obj.stat(key)
        if not st or not st.get("shards"):
            return 0.0
        if held is None:
            held = sum(s["nbytes"] for s in st["shards"]
                       if self.has_shard(key, s["index"]))
            with self._shard_held_lock:
                self._shard_held[key] = held
        return held / max(1, st["nbytes"])

    def _forget_local_shard(self, key: ModelKey, index: int) -> None:
        """Drop one local shard copy and its placement hint (corrupt or
        superseded), invalidating the held-bytes cache."""
        key = ModelKey(*key)
        try:
            os.unlink(self._shard_path(key, index))
        except OSError:
            pass
        self.directory.withdraw_shard(self.name, key, index)
        with self._shard_held_lock:
            self._shard_held.pop(key, None)

    def _drop_local_shards(self, key: ModelKey) -> None:
        """Clear the local shard cache for ``key`` and withdraw the hints
        (a full local copy supersedes the shards)."""
        key = ModelKey(*key)
        for idx in self.local_shards(key):
            self._forget_local_shard(key, idx)
        d = os.path.dirname(self._shard_path(key, 0))
        if os.path.isdir(d) and not os.listdir(d):
            os.rmdir(d)

    # -- peer-to-peer fetch ---------------------------------------------------
    def _wire_ratio(self, key: ModelKey, peer) -> float:
        """Estimated compression ratio for the peer wire: the CLOUD
        manifest's real stored size when it recorded the SAME codec this
        wire uses (a different codec's ratio would distort the compare),
        else a one-chunk compression sample of the peer's file, memoized
        per key (content is version-keyed and immutable). 1.0 when the
        node has no wire codec or the peer exposes no local file to
        sample (a remote PeerStub)."""
        if self.peer_codec is None:
            return 1.0
        obj = self.mrm.objectstore
        if obj is not None and hasattr(obj, "stat"):
            st = obj.stat(key)
            if st and st.get("codec", "none") == self.peer_codec:
                return max(1.0, st["nbytes"] / max(1, st["stored_nbytes"]))
        ratio = self._ratio_cache.get(key)
        if ratio is None:
            src_path = peer.local_model_path(key)
            if src_path is None:
                return 1.0
            ratio = sample_ratio(src_path, self._peer_codec)
            self._ratio_cache[key] = ratio
        return ratio

    def _cheapest_peer(self, key: ModelKey):
        """(peer_node, peer_tier, modeled_s, nbytes, ratio) or None."""
        best = None
        for node_name, tier in self.directory.holders(key, exclude=self.name):
            peer = self.directory.node(node_name)
            if peer is None or not peer.has_model(key):
                continue  # stale hint — skip, CLOUD fall-through covers us
            nbytes = peer.model_nbytes(key)
            if nbytes is None:
                continue  # vanished between the two probes: stale hint
            peer_disk = tier == Tier.DISK
            t_raw = self.hw.peer_fetch_time(nbytes, peer_disk=peer_disk)
            t, use_ratio = t_raw, 1.0
            if not peer.remote:
                # a node with a wire codec still sends raw when that is
                # cheaper (fast links make the compress stage the
                # max-stage); remote peers always stream raw — the
                # compressed wire needs the source file in-process
                ratio = self._wire_ratio(key, peer)
                t_comp = self.hw.peer_fetch_time(nbytes,
                                                 peer_disk=peer_disk,
                                                 ratio=ratio)
                t, use_ratio = min((t_raw, 1.0), (t_comp, ratio))
            if best is None or t < best[2]:
                best = (peer, tier, t, nbytes, use_ratio)
        return best

    def _cloud_link_time(self, key: ModelKey, nbytes: int):
        """Modeled seconds to pull ``key`` from the CLOUD tier, using the
        holding store's OWN link constants (they are what the download will
        actually be charged at — the hw constants are only the default the
        stores were built from). A compression-aware store reports its
        pipelined compressed-wire cost (``modeled_fetch_s``). None when no
        cloud source holds the key."""
        for store in (self.mrm.cloud, self.mrm.objectstore):
            if store is not None and store.contains(key):
                modeled = getattr(store, "modeled_fetch_s", None)
                if modeled is not None:
                    return modeled(key)
                return store.rtt + nbytes / store.bw
        return None

    def _transfer_compressed(self, src: str, dst_tmp_fd: int
                             ) -> Tuple[int, PipelineReport]:
        """Move ``src`` over the modeled peer wire with the node's codec:
        peer read | compress | decompress | disk write as one chunked
        pipeline (the wire carries the compress stage's output). Returns
        (wire_bytes, report)."""
        comp = self._peer_codec.compressor()
        decomp = self._peer_codec.decompressor()
        chunk = self.mrm.staging_chunk_bytes
        size = os.path.getsize(src)
        offsets = list(range(0, size, chunk)) or [0]
        out = os.fdopen(dst_tmp_fd, "wb")
        try:
            with open(src, "rb") as fsrc:

                def peer_read(off):
                    fsrc.seek(off)
                    return fsrc.read(chunk)

                def compress(data):
                    return comp.compress(data)

                def decompress(data):
                    return decomp.decompress(data)

                def disk_write(data):
                    out.write(data)
                    return len(data)

                _, report = run_pipeline(
                    offsets,
                    [("peer_read", peer_read, len),
                     ("compress", compress, len),
                     ("decompress", decompress, len),
                     ("disk_write", disk_write)],
                    depth=2)
            tail = comp.flush()  # the codec's buffered remainder
            out.write(decomp.decompress(tail))
            out.write(decomp.flush())
        finally:
            out.close()
        wire_bytes = report.stage("compress").bytes + len(tail)
        return wire_bytes, report

    def _pull_from_peer(self, key: ModelKey, peer: "ClusterNode",
                        peer_tier: Tier, peer_s: float, nbytes: int,
                        ratio: float, timings, plan_gen: int,
                        ctx=None) -> bool:
        """Execute a planned single-source peer transfer. Returns False —
        without charging the link — when the plan went stale mid-flight
        (the peer left the cluster after ``plan_gen``, its copy vanished,
        or its daemon died/hung: every transport failure is an OSError);
        the caller re-plans."""
        dst = self.mrm.disk.path_for(key)
        wire_seconds = 0.0
        try:
            # unique temp name: concurrent fetches of one key must not
            # share a staging file (the loser's replace would raise) —
            # last writer wins
            with atomic_dest_file(dst, prefix=".peer-") as (fd, tmp):
                src = peer.local_model_path(key) if ratio > 1.0 else None
                if src is not None:
                    wire_bytes, report = self._transfer_compressed(src, fd)
                    timings.decompress_s += report.stage("decompress").busy_s
                    timings.stage_overlap_s += report.overlap_s()
                    # re-model at the ratio the wire actually saw
                    peer_s = self.hw.peer_fetch_time(
                        nbytes, peer_disk=peer_tier == Tier.DISK,
                        ratio=max(1.0, nbytes / max(1, wire_bytes)))
                    peer._note_serve("peer_serves")
                else:
                    t0 = time.perf_counter()
                    out = os.fdopen(fd, "wb")
                    try:
                        if ctx is not None and _accepts_kwarg(
                                peer.read_model, "ctx"):
                            got = peer.read_model(key, out.write, ctx=ctx)
                        else:  # legacy peer surface (test doubles)
                            got = peer.read_model(key, out.write)
                    finally:
                        out.close()
                    wire_seconds = time.perf_counter() - t0
                    if got != nbytes:
                        raise _StaleSourceError(
                            f"{peer.name}: sent {got} of {nbytes} bytes")
                    wire_bytes = nbytes
                # generation re-validation (§8 bugfix): a peer dropped
                # after planning must not be charged as a live link — the
                # data it "sent" is discarded and the fetch re-plans
                if (self.directory.generation != plan_gen
                        and self.directory.node(peer.name) is None):
                    raise _StaleSourceError(peer.name)
        except _StaleSourceError:
            with self._metrics_lock:
                self.metrics["plan_replans"] += 1
            return False
        except OSError:
            # the peer's copy vanished mid-transfer (stale hint), or the
            # transport to its daemon failed/timed out: re-plan
            return False
        timings.peer_s = peer_s
        if peer.remote:
            # a socket carried these bytes: record the measured wire and
            # feed the costmodel calibration (DESIGN.md §11)
            timings.wire_s += wire_seconds
            timings.wire_bytes += wire_bytes
            self.hw.observe_wire("peer", wire_bytes, wire_seconds)
        with self._metrics_lock:
            self.metrics["peer_fetches"] += 1
            self.metrics["bytes_from_peers"] += nbytes
            self.metrics["bytes_on_wire"] += wire_bytes
        with self.mrm._lock:
            self.mrm.metrics["peer_fetches"] += 1
            self.mrm.metrics["modeled_fetch_s"] += peer_s
        self.directory.publish(self.name, key, Tier.DISK)
        return True

    def fetch_for(self, key: ModelKey, timings, on_shard=None,
                  ctx=None) -> bool:
        """MRM ``remote_fetch`` hook: resolve a DISK miss from the cheapest
        source. Returns True when the model was pulled from the cluster (a
        peer, or a §8 multi-source gather); False hands the miss back to
        the MRM's CLOUD fall-through (which is also the answer when the
        cost model says the cloud link is cheaper). Both sides of the
        compare are compression-aware: the peer leg at the estimated wire
        ratio, the cloud leg at the blob's real stored size (DESIGN.md §6).
        Source plans re-validate against the directory generation and
        re-plan when the membership changed under them.

        ``on_shard(row, data)`` (streaming opens, DESIGN.md §9) fires per
        digest-verified shard as the gather assembles it, in plan order —
        layer-planned shards therefore announce readiness in execution
        order. Whole-file pulls (peer copy, coalesced gather) fire no
        callbacks; the caller streams from local disk once landed.

        ``ctx`` (optional RequestContext, DESIGN.md §12) rides on every
        peer data-plane call this fetch makes, so the serving daemons see
        the same tenant/deadline the local open carries."""
        key = ModelKey(*key)
        obj = self.mrm.objectstore
        if (self.gather_enabled and obj is not None
                and hasattr(obj, "stat")):
            st = obj.stat(key)
            if st and st.get("shards") and self._gather(key, st, timings,
                                                        on_shard, ctx=ctx):
                return True
        for _ in range(3):  # bounded re-plans on directory-epoch changes
            # snapshot the epoch BEFORE scanning holders: a node dropped
            # between the scan and a later snapshot would not trip the
            # mismatch check and the dead link would be charged
            plan_gen = self.directory.generation
            best = self._cheapest_peer(key) if self.peer_fetch_enabled \
                else None
            if best is None:
                return False  # the MRM's fall-through pays the CLOUD leg
            peer, peer_tier, peer_s, nbytes, ratio = best
            cloud_s = self._cloud_link_time(key, nbytes)
            source, _ = self.hw.pick_fetch_source(
                nbytes, have_peer=True, have_cloud=cloud_s is not None,
                peer_s=peer_s, cloud_s=cloud_s)
            if source != "peer":
                return False
            if self._pull_from_peer(key, peer, peer_tier, peer_s, nbytes,
                                    ratio, timings, plan_gen, ctx=ctx):
                return True
        return False

    # -- collective multi-source staging (§8) ---------------------------------
    def plan_shard_sources(self, key: ModelKey, st: dict):
        """Build a per-shard source plan for a sharded manifest entry.

        Candidates per shard: the local shard cache (free), every verified
        whole-model peer holder (serves any shard by slicing its file),
        explicit shard holders, and the CLOUD store. Shards are assigned
        greedily to the source whose accumulated link time stays smallest
        (LPT-style balancing), so the plan's modeled cost is
        ``hw.gather_time`` over the per-source loads — parallel links
        saturating at the local ingest bandwidth.

        Returns ``(rows, modeled_gather_s, plan_generation)`` or None when
        no source can supply some shard. Each row is ``{index, offset,
        nbytes, ranges, source: "local"|"peer"|"cloud", node, modeled_s}``.

        Layer-planned tables (``shard_plan="layers"``, DESIGN.md §9) are
        walked in **execution order** — window by window, largest shard
        first inside each window (LPT) — so the greedy assignment balances
        within a layer window and the fetch pipeline delivers readiness in
        the order the engine consumes layers. Classic fixed-size tables
        keep their index order (window defaults to the shard index).
        """
        shards = sorted(
            st["shards"],
            key=lambda s: (s.get("window", s["index"]), -s["nbytes"],
                           s["index"]))
        gen = self.directory.generation
        obj = self.mrm.objectstore
        cloud_ok = obj is not None and obj.contains(key)
        # verify whole-model holders once per plan, not once per shard
        full_holders = []
        for name, tier in self.directory.holders(key, exclude=self.name):
            peer = self.directory.node(name)
            if (self.peer_fetch_enabled and peer is not None
                    and peer.has_model(key)):
                full_holders.append((name, tier))
        load: Dict[tuple, float] = {}
        wire_bytes = 0  # bytes crossing the NIC (local shards are free)
        rows = []
        for s in shards:
            options = {}  # source id -> (kind, node, per-shard seconds)
            if self.has_shard(key, s["index"]):
                options[("local", None)] = ("local", None, 0.0)
            if self.peer_fetch_enabled:
                holders = list(full_holders)
                for name, tier in self.directory.shard_holders(
                        key, s["index"], exclude=self.name):
                    peer = self.directory.node(name)
                    if peer is not None and peer.has_shard(key, s["index"]):
                        holders.append((name, tier))
                for name, tier in holders:
                    t = self.hw.peer_fetch_time(
                        s["nbytes"], peer_disk=tier == Tier.DISK)
                    sid = ("peer", name)
                    if sid not in options or t < options[sid][2]:
                        options[sid] = ("peer", name, t)
            if cloud_ok:
                options[("cloud", None)] = (
                    "cloud", None, obj.modeled_shard_fetch_s(key, s["index"]))
            if not options:
                return None
            sid = min(options,
                      key=lambda i: load.get(i, 0.0) + options[i][2])
            kind, node, t = options[sid]
            load[sid] = load.get(sid, 0.0) + t
            if kind != "local":
                wire_bytes += s["nbytes"]
            ranges = shard_ranges(st, s)
            rows.append({"index": s["index"], "offset": ranges[0][0],
                         "nbytes": s["nbytes"], "ranges": ranges,
                         "layer_index": s.get("layer_index"),
                         "source": kind, "node": node, "modeled_s": t})
        modeled = self.hw.gather_time(load.values(), wire_bytes)
        return rows, modeled, gen

    def _read_peer_shard(self, peer: Optional["ClusterNode"],
                         key: ModelKey, st: dict, srow: dict,
                         ctx=None) -> bytes:
        """Pull one shard from a peer — a slice of its whole-model file or
        its shard-cache copy — digest-verified. Raises on stale hints,
        transport failure, and corruption; the gather falls back to
        CLOUD. Works against an in-process ClusterNode or a remote
        PeerStub alike (the peer data-plane surface, DESIGN.md §11);
        ``ctx`` rides along when the peer's surface accepts it (legacy
        test doubles are called without)."""
        if peer is None:
            raise _StaleSourceError("peer left the cluster")
        if peer.has_model(key):
            if ctx is not None and _accepts_kwarg(peer.read_model_ranges,
                                                  "ctx"):
                data = peer.read_model_ranges(key, shard_ranges(st, srow),
                                              ctx=ctx)
            else:
                data = peer.read_model_ranges(key, shard_ranges(st, srow))
        elif peer.has_shard(key, srow["index"]):
            if ctx is not None and _accepts_kwarg(peer.read_shard, "ctx"):
                data = peer.read_shard(key, srow["index"], ctx=ctx)
            else:
                data = peer.read_shard(key, srow["index"])
        else:
            raise _StaleSourceError("stale shard hint")
        if (len(data) != srow["nbytes"]
                or hashlib.sha256(data).hexdigest() != srow["digest"]):
            raise IOError(f"{key} shard {srow['index']}: "
                          f"corrupt copy on {peer.name}")
        return data

    def _fetch_one_shard(self, key: ModelKey, st: dict, row: dict,
                         plan_gen: int, acct: dict, ctx=None) -> bytes:
        """Resolve one shard of a gather: planned source first, CLOUD as
        the transparent fallback for dead/stale/corrupt sources. Never
        raises for a recoverable source failure — only when the CLOUD leg
        itself cannot supply the shard (which aborts the gather).
        ``acct`` accumulates the links actually used — per-source modeled
        loads plus the bytes that really crossed the NIC (local shards
        are free)."""
        srow = st["shards"][row["index"]]
        source, node_name = row["source"], row["node"]
        if source == "peer" and self.directory.generation != plan_gen \
                and self.directory.node(node_name) is None:
            # the planned peer left the cluster after planning: re-plan
            # this shard rather than charging the dead link (§8 bugfix)
            with self._metrics_lock:
                self.metrics["plan_replans"] += 1
            source = None
        if source == "local":
            try:
                with open(self._shard_path(key, row["index"]), "rb") as f:
                    data = f.read()
                if hashlib.sha256(data).hexdigest() == srow["digest"]:
                    with self._metrics_lock:
                        self.metrics["shards_local"] += 1
                    return data
            except OSError:
                pass
            # corrupt/vanished local copy: stop advertising it — leaving
            # the file and its hint would make this node re-serve the bad
            # shard to itself and every planning peer forever
            self._forget_local_shard(key, row["index"])
            source = None
        if source == "peer":
            peer = self.directory.node(node_name)
            try:
                t0 = time.perf_counter()
                data = self._read_peer_shard(peer, key, st, srow, ctx=ctx)
                wire_seconds = time.perf_counter() - t0
                with self._metrics_lock:
                    self.metrics["shards_from_peers"] += 1
                    self.metrics["bytes_from_peers"] += srow["nbytes"]
                    self.metrics["bytes_on_wire"] += srow["nbytes"]
                loads = acct["loads"]
                loads[("peer", node_name)] = \
                    loads.get(("peer", node_name), 0.0) + row["modeled_s"]
                acct["wire_bytes"] += srow["nbytes"]
                if peer is not None and peer.remote:
                    # real socket leg: measured per-transfer wire seconds
                    # (DESIGN.md §11) feed the timings and the costmodel
                    acct["wire_s"] += wire_seconds
                    acct["wire_meas_bytes"] += srow["nbytes"]
                    self.hw.observe_wire("peer", srow["nbytes"],
                                         wire_seconds)
                return data
            except (OSError, LookupError):
                with self._metrics_lock:
                    self.metrics["gather_fallbacks"] += 1
                source = None
        # CLOUD leg (planned, or the fallback for everything above)
        obj = self.mrm.objectstore
        if obj is None:
            raise FileNotFoundError(
                f"{key} shard {row['index']}: no remaining source")
        modeled, data = obj.fetch_shard(key, row["index"])
        with self._metrics_lock:
            self.metrics["shards_from_cloud"] += 1
        loads = acct["loads"]
        loads[("cloud", None)] = loads.get(("cloud", None), 0.0) + modeled
        acct["wire_bytes"] += srow["nbytes"]
        return data

    def _gather(self, key: ModelKey, st: dict, timings,
                on_shard=None, ctx=None) -> bool:
        """Multi-source collective staging (§8): assemble ``key`` on local
        disk from its shard table, pulling from several sources in
        parallel. Returns False when a single source is modeled cheaper
        (the ordinary peer/cloud path then runs) or when assembly fails
        (the CLOUD fall-through re-fetches whole). Concurrent gathers of
        one key coalesce onto one set of shard fetches."""
        with self._gather_lock:
            ev = self._gather_inflight.get(key)
            primary = ev is None
            if primary:
                ev = threading.Event()
                ev.ok = False
                self._gather_inflight[key] = ev
        if not primary:
            with self._metrics_lock:
                self.metrics["gather_coalesced"] += 1
            ev.wait()
            # the primary paid the gather; this caller's open proceeds
            # from local disk with zero additional fetch cost
            if ev.ok and self.mrm.disk.contains(key):
                timings.tier_hit = "gather"
                return True
            return False
        try:
            ev.ok = self._gather_run(key, st, timings, on_shard, ctx=ctx)
        finally:
            with self._gather_lock:
                del self._gather_inflight[key]
            ev.set()
        return ev.ok

    def _gather_run(self, key: ModelKey, st: dict, timings,
                    on_shard=None, ctx=None) -> bool:
        plan = self.plan_shard_sources(key, st)
        if plan is None:
            return False
        rows, gather_s, plan_gen = plan
        # a gather only pays when it beats the best single source (the
        # cheapest whole-model peer, or the CLOUD link); otherwise decline
        # and let the ordinary source-selection run
        singles = []
        cloud_whole = self._cloud_link_time(key, st["nbytes"])
        if cloud_whole is not None:
            singles.append(cloud_whole)
        best_peer = self._cheapest_peer(key) if self.peer_fetch_enabled \
            else None
        if best_peer is not None:
            singles.append(best_peer[2])
        if singles and min(singles) <= gather_s:
            return False
        dst = self.mrm.disk.path_for(key)
        # one fetch worker per distinct source (the cost model's parallel
        # links, §8): each link's shards transfer serially ON that link —
        # matching the per-source load accumulation the planner priced —
        # while distinct links genuinely overlap on the wire (remote peers
        # are reached over *dedicated* per-call connections, so two peer
        # sources never serialize on a shared stub socket). The consumer
        # drains results in plan (= execution) order — a reorder buffer —
        # so assembly writes and ``on_shard`` readiness stay the §9 feed.
        groups: Dict[tuple, List[dict]] = {}
        for row in rows:
            groups.setdefault((row["source"], row["node"]), []).append(row)
        accts = {gid: {"loads": {}, "wire_bytes": 0,
                       "wire_s": 0.0, "wire_meas_bytes": 0}
                 for gid in groups}
        owner = {row["index"]: (row["source"], row["node"]) for row in rows}
        results: Dict[int, object] = {}   # shard index -> bytes | exception
        outstanding = {gid: 0 for gid in groups}  # fetched, not yet consumed
        cond = threading.Condition()
        abort = threading.Event()
        depth = 4  # per-link lookahead bound (memory, as run_pipeline had)
        fetch_kwargs = {}  # monkeypatched legacy fetchers lack the kwarg
        if ctx is not None and _accepts_kwarg(self._fetch_one_shard, "ctx"):
            fetch_kwargs["ctx"] = ctx

        def link_worker(gid, my_rows):
            for i, row in enumerate(my_rows):
                with cond:
                    while outstanding[gid] >= depth and not abort.is_set():
                        cond.wait()
                if abort.is_set():
                    return
                try:
                    data = self._fetch_one_shard(key, st, row, plan_gen,
                                                 accts[gid], **fetch_kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised by
                    with cond:              # the consumer, in plan order
                        for r2 in my_rows[i:]:
                            results[r2["index"]] = e
                        cond.notify_all()
                    return
                with cond:
                    results[row["index"]] = data
                    outstanding[gid] += 1
                    cond.notify_all()

        try:
            with atomic_dest_file(dst, prefix=".gather-") as (fd, tmp):
                try:
                    os.ftruncate(fd, st["nbytes"])
                    workers = [threading.Thread(
                        target=link_worker, args=(gid, grows), daemon=True,
                        name=f"gather-{gid[0]}-{gid[1] or 'self'}")
                        for gid, grows in groups.items()]
                    for w in workers:
                        w.start()
                    try:
                        for row in rows:  # plan order: the reorder buffer
                            with cond:
                                while row["index"] not in results:
                                    cond.wait()
                                data = results.pop(row["index"])
                                outstanding[owner[row["index"]]] -= 1
                                cond.notify_all()
                            if isinstance(data, BaseException):
                                raise data
                            off = 0
                            for ro, rn in (row.get("ranges")
                                           or [(row["offset"],
                                                row["nbytes"])]):
                                os.pwrite(fd, data[off:off + rn], ro)
                                off += rn
                            # shard bytes are digest-verified by the fetch
                            # leg; consumed in plan (= execution) order, so
                            # this is the per-layer readiness feed (§9)
                            if on_shard is not None:
                                on_shard(row, data)
                    finally:
                        abort.set()
                        with cond:
                            cond.notify_all()
                        for w in workers:
                            w.join()
                finally:
                    os.close(fd)
                h = hashlib.sha256()
                with open(tmp, "rb") as f:
                    for chunk in iter(lambda: f.read(8 << 20), b""):
                        h.update(chunk)
                if h.hexdigest() != st["digest"]:
                    raise IOError(f"{key}: gathered assembly digest mismatch")
        except (OSError, LookupError):
            return False  # the MRM's CLOUD fall-through re-fetches whole
        # merge per-link accounting — each worker mutated only its own
        # dict, so no locks were needed on the hot fetch path
        acct = {"loads": {}, "wire_bytes": 0, "wire_s": 0.0,
                "wire_meas_bytes": 0}
        for a in accts.values():
            for lk, lv in a["loads"].items():
                acct["loads"][lk] = acct["loads"].get(lk, 0.0) + lv
            acct["wire_bytes"] += a["wire_bytes"]
            acct["wire_s"] += a["wire_s"]
            acct["wire_meas_bytes"] += a["wire_meas_bytes"]
        # charge the gather at the links (and wire bytes) it actually used
        gather_s = self.hw.gather_time(acct["loads"].values(),
                                       acct["wire_bytes"])
        timings.gather_s = gather_s
        timings.wire_s += acct["wire_s"]
        timings.wire_bytes += acct["wire_meas_bytes"]
        timings.tier_hit = "gather"
        with self._metrics_lock:
            self.metrics["gather_fetches"] += 1
        with self.mrm._lock:
            self.mrm.metrics["gather_fetches"] += 1
            self.mrm.metrics["modeled_fetch_s"] += gather_s
        self.directory.publish(self.name, key, Tier.DISK)
        self._drop_local_shards(key)  # the full copy supersedes them
        return True

    def stats(self) -> dict:
        with self._metrics_lock:
            return {"name": self.name, **self.metrics}


class Cluster:
    """Convenience wiring: N nodes sharing one directory and CLOUD tier.

    ``peer_codec`` is the cluster-wide default wire codec for peer
    transfers (None = raw copies); ``add_node`` can override per node.
    """

    def __init__(self, objectstore=None,
                 directory: "Optional[object]" = None,
                 peer_codec: Optional[str] = None):
        # ``directory`` accepts an instance satisfying DirectoryProtocol,
        # a policy name ("single" | "sharded"), or None (single-map).
        if isinstance(directory, str):
            from repro_torch.core.directory import make_directory
            directory = make_directory(directory)
        self.directory = directory or ClusterDirectory()
        self.objectstore = objectstore
        self.peer_codec = peer_codec
        self.nodes: Dict[str, ClusterNode] = {}

    def add_node(self, name: str, mrm: MRM, peer_fetch: bool = True,
                 peer_codec: Optional[str] = None,
                 gather: bool = True) -> ClusterNode:
        if mrm.objectstore is None and self.objectstore is not None:
            mrm.attach_objectstore(self.objectstore)
        node = ClusterNode(name, mrm, self.directory, peer_fetch=peer_fetch,
                           peer_codec=peer_codec or self.peer_codec,
                           gather=gather)
        self.nodes[name] = node
        return node

    def node(self, name: str) -> ClusterNode:
        return self.nodes[name]

    def scatter(self, key: ModelKey,
                node_names: Optional[List[str]] = None) -> Dict[str, List[int]]:
        """Pre-position a sharded model across the fleet: shard ``i`` goes
        to node ``i % n`` (round-robin), landing in each node's local
        shard cache with a published placement. This is how a model larger
        than any single node's device tier becomes cluster-resident
        without any node holding it whole (§8). Returns
        ``{node_name: [shard indices]}``.

        Unknown ``node_names`` fail up front, before any shard moves; a
        failure mid-scatter (fetch or store) rolls back the shards that
        already landed — local copy unlinked, placement withdrawn — so
        the directory never advertises a half-scattered model."""
        key = ModelKey(*key)
        if self.objectstore is None:
            raise RuntimeError("scatter needs a cluster object store")
        names = list(node_names or self.nodes)
        if not names:
            raise RuntimeError("scatter needs at least one node")
        unknown = sorted(set(names) - set(self.nodes))
        if unknown:
            raise KeyError(f"scatter: unknown node(s) {unknown}; "
                           f"cluster has {sorted(self.nodes)}")
        out: Dict[str, List[int]] = {n: [] for n in names}
        placed: List[Tuple[str, int]] = []
        try:
            for s in self.objectstore.shard_table(key):
                name = names[s["index"] % len(names)]
                _, data = self.objectstore.fetch_shard(key, s["index"])
                self.nodes[name].store_shard(key, s["index"], data)
                placed.append((name, s["index"]))
                out[name].append(s["index"])
        except BaseException:
            for name, idx in placed:
                self.nodes[name]._forget_local_shard(key, idx)
            raise
        return out

    def stats(self) -> dict:
        return {"directory": self.directory.stats(),
                "nodes": [n.stats() for n in self.nodes.values()]}
