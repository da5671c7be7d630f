"""Content-addressed CLOUD-tier object store (paper §3, DESIGN.md §6).

The bottom of the four-tier hierarchy ``DEVICE -> HOST -> DISK -> CLOUD``:
a blob store addressed by content digest, the reproduction's stand-in for
S3/GCS model repositories. Blobs live under ``blobs/<digest[:2]>/<digest>``
and a JSON manifest maps model keys to
``{digest, nbytes, stored_nbytes, codec}``, so two model versions with
byte-identical weights share one blob (content dedup) and a ``put`` of
bytes the store already holds costs only a manifest update.

Blobs are optionally stored **compressed** (``codec`` — see
``repro_torch.core.codec``): the digest always addresses the *uncompressed*
content (identity is stable across codecs), the blob file carries a
``.{codec}`` suffix, and ``fetch`` decodes through a chunked pipeline
(wire read | decompress | disk write) so decompression overlaps the
transfer instead of serializing after it (DESIGN.md §4). The wire leg is
charged at ``stored_nbytes`` — ratio is latency won for free until the
decompress stage becomes the max-stage.

The backend is a local directory — tests run hermetically — while the
network is *modeled*: ``fetch``/``put_file`` return the modeled transfer
seconds at ``bw``/``rtt`` and optionally sleep-throttle so benchmark wall
clocks reflect the simulated link (same contract as ``CloudStore``).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.codec import get_codec
from repro_torch.core.costmodel import (DECOMPRESS_BW, DEFAULT_SHARD_BYTES,
                                        PIPELINE_CHUNK_BYTES, pipelined_stage_time)
from repro_torch.core.pipeline import PipelineReport, run_pipeline
from repro_torch.core.store import DiskStore, atomic_dest_file, write_model

_HEX = set("0123456789abcdef")


def _key_id(key) -> str:
    fw, name, ver = key
    return f"{fw}/{name}@{ver}"


def shard_ranges(st: dict, s: dict) -> List[Tuple[int, int]]:
    """Destination byte ranges of one shard-table row ``s`` within its
    entry ``st``: explicit ``ranges`` for layer-planned shards, a single
    ``index * shard_bytes`` run for classic fixed-size shards."""
    r = s.get("ranges")
    if r:
        return [(int(a), int(b)) for a, b in r]
    sb = st.get("shard_bytes") or s["nbytes"]
    return [(s["index"] * sb, s["nbytes"])]


class ObjectStore:
    """Content-addressed put/get over a local-dir backend. Thread-safe.

    ``codec`` is the default for writes (every blob records its own codec
    in the manifest, so reads always decode correctly — including entries
    written before compression existed, which default to ``none``).
    ``decompress_bw`` feeds the modeled pipelined fetch time;
    ``chunk_bytes`` sizes the real fetch pipeline's chunks.
    """

    def __init__(self, root: str, bw: float = 1e9, rtt: float = 20e-3,
                 simulate_time: bool = False, codec: str = "none",
                 decompress_bw: float = DECOMPRESS_BW,
                 chunk_bytes: int = PIPELINE_CHUNK_BYTES,
                 shard_bytes: Optional[int] = None):
        self.root = root
        self.blob_dir = os.path.join(root, "blobs")
        self.manifest_path = os.path.join(root, "manifest.json")
        self.bw, self.rtt = bw, rtt
        self.simulate_time = simulate_time
        # keep the Codec OBJECT: a tuned instance (e.g. ZlibCodec(level=9))
        # must not be flattened to its registry default via the name
        self._codec = get_codec(codec)
        self.codec = self._codec.name
        self.decompress_bw = decompress_bw
        self.chunk_bytes = chunk_bytes
        # default shard size for writes (DESIGN.md §8): None keeps blobs
        # whole; an int splits every put into content-addressed shard
        # blobs so peers can gather a model from many sources in parallel
        # (True means the costmodel's DEFAULT_SHARD_BYTES — and guards the
        # bool-is-int footgun of literally 1-byte shards)
        if shard_bytes is True:
            shard_bytes = DEFAULT_SHARD_BYTES
        self.shard_bytes = shard_bytes
        self._lock = threading.RLock()
        os.makedirs(self.blob_dir, exist_ok=True)
        self._manifest: Dict[str, dict] = {}
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                self._manifest = json.load(f)
        # metrics
        self.puts = 0
        self.fetches = 0
        self.dedup_hits = 0
        self.bytes_fetched = 0       # logical (uncompressed) bytes delivered
        self.wire_bytes_fetched = 0  # stored bytes that crossed the wire
        self.shard_fetches = 0       # individual shard downloads (gather path)
        self.gc_runs = 0
        self.gc_blobs_removed = 0
        self.gc_reclaimed_bytes = 0

    # -- internals ----------------------------------------------------------
    def _blob_path(self, digest: str, codec: str = "none") -> str:
        suffix = "" if codec == "none" else f".{codec}"
        return os.path.join(self.blob_dir, digest[:2], digest + suffix)

    def _save_manifest_locked(self):
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=1)
        os.replace(tmp, self.manifest_path)

    def _throttle(self, modeled: float, elapsed: float) -> float:
        if self.simulate_time and elapsed < modeled:
            time.sleep(min(modeled - elapsed, 0.25))  # cap: keep benches fast
        return modeled

    def _modeled_fetch(self, nbytes: int, stored_nbytes: int,
                       codec: str) -> float:
        """Modeled seconds for the CLOUD leg: wire at ``stored_nbytes``
        over ``bw``; a compressed blob adds a decompress stage overlapped
        by the chunked pipeline (DESIGN.md §4)."""
        wire = stored_nbytes / self.bw
        if codec == "none":
            return self.rtt + wire
        n = max(1, math.ceil(nbytes / max(1, self.chunk_bytes)))
        return pipelined_stage_time([wire, nbytes / self.decompress_bw], n,
                                    lat=self.rtt)

    def _store_blob_locked(self, digest: str, codec_obj, data: bytes) -> int:
        """Write ``data`` (uncompressed) as the blob for ``digest`` through
        ``codec_obj`` unless it already exists (dedup); returns the blob's
        stored (on-disk) size. Caller holds the store lock."""
        blob = self._blob_path(digest, codec_obj.name)
        if os.path.exists(blob):
            self.dedup_hits += 1
        else:
            with atomic_dest_file(blob, prefix=".put-") as (fd, _):
                comp = codec_obj.compressor()
                with os.fdopen(fd, "wb") as out:
                    for off in range(0, len(data), self.chunk_bytes):
                        out.write(comp.compress(data[off:off
                                                     + self.chunk_bytes]))
                    out.write(comp.flush())
        return os.path.getsize(blob)

    # -- writes -------------------------------------------------------------
    def put_file(self, key, path: str, codec: Optional[str] = None,
                 shard_bytes: Optional[int] = None,
                 shard_plan: Optional[str] = None) -> str:
        """Upload a serialized ``.trims`` file; returns its content digest.

        The digest is of the *uncompressed* content; the blob is stored
        through ``codec`` (store default when None). A blob the store
        already holds under that codec is not re-written (dedup) — only
        the manifest entry is. The modeled wire leg moves the compressed
        size.

        ``shard_bytes`` (store default when None, ``0`` forces whole-blob)
        splits the content into fixed-size **shards** (DESIGN.md §8), each
        its own content-addressed blob, and records a per-shard table
        ``shards: [{index, digest, nbytes, stored_nbytes, codec}]`` in the
        manifest — the unit of the cluster's multi-source gather. The
        top-level digest still addresses the whole uncompressed content,
        so an assembled gather is verifiable end-to-end.

        ``shard_plan="layers"`` cuts shard boundaries on **layer windows**
        instead of fixed offsets (DESIGN.md §9): each shard covers the
        byte ranges of one execution step's tensors (row slices of the
        stacked per-layer tensors), and its manifest row additionally
        records the tensor map ``{layer_index, group, tensor_names,
        ranges}``. A window larger than ``shard_bytes`` is split into
        multiple shards of the same ``layer_index``, so a gather can still
        spread one fat layer across sources (LPT within the window). The
        range union covers the file exactly — reassembly stays verifiable
        against the top-level digest.
        """
        codec_obj = get_codec(codec) if codec is not None else self._codec
        sb = self.shard_bytes if shard_bytes is None else (shard_bytes or None)
        if sb is True:  # per-put True: same default as the constructor's
            sb = DEFAULT_SHARD_BYTES
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        if shard_plan is not None:
            if shard_plan != "layers":
                raise ValueError(f"unknown shard_plan {shard_plan!r}")
            return self._put_file_layers(key, path, codec_obj, sb, nbytes, t0)
        if sb is not None:
            # hash pass OUTSIDE the lock (mirrors the whole-blob path:
            # readers must not block behind digesting a multi-GB model);
            # blob writes stay under the lock so gc_blobs can never sweep
            # a half-landed shard
            h = hashlib.sha256()
            slices: List[Tuple[int, str]] = []  # (nbytes, digest) per shard
            with open(path, "rb") as f:
                while True:
                    data = f.read(sb)
                    if not data and slices:
                        break
                    h.update(data)
                    slices.append((len(data),
                                   hashlib.sha256(data).hexdigest()))
                    if len(data) < sb:
                        break
            digest = h.hexdigest()
            shards: List[dict] = []
            with self._lock:
                self.puts += 1
                with open(path, "rb") as f:
                    for index, (snbytes, sdig) in enumerate(slices):
                        data = f.read(snbytes)
                        stored = self._store_blob_locked(sdig, codec_obj,
                                                         data)
                        shards.append({"index": index, "digest": sdig,
                                       "nbytes": snbytes,
                                       "stored_nbytes": stored,
                                       "codec": codec_obj.name})
                stored_nbytes = sum(s["stored_nbytes"] for s in shards)
                self._manifest[_key_id(key)] = {
                    "digest": digest, "nbytes": nbytes,
                    "stored_nbytes": stored_nbytes, "codec": codec_obj.name,
                    "shard_bytes": sb, "shards": shards}
                self._save_manifest_locked()
            self._throttle(self.rtt + stored_nbytes / self.bw,
                           time.perf_counter() - t0)
            return digest
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(8 << 20), b""):
                h.update(chunk)
        digest = h.hexdigest()
        with self._lock:
            self.puts += 1
            blob = self._blob_path(digest, codec_obj.name)
            if os.path.exists(blob):
                self.dedup_hits += 1
            else:
                with atomic_dest_file(blob, prefix=".put-") as (fd, _):
                    comp = codec_obj.compressor()
                    with os.fdopen(fd, "wb") as out, open(path, "rb") as f:
                        for chunk in iter(lambda: f.read(self.chunk_bytes),
                                          b""):
                            out.write(comp.compress(chunk))
                        out.write(comp.flush())
            stored_nbytes = os.path.getsize(blob)
            self._manifest[_key_id(key)] = {
                "digest": digest, "nbytes": nbytes,
                "stored_nbytes": stored_nbytes, "codec": codec_obj.name}
            self._save_manifest_locked()
        self._throttle(self.rtt + stored_nbytes / self.bw,
                       time.perf_counter() - t0)
        return digest

    def _put_file_layers(self, key, path: str, codec_obj, sb: Optional[int],
                         nbytes: int, t0: float) -> str:
        """The ``shard_plan="layers"`` splitter (see :meth:`put_file`)."""
        from repro_torch.core.layerplan import plan_for_file
        plan, _ = plan_for_file(path)
        # cut each window's range list into <= sb pieces (one shard per
        # window when sb is None or the window fits)
        pieces: List[Tuple[object, List[Tuple[int, int]]]] = []
        for w in plan:
            cur: List[Tuple[int, int]] = []
            size = 0
            for off, n in w.ranges:
                while n > 0:
                    take = n if sb is None else min(n, sb - size)
                    if take <= 0:
                        pieces.append((w, cur))
                        cur, size = [], 0
                        continue
                    cur.append((off, take))
                    size += take
                    off += take
                    n -= take
                    if sb is not None and size >= sb:
                        pieces.append((w, cur))
                        cur, size = [], 0
            if cur:
                pieces.append((w, cur))

        # hash pass outside the lock (same discipline as the fixed-size
        # splitter); blob writes stay under it so gc_blobs is safe
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(8 << 20), b""):
                h.update(chunk)
        digest = h.hexdigest()
        payloads: List[bytes] = []
        with open(path, "rb") as f:
            for _, ranges in pieces:
                parts = []
                for off, n in ranges:
                    f.seek(off)
                    parts.append(f.read(n))
                payloads.append(b"".join(parts))
        digests = [hashlib.sha256(p).hexdigest() for p in payloads]

        shards: List[dict] = []
        with self._lock:
            self.puts += 1
            for index, ((w, ranges), data, sdig) in enumerate(
                    zip(pieces, payloads, digests)):
                stored = self._store_blob_locked(sdig, codec_obj, data)
                shards.append({
                    "index": index, "digest": sdig, "nbytes": len(data),
                    "stored_nbytes": stored, "codec": codec_obj.name,
                    "layer_index": w.layer_index, "group": w.group,
                    "window": w.index,
                    "tensor_names": list(w.tensor_names),
                    "ranges": [[off, n] for off, n in ranges]})
            stored_nbytes = sum(s["stored_nbytes"] for s in shards)
            self._manifest[_key_id(key)] = {
                "digest": digest, "nbytes": nbytes,
                "stored_nbytes": stored_nbytes, "codec": codec_obj.name,
                "shard_plan": "layers", "shards": shards}
            self._save_manifest_locked()
        self._throttle(self.rtt + stored_nbytes / self.bw,
                       time.perf_counter() - t0)
        return digest

    def put(self, key, tensors: Dict[str, np.ndarray], meta=None,
            codec: Optional[str] = None,
            shard_bytes: Optional[int] = None,
            shard_plan: Optional[str] = None) -> str:
        """Serialize ``tensors`` to the .trims format and upload."""
        fd, tmp = tempfile.mkstemp(suffix=".trims", dir=self.root)
        os.close(fd)
        try:
            write_model(tmp, tensors, meta)
            return self.put_file(key, tmp, codec=codec,
                                 shard_bytes=shard_bytes,
                                 shard_plan=shard_plan)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def delete(self, key):
        """Drop the manifest entry (blobs stay — other keys may share them;
        ``gc_blobs`` reclaims the ones nobody references anymore)."""
        with self._lock:
            if self._manifest.pop(_key_id(key), None) is not None:
                self._save_manifest_locked()

    def gc_blobs(self) -> int:
        """Remove blobs unreferenced by any manifest entry; returns the
        bytes reclaimed (also accumulated into ``stats()``).

        ``delete`` only drops manifest entries — under version churn the
        blob dir otherwise grows without bound. Runs under the store lock
        (puts write blobs under the same lock, so a half-written blob can
        never be swept); in-flight temp files are skipped by the
        digest-name filter, and a fetch that loses its blob to a
        concurrent delete+gc re-stats and retries rather than failing.
        """
        with self._lock:
            live = set()
            for e in self._manifest.values():
                if e.get("shards"):  # sharded entry: the shard blobs are live
                    for s in e["shards"]:
                        live.add(os.path.abspath(self._blob_path(
                            s["digest"], s.get("codec", "none"))))
                else:
                    live.add(os.path.abspath(self._blob_path(
                        e["digest"], e.get("codec", "none"))))
            reclaimed = removed = 0
            for sub in sorted(os.listdir(self.blob_dir)):
                d = os.path.join(self.blob_dir, sub)
                if not os.path.isdir(d):
                    continue
                for fn in os.listdir(d):
                    stem = fn.split(".", 1)[0]
                    if len(stem) != 64 or not set(stem) <= _HEX:
                        continue  # not a blob (e.g. a put's temp file)
                    p = os.path.abspath(os.path.join(d, fn))
                    if p in live:
                        continue
                    try:
                        nb = os.path.getsize(p)
                        os.unlink(p)
                    except OSError:
                        continue
                    reclaimed += nb
                    removed += 1
                if not os.listdir(d):
                    os.rmdir(d)
            self.gc_runs += 1
            self.gc_blobs_removed += removed
            self.gc_reclaimed_bytes += reclaimed
            return reclaimed

    # -- reads --------------------------------------------------------------
    def contains(self, key) -> bool:
        with self._lock:
            return _key_id(key) in self._manifest

    def stat(self, key) -> Optional[dict]:
        """``{"digest", "nbytes", "stored_nbytes", "codec"}`` for ``key``,
        or None. Entries written before compression existed are surfaced
        with ``codec="none"`` and ``stored_nbytes == nbytes``. Sharded
        entries (DESIGN.md §8) additionally carry ``shard_bytes`` and
        ``shards: [{index, digest, nbytes, stored_nbytes, codec}]``."""
        with self._lock:
            e = self._manifest.get(_key_id(key))
            if e is None:
                return None
            return {"stored_nbytes": e["nbytes"], "codec": "none", **e}

    def shard_table(self, key) -> List[dict]:
        """The per-shard manifest rows for ``key`` (empty for unsharded
        entries); raises KeyError when the store does not hold the key."""
        st = self.stat(key)
        if st is None:
            raise KeyError(f"{key} not in object store")
        return list(st.get("shards") or [])

    def nbytes(self, key) -> int:
        st = self.stat(key)
        if st is None:
            raise KeyError(f"{key} not in object store")
        return st["nbytes"]

    def modeled_fetch_s(self, key) -> float:
        """Modeled CLOUD-leg seconds for ``key`` at this store's link —
        compression-aware: the wire moves ``stored_nbytes`` and the
        decompress stage is overlapped. This is what fetch-source cost
        compares should use (DESIGN.md §6). A sharded entry streams its
        shards back-to-back over the one cloud link, so the aggregate
        model is the same."""
        st = self.stat(key)
        if st is None:
            raise KeyError(f"{key} not in object store")
        return self._modeled_fetch(st["nbytes"], st["stored_nbytes"],
                                   st["codec"])

    def modeled_shard_fetch_s(self, key, index: int) -> float:
        """Modeled seconds to pull ONE shard of ``key`` over this store's
        link — the per-shard term of a gather plan (DESIGN.md §8)."""
        s = self.shard_table(key)[index]
        return self._modeled_fetch(s["nbytes"], s["stored_nbytes"],
                                   s.get("codec", "none"))

    def fetch_shard(self, key, index: int) -> Tuple[float, bytes]:
        """Download one shard of a sharded entry; returns
        ``(modeled_seconds, uncompressed_bytes)``, digest-verified.

        The gather path's CLOUD source: shards are small enough to hand
        back in memory, and each call is charged at the shard's own
        stored size over this store's link. Raises KeyError for unsharded
        keys or an out-of-range index; a blob lost to a concurrent
        delete+gc re-stats and retries exactly as :meth:`fetch` does.
        """
        t0 = time.perf_counter()
        for attempt in (0, 1):
            shards = self.shard_table(key)
            if index >= len(shards):
                raise KeyError(f"{key}: no shard {index} "
                               f"({len(shards)} shards)")
            s = shards[index]
            try:
                with open(self._blob_path(s["digest"],
                                          s.get("codec", "none")),
                          "rb") as f:
                    raw = f.read()
                break
            except FileNotFoundError:
                if attempt == 0:
                    continue
                raise
        codec = s.get("codec", "none")
        data = raw if codec == "none" else get_codec(codec).decompress(raw)
        if hashlib.sha256(data).hexdigest() != s["digest"]:
            raise IOError(f"{key} shard {index}: digest mismatch")
        modeled = self._throttle(
            self._modeled_fetch(s["nbytes"], s["stored_nbytes"], codec),
            time.perf_counter() - t0)
        with self._lock:
            self.shard_fetches += 1
            self.bytes_fetched += s["nbytes"]
            self.wire_bytes_fetched += s["stored_nbytes"]
        return modeled, data

    def _fetch_pipelined(self, src: str, out, codec_name: str
                         ) -> PipelineReport:
        """The compressed download path: wire read | decompress | disk
        write as one chunked pipeline (decode overlaps the transfer).
        ``out`` is the destination file object, left open."""
        codec_obj = get_codec(codec_name)
        decomp = codec_obj.decompressor()
        size = os.path.getsize(src)
        offsets = list(range(0, size, self.chunk_bytes)) or [0]
        with open(src, "rb") as fsrc:

            def wire_read(off):
                fsrc.seek(off)
                return fsrc.read(self.chunk_bytes)

            def decompress(data):
                return decomp.decompress(data)

            def disk_write(data):
                out.write(data)
                return len(data)

            _, report = run_pipeline(
                offsets,
                [("wire_read", wire_read, len),
                 ("decompress", decompress, len),
                 ("disk_write", disk_write)],
                depth=2)
        out.write(decomp.flush())
        return report

    def _fetch_sharded(self, st: dict, fd: int,
                       on_shard=None) -> PipelineReport:
        """Reassemble a sharded entry into open file ``fd``: shard blobs
        stream in index order through one ``wire_read | decompress |
        disk_write`` pipeline, so decode and assembly overlap the wire
        exactly as the whole-blob path does (DESIGN.md §8). Writes are
        positional (a layer-planned shard's ranges are non-contiguous row
        slices); ``on_shard(row, data)`` fires after each shard's bytes
        are digest-verified and landed — the streaming open's per-layer
        readiness source (DESIGN.md §9)."""

        def wire_read(s):
            with open(self._blob_path(s["digest"], s.get("codec", "none")),
                      "rb") as f:
                return s, f.read()

        def decode(item):
            s, raw = item
            codec = s.get("codec", "none")
            data = raw if codec == "none" else get_codec(codec).decompress(raw)
            if hashlib.sha256(data).hexdigest() != s["digest"]:
                raise IOError(f"shard {s['index']}: digest mismatch")
            return s, data

        def disk_write(item):
            s, data = item
            off = 0
            for ro, rn in shard_ranges(st, s):
                os.pwrite(fd, data[off:off + rn], ro)
                off += rn
            if on_shard is not None:
                on_shard(s, data)
            return len(data)

        _, report = run_pipeline(
            list(st["shards"]),
            [("wire_read", wire_read, lambda r: len(r[1])),
             ("decompress", decode, lambda r: len(r[1])),
             ("disk_write", disk_write)],
            depth=2)
        return report

    def fetch(self, key, dest: DiskStore,
              report_out: Optional[List] = None,
              on_shard=None) -> Tuple[float, int]:
        """Download ``key`` into a local DiskStore.

        Returns ``(modeled_seconds, nbytes)`` — the CLOUD leg of a cold
        open's timeline, with the wire charged at ``stored_nbytes`` and a
        compressed blob's decompress stage overlapped by the chunked
        pipeline. Concurrent fetches of one key are safe: each writes a
        unique temp file and the last atomic replace wins. When
        ``report_out`` is given, the fetch's :class:`PipelineReport` (or
        None for uncompressed blobs) is appended. ``on_shard(row, data)``
        fires per verified shard of a sharded entry, in manifest order —
        ignored for whole-blob entries.
        """
        dst = dest.path_for(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        t0 = time.perf_counter()
        report = None
        # the blob is read OUTSIDE the store lock, so a concurrent
        # delete + gc_blobs can unlink it mid-copy — on FileNotFoundError
        # re-stat and retry: a still-referenced key's blob is never gc'd,
        # so either the re-stat misses (plain KeyError, the key was
        # deleted under us) or the retry reads the re-put blob
        for attempt in (0, 1):
            st = self.stat(key)
            if st is None:
                raise KeyError(f"{key} not in object store")
            src = self._blob_path(st["digest"], st["codec"])
            try:
                with atomic_dest_file(dst, prefix=".fetch-") as (fd, tmp):
                    if st.get("shards"):
                        try:
                            os.ftruncate(fd, st["nbytes"])
                            report = self._fetch_sharded(st, fd, on_shard)
                        finally:
                            os.close(fd)
                    elif st["codec"] == "none":
                        os.close(fd)
                        shutil.copyfile(src, tmp)
                    else:
                        with os.fdopen(fd, "wb") as out:
                            report = self._fetch_pipelined(src, out,
                                                           st["codec"])
                break
            except FileNotFoundError:
                if attempt == 0:
                    continue
                raise
        modeled = self._throttle(
            self._modeled_fetch(st["nbytes"], st["stored_nbytes"],
                                st["codec"]),
            time.perf_counter() - t0)
        with self._lock:
            self.fetches += 1
            self.bytes_fetched += st["nbytes"]
            self.wire_bytes_fetched += st["stored_nbytes"]
        if report_out is not None:
            report_out.append(report)
        return modeled, st["nbytes"]

    def keys(self):
        with self._lock:
            out = []
            for kid in self._manifest:
                fw, rest = kid.split("/", 1)
                name, ver = rest.rsplit("@", 1)
                out.append((fw, name, ver))
            return out

    def stats(self) -> dict:
        with self._lock:
            blobs = set()
            sharded_keys = 0
            for e in self._manifest.values():
                if e.get("shards"):
                    sharded_keys += 1
                    blobs |= {(s["digest"], s.get("codec", "none"))
                              for s in e["shards"]}
                else:
                    blobs.add((e["digest"], e.get("codec", "none")))
            stored = sum(e.get("stored_nbytes", e["nbytes"])
                         for e in self._manifest.values())
            return {"keys": len(self._manifest), "blobs": len(blobs),
                    "sharded_keys": sharded_keys,
                    "puts": self.puts, "dedup_hits": self.dedup_hits,
                    "fetches": self.fetches,
                    "shard_fetches": self.shard_fetches,
                    "bytes_fetched": self.bytes_fetched,
                    "wire_bytes_fetched": self.wire_bytes_fetched,
                    "stored_bytes": stored,
                    "gc_runs": self.gc_runs,
                    "gc_blobs_removed": self.gc_blobs_removed,
                    "gc_reclaimed_bytes": self.gc_reclaimed_bytes}
