"""Hardware cost model: measured local-I/O constants + NVIDIA H100 targets.

The paper (Table 2) characterizes each system by cached-read and
buffered-disk-read bandwidth (hdparm). We do the same at startup with a
real file microbenchmark, and pair it with the H100 SXM data-sheet
constants. On a machine with a CUDA card the host<->device rates
(``h2d_bw``, ``d2h_bw``) are *measured* with a timed copy
(:func:`measure_transfer`); without one they keep the PCIe Gen5 x16 figure.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time
from dataclasses import asdict, dataclass, field


# NVIDIA H100 SXM targets (NVIDIA H100 Tensor Core GPU data sheet; dense
# rates, no sparsity)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12               # B/s, HBM3
ICI_BW_PER_LINK = 450e9        # B/s, NVLink 4 one direction per card
H2D_BW = 64e9                  # B/s, PCIe Gen5 x16 one direction (replaced
                               # by measure_transfer on a machine with a card)
HBM_BYTES = 80 * 10 ** 9       # 80 GB HBM3
PIPELINE_CHUNK_BYTES = 4 << 20  # default staging chunk (DESIGN.md §4)
DECOMPRESS_BW = 1.5e9          # B/s single-stream inflate (zstd-class;
                               # zlib/lzma measure lower — bench_compression)
COMPRESS_BW = 400e6            # B/s single-stream deflate (sender side)
DEFAULT_SHARD_BYTES = 16 << 20  # default shard size for sharded manifests
                                # (DESIGN.md §8)
DIR_OP_S = 2e-6                # directory-shard service time per placement
                               # op (one guarded dict update — DESIGN.md §10)
DIR_RTT = 200e-6               # client -> directory round trip (intra-DC)
DIR_SYNC_ENTRY_S = 0.5e-6      # anti-entropy merge cost per record exchanged
WIRE_EWMA_ALPHA = 0.3          # weight of each new measured-transfer sample
MIN_WIRE_SAMPLE_BYTES = 256 << 10  # smaller transfers are RTT-dominated and
                                   # would drag a bandwidth estimate to zero


def pipelined_stage_time(stage_seconds, n_chunks: int,
                         lat: float = 0.0) -> float:
    """Chunked-pipeline composition of whole-transfer stage costs.

    ``stage_seconds`` are each stage's seconds for the FULL transfer; cut
    into ``n_chunks`` chunks the pipeline pays the pipe-fill once plus the
    max-stage per remaining chunk:
    ``lat + sum(s/n) + (n-1) * max(s/n)`` — equal to the serial sum at one
    chunk, approaching ``max(stage_seconds)`` as chunks grow (DESIGN.md §4).
    """
    n = max(1, n_chunks)
    per = [s / n for s in stage_seconds]
    return lat + sum(per) + (n - 1) * max(per)


def streaming_ttfl_time(wire_seconds, post_seconds, lat: float = 0.0):
    """Layer-streamed overlap model (DESIGN.md §9).

    ``wire_seconds[i]`` is the transfer time of layer window ``i`` (windows
    arrive in execution order, back to back on one link); ``post_seconds[i]``
    is everything serialized *after* its bytes land — deserialize + H2D +
    that window's compute. Compute for window ``i`` starts at
    ``max(done[i-1], arrival[i])``: the engine blocks per layer only when it
    catches up to the wire, so each window costs ``max(wire, compute)``
    rather than their sum.

    Returns ``(ttfl, done)``: time-to-first-layer (the stem+layer-0 window,
    when prefill can start emitting) and the list of per-window completion
    times — ``done[-1]`` is the streamed total, to compare against the
    reassemble-then-run baseline ``lat + sum(wire) + sum(post)``.
    """
    t_arrive = lat
    t_done = 0.0
    done = []
    for w, p in zip(wire_seconds, post_seconds):
        t_arrive += w
        t_done = max(t_done, t_arrive) + p
        done.append(t_done)
    ttfl = done[0] if done else lat
    return ttfl, done


@dataclass
class HardwareModel:
    """Per-system transfer/compute constants (paper Table 2 methodology):
    measured disk/cached-read bandwidth paired with H100 data-sheet rates,
    measured host<->device copy rates, plus the modeled cloud and
    intra-cluster links (DESIGN.md §6)."""
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW_PER_LINK
    h2d_bw: float = H2D_BW
    d2h_bw: float = H2D_BW
    hbm_bytes: int = HBM_BYTES
    disk_bw: float = 500e6          # overwritten by measure()
    disk_lat: float = 1e-4
    cached_read_bw: float = 8e9     # page-cache hits
    cloud_bw: float = 1e9           # CLOUD tier (object store / remote repo)
    cloud_rtt: float = 20e-3
    peer_bw: float = 10e9           # intra-cluster link (100GbE-class)
    peer_rtt: float = 0.5e-3
    ingest_bw: float = 10e9         # local NIC/ingest ceiling a multi-source
                                    # gather saturates at (DESIGN.md §8)
    decompress_bw: float = DECOMPRESS_BW  # single-stream inflate rate
    compress_bw: float = COMPRESS_BW      # single-stream deflate rate
    dir_op_s: float = DIR_OP_S            # directory op service time (§10)
    dir_rtt: float = DIR_RTT              # client -> directory round trip
    dir_sync_entry_s: float = DIR_SYNC_ENTRY_S  # anti-entropy per-record cost

    def __post_init__(self) -> None:
        # plain (non-field) attrs: stay out of asdict() and the JSON cache
        self._wire_lock = threading.Lock()
        self._wire_obs: dict = {}

    # -- measured-wire calibration (DESIGN.md §11) --------------------------
    def observe_wire(self, kind: str, nbytes: int, seconds: float) -> None:
        """Fold one *measured* transfer into the link model: EWMA the
        observed bandwidth into ``peer_bw`` / ``cloud_bw`` so planning
        (``peer_fetch_time``, ``pick_fetch_source``, gather LPT) prices
        links at what the wire actually delivers instead of the datasheet
        constant. Only socket transports call this — in-process transfers
        keep the modeled constants. Tiny transfers are skipped (RTT
        dominates; they carry no bandwidth signal). Thread-safe: gather
        threads report transfers concurrently, and an interleaved EWMA
        read-modify-write would drop samples or tear the estimate."""
        if seconds <= 0 or nbytes < MIN_WIRE_SAMPLE_BYTES:
            return
        bw = nbytes / seconds
        with self._wire_lock:
            st = self._wire_obs.get(kind)
            if st is None:
                st = self._wire_obs[kind] = {"bw": bw, "samples": 0,
                                             "bytes": 0, "seconds": 0.0}
            else:
                st["bw"] = ((1 - WIRE_EWMA_ALPHA) * st["bw"]
                            + WIRE_EWMA_ALPHA * bw)
            st["samples"] += 1
            st["bytes"] += nbytes
            st["seconds"] += seconds
            if kind == "peer":
                self.peer_bw = st["bw"]
            elif kind == "cloud":
                self.cloud_bw = st["bw"]

    def wire_calibration(self) -> dict:
        """Measured-link state per kind: ``{kind: {bw, samples, bytes,
        seconds}}`` (empty until :meth:`observe_wire` has seen a
        transfer)."""
        with self._wire_lock:
            return {k: dict(v) for k, v in self._wire_obs.items()}

    def h2d_time(self, nbytes: int) -> float:
        return nbytes / self.h2d_bw

    def d2h_time(self, nbytes: int) -> float:
        return nbytes / self.d2h_bw

    def disk_time(self, nbytes: int) -> float:
        return self.disk_lat + nbytes / self.disk_bw

    def cloud_time(self, nbytes: int) -> float:
        return self.cloud_rtt + nbytes / self.cloud_bw

    # -- cluster fetch-source selection (DESIGN.md §6) ----------------------
    def cloud_fetch_time(self, nbytes: int, ratio: float = 1.0,
                         chunk_bytes: int = PIPELINE_CHUNK_BYTES) -> float:
        """Pulling a model out of the CLOUD tier into local disk.

        With ``ratio > 1`` the blob is stored compressed: the wire leg
        moves ``nbytes / ratio`` and a decompress stage (at
        ``decompress_bw``) joins the chunked pipeline, so the cost is the
        pipelined composition, not the serial sum (DESIGN.md §4).
        """
        if ratio <= 1.0:
            return self.cloud_time(nbytes)
        n = max(1, math.ceil(nbytes / max(1, chunk_bytes)))
        return pipelined_stage_time(
            [nbytes / ratio / self.cloud_bw, nbytes / self.decompress_bw],
            n, lat=self.cloud_rtt)

    def peer_fetch_time(self, nbytes: int, peer_disk: bool = True,
                        ratio: float = 1.0,
                        chunk_bytes: int = PIPELINE_CHUNK_BYTES) -> float:
        """Pulling a model from a peer node over the cluster link.

        The transfer streams, so the bottleneck is min(link, source) —
        when the peer copy is only on its disk the peer-side read rate
        caps the stream; a HOST/DEVICE-resident copy streams from DRAM
        at full link rate. With ``ratio > 1`` the peer compresses on the
        wire: a sender-side compress stage (``compress_bw``) and a
        receiver-side decompress stage join the pipeline while the link
        moves ``nbytes / ratio`` — on a fast peer link the compress stage
        is usually the max-stage, which is exactly why raw peer copies
        often win (DESIGN.md §6).
        """
        if ratio <= 1.0:
            bw = min(self.peer_bw, self.disk_bw) if peer_disk else self.peer_bw
            return self.peer_rtt + nbytes / bw
        src_bw = self.disk_bw if peer_disk else self.cached_read_bw
        n = max(1, math.ceil(nbytes / max(1, chunk_bytes)))
        return pipelined_stage_time(
            [nbytes / src_bw, nbytes / self.compress_bw,
             nbytes / ratio / self.peer_bw, nbytes / self.decompress_bw],
            n, lat=self.peer_rtt)

    def gather_time(self, per_source_seconds, wire_nbytes: int) -> float:
        """Modeled seconds for a collective multi-source gather
        (DESIGN.md §8): every source streams its assigned shards over its
        own link *in parallel*, so the gather finishes with the slowest
        source — but the parallel links share this node's ingest path, so
        the aggregate can never beat ``wire_nbytes / ingest_bw``.

        ``per_source_seconds`` are the modeled single-link seconds for the
        bytes assigned to each source (``peer_fetch_time`` /
        ``cloud_fetch_time`` over that source's share); ``wire_nbytes``
        are the bytes that actually cross this node's ingest link —
        shards served from a local cache are free and must be excluded by
        the caller. An empty assignment costs nothing.
        """
        times = [t for t in per_source_seconds if t > 0.0]
        if not times:
            return 0.0
        return max(max(times), wire_nbytes / self.ingest_bw)

    # -- control-plane costs (DESIGN.md §10) --------------------------------
    def directory_op_time(self, queue_s: float = 0.0) -> float:
        """One placement op (publish/withdraw/lookup) against a directory
        shard: the intra-DC round trip, whatever service backlog the
        owning shard already has (``queue_s`` — the fleet simulator's
        per-shard queue), and the op's own service time. The single-map
        baseline is the degenerate case where EVERY op queues on one
        shard — which is exactly why it stops scaling (DESIGN.md §10)."""
        return self.dir_rtt + queue_s + self.dir_op_s

    def directory_sync_time(self, n_records: int) -> float:
        """One anti-entropy round exchanging ``n_records`` placement
        records between two directory views: a round trip plus the
        per-record merge cost on the receiving side."""
        return self.dir_rtt + max(0, n_records) * self.dir_sync_entry_s

    def streaming_load_time(self, window_nbytes, wire_bw: float,
                            compute_seconds, lat: float = 0.0):
        """``streaming_ttfl_time`` with this system's per-window tail costs
        filled in: deserialize (ingest) + H2D staging + the window's
        compute. Returns the same ``(ttfl, done)`` pair."""
        wire = [n / wire_bw for n in window_nbytes]
        post = [n / self.ingest_bw + n / self.h2d_bw + c
                for n, c in zip(window_nbytes, compute_seconds)]
        return streaming_ttfl_time(wire, post, lat=lat)

    def pick_fetch_source(self, nbytes: int, have_peer: bool,
                          have_cloud: bool, peer_disk: bool = True,
                          peer_s: float = None,
                          cloud_s: float = None,
                          peer_ratio: float = 1.0,
                          cloud_ratio: float = 1.0) -> tuple:
        """Cheapest available source for a DISK-miss fetch.

        Returns ``(source, modeled_seconds)`` with source one of
        ``"peer"`` / ``"cloud"``; raises KeyError when neither is
        available (the caller turns that into FileNotFoundError).
        ``peer_s``/``cloud_s`` override the default link models — the
        cluster passes the holding store's own constants (DESIGN.md §6).
        ``peer_ratio``/``cloud_ratio`` make the default models
        compression-aware (compressed-wire costs) when no override is
        given.
        """
        options = {}
        if have_peer:
            options["peer"] = (peer_s if peer_s is not None
                               else self.peer_fetch_time(nbytes, peer_disk,
                                                         ratio=peer_ratio))
        if have_cloud:
            options["cloud"] = (cloud_s if cloud_s is not None
                                else self.cloud_fetch_time(nbytes,
                                                           ratio=cloud_ratio))
        if not options:
            raise KeyError("no fetch source available")
        src = min(options, key=options.get)
        return src, options[src]

    def compute_time(self, flops: float) -> float:
        return flops / self.peak_flops

    # -- staging models (DESIGN.md §4) -------------------------------------
    def deserialize_time(self, nbytes: int) -> float:
        """Unmarshal is memcpy-bound: bytes at the cached-read rate."""
        return nbytes / self.cached_read_bw

    def staging_serial_time(self, nbytes: int) -> float:
        """Whole-model serial chain: disk read, then deserialize, then H2D."""
        return (self.disk_time(nbytes) + self.deserialize_time(nbytes)
                + self.h2d_time(nbytes))

    def staging_pipelined_time(self, nbytes: int,
                               chunk_bytes: int = PIPELINE_CHUNK_BYTES,
                               ratio: float = 1.0) -> float:
        """Chunked pipeline: fill the pipe once, then pay max(stage) per
        chunk — total = latency + sum(stage) + (n-1) * max(stage). Equals the
        serial time at one chunk and is strictly below it for n >= 2.

        ``ratio > 1`` models staging a blob that is still compressed on
        local storage: the disk stage reads ``nbytes / ratio`` and a
        decompress stage joins the chain — latency won for free until
        decompression becomes the max-stage (DESIGN.md §4 crossover).
        """
        n = max(1, math.ceil(nbytes / max(1, chunk_bytes)))
        stages = [nbytes / ratio / self.disk_bw]
        if ratio > 1.0:
            stages.append(nbytes / self.decompress_bw)
        stages += [nbytes / self.cached_read_bw, nbytes / self.h2d_bw]
        return pipelined_stage_time(stages, n, lat=self.disk_lat)


def drop_page_cache(path: str) -> bool:
    """Best-effort page-cache eviction for ``path`` via
    ``posix_fadvise(POSIX_FADV_DONTNEED)``; the file must be synced first
    (dirty pages are not droppable). Returns False where the platform has
    no fadvise or the filesystem rejects the advice — callers fall back
    gracefully to whatever the first read then measures."""
    if not hasattr(os, "posix_fadvise"):
        return False
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        return True
    except OSError:
        return False


def _timed_read(path: str, view: memoryview) -> float:
    """Seconds to read the whole file into a preallocated buffer
    (``readinto``, unbuffered — measures I/O, not the allocator)."""
    t0 = time.perf_counter()
    with open(path, "rb", buffering=0) as f:
        f.readinto(view)
    return max(time.perf_counter() - t0, 1e-9)


def _memory_read_rate(nbytes: int, view: memoryview) -> float:
    """Page-cache-equivalent read rate measured against tmpfs (/dev/shm).

    On filesystems whose reads never hit the guest page cache (9p/NFS with
    cache=none), re-reading a file measures the backing transport twice and
    the buffered/cached distinction collapses; a tmpfs read IS a
    memory-backed read, so it anchors the cached rate. Returns 0.0 where
    /dev/shm is unavailable."""
    shm_dir = "/dev/shm"
    if not os.path.isdir(shm_dir) or not os.access(shm_dir, os.W_OK):
        return 0.0
    path = os.path.join(shm_dir, f".trims_cached_{os.getpid()}")
    try:
        with open(path, "wb") as f:
            f.write(bytes(nbytes))
        _timed_read(path, view)  # warm: fault in the tmpfs pages
        return nbytes / _timed_read(path, view)
    except OSError:
        return 0.0
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def measure(tmpdir: str | None = None, nbytes: int = 64 * 2 ** 20) -> HardwareModel:
    """Measure real buffered-disk and cached-read bandwidth (paper Table 2).

    The benchmark file is written, fsynced, and *evicted from the page
    cache* (``drop_page_cache``) before the buffered-disk pass — without
    the eviction the pass is served from the cache the write just filled
    and ``disk_bw`` collapses into ``cached_read_bw``. The cached pass is
    the warm re-read, floored by a tmpfs probe for filesystems whose reads
    bypass the guest page cache entirely.
    """
    hw = HardwareModel()
    d = tmpdir or tempfile.gettempdir()
    path = os.path.join(d, f".trims_bench_{os.getpid()}")
    dest = bytearray(nbytes)
    view = memoryview(dest)
    try:
        with open(path, "wb") as f:
            f.write(os.urandom(nbytes))
            f.flush()
            os.fsync(f.fileno())
        drop_page_cache(path)
        buffered = _timed_read(path, view)   # cold: backing storage
        cached = _timed_read(path, view)     # warm: page cache (where one exists)
        hw.disk_bw = max(50e6, nbytes / buffered)
        hw.cached_read_bw = max(hw.disk_bw, nbytes / cached,
                                _memory_read_rate(nbytes, view))
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    return hw


def measure_transfer(hw: HardwareModel, device="cuda",
                     nbytes: int = 256 * 2 ** 20) -> HardwareModel:
    """Set ``hw.h2d_bw``/``hw.d2h_bw`` from timed copies between pageable
    host memory (what the host tier holds) and ``device``, each timed to
    its completion (synchronised), best of three after a warm-up."""
    import torch
    dev = torch.device(device)
    host = torch.empty(nbytes, dtype=torch.uint8)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)

    def best(fn) -> float:
        fn()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        return nbytes / min(times)

    hw.h2d_bw = best(lambda: dst.copy_(host))
    hw.d2h_bw = best(lambda: host.copy_(dst))
    return hw


# the port's own cache file: never the JAX package's trims_hw_constants.json
_CACHE_PATH = os.path.join(tempfile.gettempdir(), "trims_torch_hw_constants.json")
_cached: HardwareModel | None = None


def get_hardware(refresh: bool = False) -> HardwareModel:
    """Measured-once-per-boot constants, cached to disk (paper: 'computed
    once at system startup and cached'). On a machine with a CUDA card the
    host<->device rates are measured too."""
    global _cached
    if _cached is not None and not refresh:
        return _cached
    if not refresh and os.path.exists(_CACHE_PATH):
        try:
            with open(_CACHE_PATH) as f:
                _cached = HardwareModel(**json.load(f))
            return _cached
        except Exception:
            pass
    _cached = measure()
    import torch
    if torch.cuda.is_available():
        measure_transfer(_cached)
    try:
        with open(_CACHE_PATH, "w") as f:
            json.dump(asdict(_cached), f)
    except OSError:
        pass
    return _cached
