"""Chunked, double-buffered staging pipeline (DESIGN.md §4).

Model staging is a chain of bandwidth-bound stages — disk read,
deserialize, host->device copy — that a serial loader pays for in sequence.
This module runs the chain as a software pipeline: the model is cut into
fixed-size chunks (whole tensors, grouped up to ``chunk_bytes``) and each
stage runs in its own thread, connected by bounded queues of depth
``depth`` (a double buffer at the default 2). Steady-state cost is then
``max(stage)`` per chunk instead of ``sum(stage)`` — the overlap the paper's
multi-tier staging needs to hide I/O behind PCIe transfers.

The runner is deliberately generic (items in, per-stage callables, stats
out) so the MRM uses one mechanism for disk->host, host->device, and the
full three-stage cold path — the compressed-transfer paths
(ObjectStore fetch, peer wire) use the same runner with a **decompress**
stage in the chain, so decode overlaps the transfer instead of
serializing after it (DESIGN.md §4), and the cluster's multi-source
shard gather streams ``shard_fetch | assemble`` through it so shard
N+1's fetch overlaps shard N's verification and placement into the
assembled file (DESIGN.md §8).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Sequence, Tuple

_STOP = object()


@dataclass
class StageStats:
    name: str
    busy_s: float = 0.0
    items: int = 0
    bytes: int = 0  # only counted for stages declared with a sizer


@dataclass
class PipelineReport:
    stages: List[StageStats] = field(default_factory=list)
    wall_s: float = 0.0
    n_chunks: int = 0

    def busy_total(self) -> float:
        return sum(s.busy_s for s in self.stages)

    def overlap_s(self) -> float:
        """Seconds of stage work hidden by pipelining (0 when serial)."""
        return max(0.0, self.busy_total() - self.wall_s)

    def stage(self, name: str) -> StageStats:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(name)


def plan_chunks(sized_items: Sequence[Tuple[object, int]],
                chunk_bytes: int) -> List[List[object]]:
    """Group (item, nbytes) pairs into chunks of ~``chunk_bytes``.

    Items stay whole (a tensor larger than ``chunk_bytes`` forms its own
    chunk) and order is preserved, so downstream offsets stay sequential.
    """
    chunks: List[List[object]] = []
    cur: List[object] = []
    cur_bytes = 0
    for item, nbytes in sized_items:
        if cur and cur_bytes + nbytes > chunk_bytes:
            chunks.append(cur)
            cur, cur_bytes = [], 0
        cur.append(item)
        cur_bytes += nbytes
    if cur:
        chunks.append(cur)
    return chunks


def run_pipeline(items: Sequence[object],
                 stages: Sequence[Tuple],
                 depth: int = 2) -> Tuple[List[object], PipelineReport]:
    """Run every item through ``stages`` with bounded inter-stage queues.

    Each stage is ``(name, fn)`` — or ``(name, fn, sizer)`` where
    ``sizer(result) -> int`` accumulates per-stage byte counts into
    ``StageStats.bytes`` (transfer pipelines use ``len`` to report wire vs
    decompressed bytes). ``fn(item) -> item`` feeds the next stage. All
    stages execute concurrently (one thread each); queues of ``depth``
    bound the number of chunks in flight, so peak extra memory is
    ``depth * chunk_bytes`` per stage boundary. The first exception aborts
    the pipeline and is re-raised in the caller.

    Returns (outputs of the last stage in order, PipelineReport).
    """
    names = [s[0] for s in stages]
    fns = [s[1] for s in stages]
    sizers = [s[2] if len(s) > 2 else None for s in stages]
    report = PipelineReport(stages=[StageStats(n) for n in names],
                            n_chunks=len(items))
    if not items:
        return [], report
    t_wall = time.perf_counter()
    queues = [queue.Queue(maxsize=max(1, depth)) for _ in range(len(stages))]
    out_q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    errors: List[BaseException] = []

    def worker(idx: int, fn: Callable, inq: "queue.Queue", outq: "queue.Queue"):
        sizer = sizers[idx]
        while True:
            item = inq.get()
            if item is _STOP:
                outq.put(_STOP)
                return
            if errors:
                continue  # discard but keep draining so upstream never blocks
            t0 = time.perf_counter()
            try:
                res = fn(item)
            except BaseException as e:  # noqa: BLE001 — re-raised by caller
                errors.append(e)
                continue
            st = report.stages[idx]
            st.busy_s += time.perf_counter() - t0
            st.items += 1
            if sizer is not None:
                st.bytes += sizer(res)
            outq.put(res)

    threads = []
    for i, fn in enumerate(fns):
        outq = queues[i + 1] if i + 1 < len(stages) else out_q
        t = threading.Thread(target=worker, args=(i, fn, queues[i], outq),
                             daemon=True, name=f"stage-{names[i]}")
        t.start()
        threads.append(t)

    def feed():
        for item in items:
            if errors:
                break
            queues[0].put(item)
        queues[0].put(_STOP)

    feeder = threading.Thread(target=feed, daemon=True, name="stage-feed")
    feeder.start()

    outputs: List[object] = []
    while True:
        res = out_q.get()
        if res is _STOP:
            break
        outputs.append(res)
    feeder.join()
    for t in threads:
        t.join()
    report.wall_s = time.perf_counter() - t_wall
    if errors:
        raise errors[0]
    return outputs, report
