"""Join the port's spans to a ``torch.profiler`` trace of the card, and read
the per-layer numbers that need both.

Spans are the records of the port's recorder (``runtime/trace.py``), read
here as plain tuples, so nothing of the program is imported::

    (name, start_ns, end_ns, thread_id, span_id, parent_id, request_id, attrs)

The trace gives each CUDA runtime call as (name, start_ns, end_ns,
thread_id, correlation_id) and each kernel, copy or memset on the card as
(name, start_ns, end_ns, correlation_id) (:func:`events`). Both clocks are
``time.time_ns()``'s, and a runtime call's thread id is the one the
recorder stamps on the spans of the same thread.

- A kernel, copy or memset belongs to the span its runtime call belongs to
  (the correlation id). A runtime call belongs to the innermost span open
  on its own thread when it started. Where none is open there, it belongs
  to the latest-started span named in ``BY_INTERVAL`` open at that time on
  any thread: ``mrm.stage`` copies are launched from the staging
  pipeline's threads, not from the thread that holds the span.
- An idle gap of the card inside the window (every gap) belongs to the
  latest-started span open at its middle, on any thread, or to
  ``no_span``.
- ``workers.queue`` marks a wait: the worker's thread does other work
  meanwhile, so it owns no call and no gap.

A span's own numbers count what belongs to it; :meth:`Joined.inside` adds
those of the spans nested in it.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from trimsbench.devtrace import _union

NAME, START, END, TID, SID, PARENT, RID, ATTRS = range(8)
BY_INTERVAL = ("mrm.stage",)
WAITING = ("workers.queue",)
# runtime calls that put work on the card: launches, copies and memsets
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cuMemcpy",
            "cudaMemset", "cuMemset")
NO_SPAN = "no_span"


def events(prof) -> Tuple[list, list]:
    """The runtime calls and the device activity of a stopped
    ``torch.profiler.profile`` (CUDA activity), as plain tuples. The
    profiler gives a runtime call's thread as ``device_resource_id()``;
    its ``start_thread_id()`` is the same for every call without CPU
    activity."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    runtime, device = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            device.append((ev.name(), s, e, ev.correlation_id()))
        elif ev.name().startswith("cu"):
            runtime.append((ev.name(), s, e, ev.device_resource_id(), ev.correlation_id()))
    return runtime, device


def _innermost(starts: np.ndarray, ends: np.ndarray, idx: np.ndarray):
    """Flatten spans of one thread, nested as a stack, into boundaries and
    the span open innermost from each boundary on (-1: none)."""
    order = idx[np.lexsort((-ends[idx], starts[idx]))]
    stack: List[int] = []
    bounds: List[int] = []
    labels: List[int] = []
    for i in order:
        s = starts[i]
        while stack and ends[stack[-1]] <= s:
            j = stack.pop()
            bounds.append(ends[j])
            labels.append(stack[-1] if stack else -1)
        stack.append(i)
        bounds.append(s)
        labels.append(i)
    while stack:
        j = stack.pop()
        bounds.append(ends[j])
        labels.append(stack[-1] if stack else -1)
    return np.asarray(bounds, dtype=np.int64), np.asarray(labels, dtype=np.int64)


def _lookup(flat, t: np.ndarray) -> np.ndarray:
    bounds, labels = flat
    k = np.searchsorted(bounds, t, side="right") - 1
    out = np.full(t.shape, -1, dtype=np.int64)
    ok = k >= 0
    out[ok] = labels[k[ok]]
    return out


def _latest(flats, starts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The latest-started span open at each time of ``t`` over the threads
    ``flats`` (each thread's innermost open span is its latest-started)."""
    best = np.full(t.shape, -1, dtype=np.int64)
    for flat in flats:
        got = _lookup(flat, t)
        later = starts[np.maximum(got, 0)] > starts[np.maximum(best, 0)]
        take = (got >= 0) & ((best < 0) | later)
        best[take] = got[take]
    return best


@dataclass
class Joined:
    """The spans with what belongs to each: device seconds, launches (runtime
    calls that put work on the card) and idle seconds of the card; the same
    for what belongs to no span."""
    spans: list
    device_s: np.ndarray
    launches: np.ndarray
    idle_s: np.ndarray
    no_span: Dict[str, float]

    def __post_init__(self):
        self._index = {r[SID]: i for i, r in enumerate(self.spans)}

    def named(self, name: str) -> List[int]:
        return [i for i, r in enumerate(self.spans) if r[NAME] == name]

    def ancestors(self, i: int):
        p = self.spans[i][PARENT]
        while p and p in self._index:
            i = self._index[p]
            yield i
            p = self.spans[i][PARENT]

    def inside(self, values: np.ndarray) -> np.ndarray:
        """``values`` of each span plus those of the spans nested in it."""
        out = values.astype(float)
        for i in range(len(self.spans)):
            for a in self.ancestors(i):
                out[a] += values[i]
        return out

    def host_s(self, i: int) -> float:
        r = self.spans[i]
        return (r[END] - r[START]) / 1e9

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: count, host seconds, self seconds (less the part
        its children cover), and the device seconds, launches and idle
        seconds that belong to it; ``no_span`` last."""
        kids: Dict[int, List[Tuple[int, int]]] = {}
        for r in self.spans:
            if r[PARENT]:
                kids.setdefault(r[PARENT], []).append((r[START], r[END]))
        out: Dict[str, Dict[str, float]] = {}
        for i, r in enumerate(self.spans):
            covered = 0
            for s, e in _union(kids.get(r[SID], ())):
                covered += max(0, min(e, r[END]) - max(s, r[START]))
            row = out.setdefault(r[NAME], dict(count=0, host_s=0.0, self_s=0.0, device_s=0.0,
                                               launches=0, idle_s=0.0))
            row["count"] += 1
            row["host_s"] += (r[END] - r[START]) / 1e9
            row["self_s"] += (r[END] - r[START] - covered) / 1e9
            row["device_s"] += float(self.device_s[i])
            row["launches"] += int(self.launches[i])
            row["idle_s"] += float(self.idle_s[i])
        out[NO_SPAN] = dict(self.no_span)
        return out


def join(spans: list, runtime: list, device: list, t0: int, t1: int) -> Joined:
    """Give each kernel, launch and idle gap of the window ``t0``..``t1`` its
    span, by the rules of the module's docstring."""
    n = len(spans)
    starts = np.array([r[START] for r in spans], dtype=np.int64).reshape(n)
    ends = np.array([r[END] for r in spans], dtype=np.int64).reshape(n)
    tid = np.array([r[TID] for r in spans], dtype=np.int64).reshape(n)
    working = np.array([r[NAME] not in WAITING for r in spans], dtype=bool).reshape(n)
    by_interval = np.array([r[NAME] in BY_INTERVAL for r in spans], dtype=bool).reshape(n)
    threads = np.unique(tid)
    own = {t: _innermost(starts, ends, np.nonzero(working & (tid == t))[0]) for t in threads}
    interval = [_innermost(starts, ends, np.nonzero(by_interval & (tid == t))[0])
                for t in threads]

    rt_start = np.array([c[1] for c in runtime], dtype=np.int64)
    rt_tid = np.array([c[3] for c in runtime], dtype=np.int64)
    owner = np.full(len(runtime), -1, dtype=np.int64)
    for t in threads:
        on = np.nonzero(rt_tid == t)[0]
        owner[on] = _lookup(own[t], rt_start[on])
    orphan = np.nonzero(owner < 0)[0]
    owner[orphan] = _latest(interval, starts, rt_start[orphan])

    device_s = np.zeros(n)
    launches = np.zeros(n, dtype=np.int64)
    no_span = dict(device_s=0.0, launches=0, idle_s=0.0)
    in_window = (rt_start >= t0) & (rt_start <= t1)
    is_launch = np.array([c[0].startswith(LAUNCHES) for c in runtime], dtype=bool)
    counted = owner[in_window & is_launch]
    np.add.at(launches, counted[counted >= 0], 1)
    no_span["launches"] = int((counted < 0).sum())

    by_corr = {c[4]: k for k, c in enumerate(runtime)}
    busy = []
    for _, s, e, corr in device:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        busy.append((s, e))
        k = by_corr.get(corr)
        i = owner[k] if k is not None else -1
        if i >= 0:
            device_s[i] += (e - s) / 1e9
        else:
            no_span["device_s"] += (e - s) / 1e9

    edges = [t0] + [x for iv in _union(busy) for x in iv] + [t1]
    gaps = np.array([(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a],
                    dtype=np.int64).reshape(-1, 2)
    idle_s = np.zeros(n)
    if len(gaps):
        length = (gaps[:, 1] - gaps[:, 0]) / 1e9
        gap_owner = _latest([own[t] for t in threads], starts, (gaps[:, 0] + gaps[:, 1]) // 2)
        np.add.at(idle_s, gap_owner[gap_owner >= 0], length[gap_owner >= 0])
        no_span["idle_s"] = float(length[gap_owner < 0].sum())
    return Joined(list(spans), device_s, launches, idle_s, no_span)


def _median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def _per_decode_step(j: Joined, name: str) -> Optional[float]:
    steps = j.named("engine.decode_step")
    if not steps:
        return None
    step_set = set(steps)
    total = sum(j.device_s[i] for i in j.named(name)
                if any(a in step_set for a in j.ancestors(i)))
    return float(total) / len(steps)


def queue_wait_s(j: Joined) -> Optional[float]:
    """Median wait in the workers' queue, submit to dequeue."""
    return _median([j.host_s(i) for i in j.named("workers.queue")])


def load_s_device_hits(j: Joined) -> Optional[float]:
    """Median ``engine.load`` of requests whose model was on the card."""
    return _median([j.host_s(i) for i in j.named("engine.load")
                    if j.spans[i][ATTRS].get("tier") == "device"])


def stage_s(j: Joined) -> Optional[float]:
    """Median ``mrm.stage``: reservation to the last synchronised copy."""
    return _median([j.host_s(i) for i in j.named("mrm.stage")])


def stage_idle_s(j: Joined) -> Optional[float]:
    """Idle seconds of the card that belong to ``mrm.stage`` spans, per stage
    (one a host-tier hit)."""
    stages = j.named("mrm.stage")
    return float(sum(j.idle_s[i] for i in stages)) / len(stages) if stages else None


def step_host_s(j: Joined) -> Optional[float]:
    """Median ``engine.decode_step`` on the host clock."""
    return _median([j.host_s(i) for i in j.named("engine.decode_step")])


def launches_per_step(j: Joined) -> Optional[float]:
    """Runtime calls that put work on the card inside decode steps (nested
    spans included), per step."""
    steps = j.named("engine.decode_step")
    if not steps:
        return None
    inside = j.inside(j.launches)
    return float(sum(inside[i] for i in steps)) / len(steps)


def dispatch_device_s(j: Joined) -> Optional[float]:
    """Device seconds launched inside ``moe.dispatch`` within decode steps,
    per decode step."""
    return _per_decode_step(j, "moe.dispatch")


def experts_device_s(j: Joined) -> Optional[float]:
    """Device seconds launched inside ``moe.experts`` within decode steps,
    per decode step."""
    return _per_decode_step(j, "moe.experts")


# what each of the per-layer metrics these spans are for would read
METRICS = {
    "workers.queue_wait_s.serve": queue_wait_s,
    "engine.load_s.serve": load_s_device_hits,
    "mrm.stage_s.swap": stage_s,
    "mrm.stage_idle_s.swap": stage_idle_s,
    "engine.step_host_s.decode": step_host_s,
    "engine.launches_per_step.decode": launches_per_step,
    "moe.dispatch_device_s.decode": dispatch_device_s,
    "moe.experts_device_s.decode": experts_device_s,
}
