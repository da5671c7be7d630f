"""Reduce a ``torch.profiler`` trace of the card to what the readers need.

The profiler records the card's activity only (kernels, copies, memsets)
and the CUDA runtime calls that the host made; host operators are not
recorded, so the host runs at nearly its untraced pace. The raw events are
read once, without the profiler's own event tree.

Busy time is the union of the device intervals inside the traced window.
An idle gap is named by what the host was doing in its middle: the CUDA
runtime call in progress (``cudaStreamSynchronize``, ``cudaMemcpyAsync``,
...), ``host_between_calls`` where none was, or ``no_request_in_flight``
where the closed loop held no request at all.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]          # name -> (count, seconds)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel(self, part: str) -> Tuple[int, float]:
        """Calls and device seconds of every kernel whose name holds ``part``."""
        n = s = 0
        for name, (cnt, sec) in self.kernels.items():
            if part in name:
                n += cnt
                s += sec
        return n, s


def _union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def summarize(device: List[Tuple[str, int, int]], runtime: List[Tuple[str, int, int]],
              t0: int, t1: int, in_flight: List[Tuple[int, int]]) -> TraceSummary:
    """``device`` and ``runtime``: (name, start_ns, end_ns) events;
    ``t0``/``t1``: the traced window; ``in_flight``: (start_ns, end_ns) of
    every request, on the profiler's clock."""
    kernels: Dict[str, List[float]] = {}
    clipped = []
    for name, s, e in device:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        clipped.append((s, e))
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
    busy = _union(clipped)
    busy_s = sum(e - s for s, e in busy) / 1e9

    flights = _union(in_flight)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    spans = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                   reverse=True)[:TOP]
    rt_s = np.array([s for _, s, _ in runtime], dtype=np.int64)
    rt_e = np.array([e for _, _, e in runtime], dtype=np.int64)
    gaps = []
    for length, a, b in spans:
        mid = (a + b) // 2
        if not any(s <= mid <= e for s, e in flights):
            label = "no_request_in_flight"
        else:
            hit = np.nonzero((rt_s <= mid) & (rt_e >= mid))[0]
            label = (runtime[hit[np.argmax(rt_s[hit])]][0] if hit.size
                     else "host_between_calls")
        gaps.append((label, length / 1e9))
    ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda kv: -kv[1])
    return TraceSummary(window_s=(t1 - t0) / 1e9, busy_s=busy_s,
                        kernels={n: (int(v[0]), v[1]) for n, v in kernels.items()},
                        device_ops=[(n[:96], s) for n, s in ops[:TOP]],
                        idle_gaps=gaps[:TOP])


def from_profiler(prof, t0: int, t1: int, in_flight) -> TraceSummary:
    """Summarize a stopped ``torch.profiler.profile`` (CUDA activity)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, runtime = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            device.append((ev.name(), s, e))
        elif ev.name().startswith("cuda"):
            runtime.append((ev.name(), s, e))
    return summarize(device, runtime, t0, t1, in_flight)
