"""Arithmetic shared by the metric readers in ``metrics/``.

Each reader is a file of its own, found by the metric's name, and calls one
of these on the run (``run.Run``). A reader returns ``None`` where the run
holds nothing for it to read; it never returns 0 for a share of a peak.
"""
from __future__ import annotations

import math
import statistics
from typing import List, Optional

from trimsbench import flops


def latencies(run) -> List[float]:
    """Client latency of every request of the window; a failed one counts
    as infinite."""
    return [math.inf if r.error is not None else r.latency_s for r in run.records]


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def median_of(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def mfu(run) -> Optional[float]:
    """Useful model operations of every finished request over the window,
    as a share (%) of the card's bf16 peak."""
    t = run.t
    ops = sum(flops.request_flops(run.c, t["batch"], t["prompt"], t["new_tokens"])
              for _ in run.done)
    return 100.0 * ops / (run.window_s * flops.PEAKS["bf16_flops_per_s"]) if ops else None


def roofline(run, kernel: str) -> Optional[float]:
    """Least time of every call of ``kernel`` that the window's requests
    made, over the device time the trace shows for those calls (%). Nothing
    where the trace is missing or its calls do not match the requests."""
    if run.trace is None or len(run.done) != len(run.records):
        return None
    t = run.t
    per_req = flops.request_kernel_bounds(run.c, t["batch"], t["prompt"], t["new_tokens"])
    bounds = per_req.get(kernel)
    n, seconds = run.trace.kernel(kernel)
    if not bounds or n != len(bounds) * len(run.done) or seconds <= 0:
        return None
    return 100.0 * sum(bounds) * len(run.done) / seconds


def idle_share(run) -> Optional[float]:
    """Share (%) of the traced window in which nothing ran on the card."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
