"""Median over requests of the time outside the engine: the client latency
less the engine's own ``RequestStats.total_s`` (the queue and the workers'
hand-off)."""
from trimsbench.readers import median_of


def read(run):
    return median_of([r.latency_s - r.stats.total_s for r in run.done])
