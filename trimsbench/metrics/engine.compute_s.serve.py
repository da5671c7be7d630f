"""Median ``RequestStats.compute_s``: prefill and decode on the engine's
host clock, to a synchronised end."""
from trimsbench.readers import median_of


def read(run):
    return median_of([r.stats.compute_s for r in run.done])
