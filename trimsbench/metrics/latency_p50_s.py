"""Median client latency (submit to tokens returned) over every request of
the window; a failed request counts as infinite."""
from trimsbench.readers import latencies, percentile


def read(run):
    return percentile(latencies(run), 50)
