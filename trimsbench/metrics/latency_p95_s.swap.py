"""95th percentile of the client latency over every request of the window,
in a cell whose tail is its host-tier hits; a failed request counts as
infinite."""
from trimsbench.readers import latencies, percentile


def read(run):
    return percentile(latencies(run), 95)
