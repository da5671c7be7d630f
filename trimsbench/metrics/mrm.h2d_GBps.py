"""Bytes staged host to device over the MRM's measured (synchronised)
H2D seconds, summed over the window's host-tier hits (``OpenTimings``)."""


def read(run):
    hits = [o for o in run.opens if o[1] == "host" and o[3] > 0]
    if not hits:
        return None
    return sum(o[2] for o in hits) / sum(o[3] for o in hits) / 1e9
