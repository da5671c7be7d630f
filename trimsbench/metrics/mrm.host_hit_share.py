"""Share (%) of the window's requests whose model the MRM staged from the
host tier (``RequestStats.tier_hit``)."""


def read(run):
    if not run.done:
        return None
    return 100.0 * sum(r.stats.tier_hit == "host" for r in run.done) / len(run.done)
