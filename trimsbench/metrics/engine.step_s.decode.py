"""Seconds per decode step over the whole window: the engine's time after
the first token, summed over requests, over the decode steps they made."""


def read(run):
    steps = sum(r.tokens.shape[1] - 1 for r in run.done)
    if not steps:
        return None
    return sum(r.stats.total_s - r.stats.ttft_s for r in run.done) / steps
