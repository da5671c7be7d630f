"""Share (%) of the window's decode steps that the engine replayed from a
CUDA graph (``RequestStats.graph_steps``); nothing where the engine keeps no
such count."""


def read(run):
    if not run.done or any(not hasattr(r.stats, "graph_steps") for r in run.done):
        return None
    steps = sum(r.tokens.shape[1] - 1 for r in run.done)
    if not steps:
        return None
    return 100.0 * sum(r.stats.graph_steps for r in run.done) / steps
