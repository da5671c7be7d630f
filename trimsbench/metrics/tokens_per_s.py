"""Output tokens of every finished request over the whole window."""


def read(run):
    return sum(r.tokens.size for r in run.done) / run.window_s
