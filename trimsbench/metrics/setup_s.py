"""Process start to the first request of the window (host clock)."""


def read(run):
    return run.setup_s
