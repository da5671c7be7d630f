"""Requests finished over the whole window."""


def read(run):
    return len(run.done) / run.window_s
