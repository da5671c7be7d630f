"""Requests finished over the whole window, in a cell that stages models
from the host tier."""


def read(run):
    return len(run.done) / run.window_s
