"""Useful model operations of the finished requests over the window, as a
share of the card's bf16 peak; routed experts count as the top-k a token uses."""
from trimsbench.readers import mfu


def read(run):
    return mfu(run)
