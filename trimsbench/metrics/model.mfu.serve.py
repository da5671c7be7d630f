"""Useful model operations of the finished requests over the window, as a
share of the card's bf16 peak (``flops.request_flops``)."""
from trimsbench.readers import mfu


def read(run):
    return mfu(run)
