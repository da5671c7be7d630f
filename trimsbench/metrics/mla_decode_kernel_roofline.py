"""The latent decode attention kernel's share of its roofline over the window."""
from trimsbench.readers import roofline


def read(run):
    return roofline(run, "mla_decode_kernel")
