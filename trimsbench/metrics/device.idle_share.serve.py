"""Share (%) of the traced window with nothing running on the card."""
from trimsbench.readers import idle_share


def read(run):
    return idle_share(run)
