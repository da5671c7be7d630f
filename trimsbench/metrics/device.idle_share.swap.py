"""Share (%) of the traced window with nothing running on the card, in a
cell that stages models from the host tier."""
from trimsbench.readers import idle_share


def read(run):
    return idle_share(run)
