"""Share of the traced R-GAT window in which no operation ran on the card."""
from portbench.readers import idle_share


def read(run):
    return idle_share(run)
