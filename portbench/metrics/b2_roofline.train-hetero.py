"""B2's share of its bound (distinct rows read, rows written) over the traced R-GAT steps, once a node type."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "b2_", "b2_bytes")
