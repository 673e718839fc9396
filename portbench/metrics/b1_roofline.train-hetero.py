"""B1's share of its sector bound over the traced R-GAT steps' blocks (the literal entry, once a block)."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "window_sample_kernel", "b1_bytes")
