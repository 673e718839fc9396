"""B1's share of its sector bound over the traced training steps."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "window_sample_kernel", "b1_bytes")
