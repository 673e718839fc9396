"""Live-row R-GAT FLOPs of the window's training steps over its length, as a share of the fp32 peak."""
from portbench.readers import mfu


def read(run):
    return mfu(run, "flops_per_step", "steps")
