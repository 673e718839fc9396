"""Host self milliseconds a training step spent inside the program's ``train.lookup`` span."""
from portbench.phases import host_ms


def read(run):
    return host_ms(run, "train.lookup")
