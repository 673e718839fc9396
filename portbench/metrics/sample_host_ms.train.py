"""Host self milliseconds a training step spent inside the program's ``train.sample`` span."""
from portbench.phases import host_ms


def read(run):
    return host_ms(run, "train.sample")
