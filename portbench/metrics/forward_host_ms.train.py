"""Host self milliseconds a training step spent inside the program's ``train.forward`` span."""
from portbench.phases import host_ms


def read(run):
    return host_ms(run, "train.forward")
