"""Host milliseconds a training step spent in ``train.step`` outside its five phase spans."""
from portbench.phases import host_ms


def read(run):
    return host_ms(run, "train.step")
