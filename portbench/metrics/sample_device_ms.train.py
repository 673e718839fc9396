"""Card milliseconds a training step launched inside the program's ``train.sample`` span."""
from portbench.phases import device_ms


def read(run):
    return device_ms(run, "sample")
