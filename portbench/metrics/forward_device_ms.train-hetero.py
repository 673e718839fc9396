"""Card milliseconds a fused R-GAT step launched inside the program's ``train.forward`` span."""
from portbench.phases_hetero import device_ms


def read(run):
    return device_ms(run, "forward")
