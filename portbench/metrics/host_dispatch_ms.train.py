"""Host milliseconds to return from one call of the fused step in the window (no wait for the card)."""
from portbench.readers import layer_ms


def read(run):
    return layer_ms(run, "host_dispatch_s")
