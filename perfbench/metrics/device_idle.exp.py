"""Share of the traced window in which no operation ran on the device (device trace)."""
from perfbench.metrics import readers


def read(m):
    return readers.device_idle(m)
