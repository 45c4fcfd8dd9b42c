"""The encoders' unpadded FLOPs over the traced window at float32's peak of 67 TFLOP/s."""
from perfbench.metrics import readers


def read(m):
    return readers.mfu(m)
