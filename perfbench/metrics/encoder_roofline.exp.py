"""The encoder calls' least time on the H100 (unpadded FLOPs at float32's peak or bytes at HBM's, the larger, per call) over their device time."""
from perfbench.metrics import readers


def read(m):
    return readers.encoder_roofline(m)
