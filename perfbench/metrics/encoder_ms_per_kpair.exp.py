"""Device milliseconds of the encoder calls (graph replays and copies) per 1,000 pairs scored (device trace)."""
from perfbench.metrics import readers


def read(m):
    return readers.encoder_ms_per_kpair(m)
