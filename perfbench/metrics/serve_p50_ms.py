"""Median latency of the requests sent in the window, each from when it was due to when its result came back (host clock)."""
from perfbench.metrics import readers


def read(m):
    return readers.serve_latency_ms(m, 50)
