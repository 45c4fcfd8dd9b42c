"""95th percentile of the same latencies (host clock)."""
from perfbench.metrics import readers


def read(m):
    return readers.serve_latency_ms(m, 95)
