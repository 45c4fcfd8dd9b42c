"""Requests per micro-batch of the service (ServiceStats)."""
from perfbench.metrics import readers


def read(m):
    return readers.requests_per_batch(m)
