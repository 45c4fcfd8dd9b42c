"""Microseconds per HashTokenizer.encode_pair call (span)."""
from perfbench.metrics import readers


def read(m):
    return readers.tokenize_us_per_pair(m)
