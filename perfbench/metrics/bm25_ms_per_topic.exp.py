"""Milliseconds in BM25Retriever.transform per topic retrieved (span)."""
from perfbench.metrics import readers


def read(m):
    return readers.bm25_ms_per_topic(m)
