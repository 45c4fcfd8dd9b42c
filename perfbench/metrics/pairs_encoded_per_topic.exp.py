"""Pairs the Mono and Duo scorers encoded (their invocations) per topic."""
from perfbench.metrics import readers


def read(m):
    return readers.pairs_encoded_per_topic(m)
