"""Topics that finished all of Table 2's systems, evaluation included, per second of the whole window (host clock)."""
from perfbench.metrics import readers


def read(m):
    return readers.exp_topics_per_s(m)
