"""Set-up: process start to the first timed request or Experiment, compilation included (host clock)."""
from perfbench.metrics import readers


def read(m):
    return readers.setup_s(m)
