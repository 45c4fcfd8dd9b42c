"""CUDA graphs the encoders captured inside the window (the CompileCache's
misses there): set-up work that requests or Experiments waited for."""
from perfbench.metrics import readers


def read(m):
    return readers.captures_in_window(m)
