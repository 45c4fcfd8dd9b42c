"""Non-padding tokens of the pairs over the tokens the encoder computes, padded rows and positions included (counts at the encoder's entry)."""
from perfbench.metrics import readers


def read(m):
    return readers.useful_token_share(m)
