# Model zoo counterpart of repro.models: the shared machinery, the
# cross-encoder and the decoder-only LM family (recsys and gcn follow).
