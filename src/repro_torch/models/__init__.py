# Model zoo counterpart of repro.models; this slice ports the shared
# machinery and the cross-encoder.
