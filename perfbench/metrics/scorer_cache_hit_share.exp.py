"""The ScorerCache's hits over its lookups in the window (its CacheStats)."""
from perfbench.metrics import readers


def read(m):
    return readers.scorer_cache_hit_share(m)
