# Explicit caching strategies (paper §4): counterpart of repro.caching
# with the hand-wrapped KeyValueCache / ScorerCache families, their
# backends, provenance manifests, economics and codecs.
from .backends import (BACKENDS, CacheBackend, DbmBackend, FileLock,
                       MemoryLRUBackend, PickleDirBackend, SQLiteBackend,
                       atomic_write_bytes, backend_store_exists,
                       measure_round_trip, open_backend,
                       registered_selectors, resolve_backend_name,
                       select_backend, split_combinator, storage_identity)
from .provenance import (CacheManifest, ManifestError, ProvenanceError,
                         StaleCacheError, combine_fingerprints,
                         digest_bytes, set_digest_device,
                         transformer_fingerprint)
from .economics import (AccessStats, CacheBudget, enforce_dir,
                        evict_entries)
from .base import CacheMissError, CacheStats, CacheTransformer
from .codecs import (KV_CODEC, RETRIEVER_CODEC, KNOWN_CODECS, scalar_key,
                     vector_keys)
from .kv import KeyValueCache
from .scorer import ScorerCache
from .bucketing import BucketedRunner, bucket_size, pad_batch
from .auto import derive_fingerprint

__all__ = [
    "BACKENDS", "CacheBackend", "MemoryLRUBackend", "PickleDirBackend",
    "DbmBackend", "SQLiteBackend", "FileLock", "atomic_write_bytes",
    "backend_store_exists", "measure_round_trip", "open_backend",
    "registered_selectors", "resolve_backend_name", "select_backend",
    "split_combinator", "storage_identity",
    "CacheManifest", "ManifestError", "ProvenanceError", "StaleCacheError",
    "combine_fingerprints", "digest_bytes", "set_digest_device", "transformer_fingerprint",
    "AccessStats", "CacheBudget", "enforce_dir", "evict_entries",
    "CacheMissError", "CacheStats", "CacheTransformer",
    "KV_CODEC", "RETRIEVER_CODEC", "KNOWN_CODECS", "scalar_key",
    "vector_keys", "KeyValueCache", "ScorerCache",
    "BucketedRunner", "bucket_size", "pad_batch", "derive_fingerprint",
]
