# Explicit caching strategies (paper §4): counterpart of repro.caching
# with the cache families, their backends and tiers, provenance
# manifests, economics, codecs, the Artifact API and auto_cache.  Left
# for later slices (ROADMAP Queue A): the mmap snapshot tier and the
# async data plane (item 3), cache warming, which needs serving (item 4),
# and the compile cache, whose counterpart is a CUDA-graph memo (item 5).
from .backends import (BACKENDS, CacheBackend, DbmBackend, FileLock,
                       MemoryLRUBackend, PickleDirBackend, SQLiteBackend,
                       atomic_write_bytes, backend_store_exists,
                       measure_round_trip, open_backend,
                       registered_selectors, resolve_backend_name,
                       select_backend, split_combinator, split_mmap,
                       split_tiered, storage_identity)
from .tiered import TieredBackend
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
from .dense import DenseScorerCache
from .retriever import RetrieverCache
from .indexer import IndexerCache
from .lazy import Lazy
from .artifact import Artifact, to_hub, from_hub, hub_dir, \
    install_artifact_methods
from .bucketing import BucketedRunner, bucket_size, pad_batch
from .auto import (auto_cache, auto_cache_or_none, derive_fingerprint,
                   typecheck_pipeline, UncacheableError)

# Artifact API conformance for every cache family (paper §4.5)
for _cls in (KeyValueCache, ScorerCache, DenseScorerCache, RetrieverCache,
             IndexerCache):
    install_artifact_methods(_cls)

__all__ = [
    "BACKENDS", "CacheBackend", "MemoryLRUBackend", "PickleDirBackend",
    "DbmBackend", "SQLiteBackend", "TieredBackend", "FileLock",
    "atomic_write_bytes", "backend_store_exists", "measure_round_trip",
    "open_backend", "registered_selectors", "resolve_backend_name",
    "select_backend", "split_combinator", "split_mmap", "split_tiered",
    "storage_identity",
    "CacheManifest", "ManifestError", "ProvenanceError", "StaleCacheError",
    "combine_fingerprints", "digest_bytes", "set_digest_device",
    "transformer_fingerprint",
    "AccessStats", "CacheBudget", "enforce_dir", "evict_entries",
    "CacheMissError", "CacheStats", "CacheTransformer",
    "KV_CODEC", "RETRIEVER_CODEC", "KNOWN_CODECS", "scalar_key",
    "vector_keys",
    "KeyValueCache", "ScorerCache", "DenseScorerCache", "RetrieverCache",
    "IndexerCache", "Lazy", "Artifact", "to_hub", "from_hub", "hub_dir",
    "BucketedRunner", "bucket_size", "pad_batch",
    "auto_cache", "auto_cache_or_none", "derive_fingerprint",
    "typecheck_pipeline", "UncacheableError",
]
