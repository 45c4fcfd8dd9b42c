# Explicit caching strategies (paper §4): counterpart of repro.caching
# with the cache families, their backends and tiers, provenance
# manifests, economics, codecs, the Artifact API, auto_cache, the async
# data plane, cache warming and the compile cache, whose counterpart is
# a memo of CUDA graphs keyed by weight source as well as shape.
from .backends import (BACKENDS, CacheBackend, DbmBackend, FileLock,
                       MemoryLRUBackend, PickleDirBackend, SQLiteBackend,
                       atomic_write_bytes, backend_store_exists,
                       measure_round_trip, open_backend,
                       registered_selectors, resolve_backend_name,
                       select_backend, split_combinator, split_mmap,
                       split_tiered, storage_identity)
from .tiered import TieredBackend
from .mmap_tier import MmapTier
from .provenance import (CacheManifest, ManifestError, ProvenanceError,
                         StaleCacheError, combine_fingerprints,
                         digest_bytes, set_digest_device,
                         transformer_fingerprint)
from .economics import (AccessStats, CacheBudget, enforce_dir,
                        evict_entries)
from .base import CacheMissError, CacheStats, CacheTransformer
from .codecs import (KV_CODEC, RETRIEVER_CODEC, KNOWN_CODECS, scalar_key,
                     vector_keys)
from .dataplane import (StagingMap, WriteBehindWriter, io_pool,
                        prefetch_default, write_behind_default)
from .warming import warm_scenario
from .kv import KeyValueCache
from .scorer import ScorerCache
from .dense import DenseScorerCache
from .retriever import RetrieverCache
from .indexer import IndexerCache
from .lazy import Lazy
from .artifact import Artifact, to_hub, from_hub, hub_dir, \
    install_artifact_methods
from .bucketing import BucketedRunner, bucket_size, pad_batch
from .compile_cache import (CompileCache, CompileCacheStats,
                            default_compile_cache, signature_of_args)
from .auto import (auto_cache, auto_cache_or_none, derive_fingerprint,
                   typecheck_pipeline, UncacheableError)

# Artifact API conformance for every cache family (paper §4.5)
for _cls in (KeyValueCache, ScorerCache, DenseScorerCache, RetrieverCache,
             IndexerCache):
    install_artifact_methods(_cls)

__all__ = [
    "BACKENDS", "CacheBackend", "MemoryLRUBackend", "PickleDirBackend",
    "DbmBackend", "SQLiteBackend", "TieredBackend", "MmapTier", "FileLock",
    "atomic_write_bytes", "backend_store_exists", "measure_round_trip",
    "open_backend", "registered_selectors", "resolve_backend_name",
    "select_backend", "split_combinator", "split_mmap", "split_tiered",
    "storage_identity",
    "CacheManifest", "ManifestError", "ProvenanceError", "StaleCacheError",
    "combine_fingerprints", "digest_bytes", "set_digest_device",
    "transformer_fingerprint", "warm_scenario",
    "AccessStats", "CacheBudget", "enforce_dir", "evict_entries",
    "CacheMissError", "CacheStats", "CacheTransformer",
    "KV_CODEC", "RETRIEVER_CODEC", "KNOWN_CODECS", "scalar_key",
    "vector_keys",
    "StagingMap", "WriteBehindWriter", "io_pool", "prefetch_default",
    "write_behind_default",
    "KeyValueCache", "ScorerCache", "DenseScorerCache", "RetrieverCache",
    "IndexerCache", "Lazy", "Artifact", "to_hub", "from_hub", "hub_dir",
    "BucketedRunner", "bucket_size", "pad_batch",
    "CompileCache", "CompileCacheStats", "default_compile_cache",
    "signature_of_args",
    "auto_cache", "auto_cache_or_none", "derive_fingerprint",
    "typecheck_pipeline", "UncacheableError",
]
