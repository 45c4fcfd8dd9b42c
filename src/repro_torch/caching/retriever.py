"""RetrieverCache — one input row → many output rows (paper §4.3).

Counterpart of ``repro.caching.retriever`` (same keys, codec and
stores, so a directory filled by either package serves the other), on
the synchronous path: puts are written through, and the reference's
key prefetch (``prefetch_columns`` / ``prefetch_keys``) comes with the
port's async data plane.

Caches whole per-query result frames.  Storage is delegated to a
pluggable ``CacheBackend`` (``backends.py``); the default ``"dbm"``
matches the paper: a ``dbm`` database keyed per query whose values are
compressed encodings of the value frame.  (The paper compresses with
LZ4; LZ4 is unavailable offline so we use zlib level 1 — same
interface, same asymptotics.)

Serialization is negotiated per directory through the manifest's
``codec`` field (``caching/codecs.py``): a fresh directory keys
entries with the vectorized four-lane FNV digest and stores result
frames *columnar* (raw score/docno arrays — decode goes straight to
``ColFrame`` columns, no per-row dict round trip), while a directory
that predates the field keeps its original SHA256-of-pickle keys and
pickled row dicts, so existing warm dirs stay warm byte for byte.

Misses are re-checked and computed inside the backend's exclusive lock,
so concurrent shards/processes sharing one cache directory retrieve
each query exactly once.
"""
from __future__ import annotations

import hashlib
import pickle
import time
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np

from ..core.frame import ColFrame
from .backends import CacheBackend, open_backend, resolve_backend_name
from .base import CacheTransformer, n_frame_queries, pickle_key
from .codecs import (RETRIEVER_CODEC, decode_columnar_frame,
                     encode_columnar_frame, vector_keys)

__all__ = ["RetrieverCache"]


class RetrieverCache(CacheTransformer):
    """Caches the full result frame per input row (keyed ⟨qid,query⟩)."""

    default_backend = "dbm"

    def __init__(self, path: Optional[str] = None, retriever: Any = None,
                 *, key: Any = ("qid", "query"),
                 verify_fraction: float = 0.0,
                 backend: Any = None,
                 fingerprint: Optional[str] = None,
                 on_stale: str = "error",
                 budget: Any = None):
        super().__init__(path, retriever, verify_fraction=verify_fraction,
                         fingerprint=fingerprint, on_stale=on_stale,
                         budget=budget)
        self.key_cols: Tuple[str, ...] = \
            (key,) if isinstance(key, str) else tuple(key)
        self._open_manifest(
            backend=resolve_backend_name(backend, self.default_backend),
            key_columns=self.key_cols, codec=RETRIEVER_CODEC)
        self._backend: CacheBackend = open_backend(
            backend, self.path, default=self.default_backend)

    @property
    def backend(self) -> CacheBackend:
        return self._backend

    def _close_backend(self):
        self._backend.close()

    # -- encoding ----------------------------------------------------------
    @staticmethod
    def _hash_key(key_tuple: Tuple) -> bytes:
        return hashlib.sha256(pickle_key(key_tuple)).digest()

    def _keys_of(self, frame: ColFrame) -> List[bytes]:
        """Backend keys for every row — the vectorized digest under the
        modern codec, SHA256-of-pickle for legacy directories."""
        if len(frame) == 0:
            return []
        if self.codec == RETRIEVER_CODEC:
            return vector_keys([frame[c] for c in self.key_cols])
        return [self._hash_key(k)
                for k in frame.key_tuples(list(self.key_cols))]

    def _encode_entry(self, sub: ColFrame) -> bytes:
        if self.codec == RETRIEVER_CODEC:
            return encode_columnar_frame(
                [(c, sub[c]) for c in sub.columns], len(sub))
        return zlib.compress(
            pickle.dumps(sub.to_dicts(), protocol=pickle.HIGHEST_PROTOCOL), 1)

    def _decode_entry(self, blob: bytes) -> ColFrame:
        if self.codec == RETRIEVER_CODEC:
            return ColFrame(_unsafe=decode_columnar_frame(blob))
        return ColFrame.from_dicts(pickle.loads(zlib.decompress(blob)))

    def __len__(self) -> int:
        return len(self._backend)

    # -- store-only probe (cache-aware pruning, core/rewrite.py) -----------
    def serve_from_store(self, inp: ColFrame) -> Optional[ColFrame]:
        """Serve the full result from cached entries alone, or ``None``
        when any key misses — never computes.

        Sound as a stand-in for ``transform`` on *any* frame carrying
        the same key-column values, because the output is assembled
        purely from stored rows (input columns never leak into it):
        the planner probes with the input of a deferred augment-only
        chain and only executes the chain when this returns ``None``.
        Counts hits only on success (a failed probe is retried by the
        normal miss path, which does its own accounting).
        """
        if len(inp) == 0:
            return inp
        if any(c not in inp for c in self.key_cols):
            return None                  # probe frame lacks key columns
        hashes = self._keys_of(inp)
        blobs, prefetched = self._lookup_many(hashes)
        if any(b is None for b in blobs):
            return None
        self.stats.add(hits=len(hashes), prefetched=prefetched)
        self._note_call(len(hashes), 0)
        self._note_access(hashes)
        return ColFrame.concat([self._decode_entry(b) for b in blobs])

    # -- transform ----------------------------------------------------------
    def _transform_single(self, hashed: bytes) -> Optional[ColFrame]:
        """Single-key read-through fast path (online serving): one
        lookup and one frame decode — no batched lookup lists, no
        per-entry result bookkeeping.  ``None`` on a miss."""
        blobs, prefetched = self._lookup_many([hashed])
        blob = blobs[0]
        if blob is None:
            return None
        self.stats.add(hits=1, prefetched=prefetched)
        self._note_call(1, 0)
        self._note_access([hashed])
        return self._decode_entry(blob)

    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0:
            return inp
        hashes = self._keys_of(inp)
        if len(inp) == 1:
            hit = self._transform_single(hashes[0])
            if hit is not None:
                return hit
            blobs: List[Optional[bytes]] = [None]   # already probed —
            # the compute-once recheck under the lock re-queries anyway
            prefetched = 0
        else:
            blobs, prefetched = self._lookup_many(hashes)
        results: List[Optional[ColFrame]] = \
            [self._decode_entry(b) if b is not None else None for b in blobs]
        miss_idx = [i for i, b in enumerate(blobs) if b is None]

        if miss_idx:
            miss_idx = self._fill_misses(inp, hashes, results, miss_idx)
        self.stats.add(hits=len(hashes) - len(miss_idx),
                       misses=len(miss_idx), prefetched=prefetched)
        self._note_call(len(hashes) - len(miss_idx), len(miss_idx))
        self._note_access(hashes)        # hits + fresh inserts alike

        return ColFrame.concat([r for r in results if r is not None])

    def _fill_misses(self, inp: ColFrame, hashes: List[bytes],
                     results: List[Optional[ColFrame]],
                     miss_idx: List[int]) -> List[int]:
        """Compute-once miss handling under the backend lock (see
        ``KeyValueCache._fill_misses``)."""
        key_tuples = inp.key_tuples(list(self.key_cols))
        with self._backend.lock():
            recheck = self._recheck_many([hashes[i] for i in miss_idx])
            still = []
            for i, blob in zip(miss_idx, recheck):
                if blob is None:
                    still.append(i)
                else:
                    results[i] = self._decode_entry(blob)
            if not still:
                return []
            t = self._require_transformer(len(still))
            sub = inp.take(np.asarray(still, dtype=np.int64))
            t0 = time.perf_counter()
            out = t(sub)
            self.stats.add(compute_s=time.perf_counter() - t0,
                           compute_queries=n_frame_queries(sub))
            groups = out.group_indices(list(self.key_cols)) if len(out) else {}
            empty = out.take(np.asarray([], dtype=np.int64))
            items = []
            for i in still:
                idxs = groups.get(key_tuples[i])
                entry = out.take(idxs) if idxs is not None else empty
                items.append((hashes[i], self._encode_entry(entry)))
                results[i] = entry
            if not self.readonly:        # stale-readonly: never insert
                # durable before the lock releases, so other processes'
                # rechecks see it
                self._store_many(items)
                self.stats.add(inserts=len(still))
            return still
