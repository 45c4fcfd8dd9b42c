"""KeyValueCache — row-wise key→value memoization (paper §4.1).

Counterpart of ``repro.caching.kv`` (same keys, values and stores, so a
directory filled by either package serves the other).

Maps one or more *key* columns to one or more *value* columns under the
assumption that rows are independent and values depend only on keys.
Suitable for Q→Q / D→D stages (query/document rewriters, Doc2Query).

Storage is delegated to a pluggable ``CacheBackend`` (``backends.py``);
the default ``"sqlite"`` matches the paper's implementation (a SQLite
database of pickled blobs).  Rows that miss are re-checked and batched
through the wrapped transformer *inside the backend's exclusive lock*,
so concurrent shards/processes sharing one cache directory compute each
entry exactly once.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import numpy as np

from ..core import trace
from ..core.frame import ColFrame
from .backends import CacheBackend, open_backend, resolve_backend_name
from .base import (CacheTransformer, n_frame_queries, pickle_key,
                   pickle_value, unpickle_value)
from .codecs import (KV_CODEC, decode_kv_batch, decode_kv_value,
                     encode_kv_value, vector_keys)

__all__ = ["KeyValueCache"]


class KeyValueCache(CacheTransformer):
    """Row-by-row key→value cache over a pluggable backend."""

    #: registry name passed to ``open_backend`` when ``backend=None``
    default_backend = "sqlite"

    def __init__(self, path: Optional[str] = None, transformer: Any = None,
                 *, key: Any = "text", value: Any = "text",
                 verify_fraction: float = 0.0,
                 backend: Any = None,
                 fingerprint: Optional[str] = None,
                 on_stale: str = "error",
                 budget: Any = None,
                 async_writes: Optional[bool] = None):
        super().__init__(path, transformer, verify_fraction=verify_fraction,
                         fingerprint=fingerprint, on_stale=on_stale,
                         budget=budget, async_writes=async_writes)
        self.key_cols: Tuple[str, ...] = \
            (key,) if isinstance(key, str) else tuple(key)
        self.value_cols: Tuple[str, ...] = \
            (value,) if isinstance(value, str) else tuple(value)
        # manifest check precedes the store open so a stale directory
        # can be wiped under on_stale="recompute"; fresh dirs negotiate
        # the vectorized codec, pre-codec dirs stay on pickled keys
        self._open_manifest(
            backend=resolve_backend_name(backend, self.default_backend),
            key_columns=self.key_cols, value_columns=self.value_cols,
            codec=KV_CODEC)
        self._backend: CacheBackend = open_backend(
            backend, self.path, default=self.default_backend)
        self._init_dataplane()

    # -- backend -------------------------------------------------------------
    @property
    def backend(self) -> CacheBackend:
        return self._backend

    def _close_backend(self):
        self._backend.close()

    def __len__(self) -> int:
        self._drain_writes()             # enumeration is a flush point
        return len(self._backend)

    # -- transform -----------------------------------------------------------
    def _keys_of(self, frame: ColFrame) -> List[bytes]:
        if len(frame) == 0:
            return []
        if self.codec == KV_CODEC:
            return vector_keys([frame[c] for c in self.key_cols])
        cols = [frame[c].tolist() for c in self.key_cols]
        return [pickle_key(t) for t in zip(*cols)]

    # -- codec dispatch (negotiated per directory, see _open_manifest) -------
    def _encode_value(self, vals: Tuple) -> bytes:
        return encode_kv_value(vals) if self.codec == KV_CODEC \
            else pickle_value(vals)

    def _decode_value(self, blob: bytes) -> Tuple:
        return decode_kv_value(blob) if self.codec == KV_CODEC \
            else unpickle_value(blob)

    # -- prefetch (keys derive from the input frame alone) -------------------
    def prefetch_columns(self) -> Optional[Tuple[str, ...]]:
        return self.key_cols

    def prefetch_keys(self, frame: ColFrame) -> List[bytes]:
        return self._keys_of(frame)

    def _transform_single(self, inp: ColFrame,
                          key: bytes) -> Optional[ColFrame]:
        """Single-key read-through fast path (online serving): one
        ``backend.get``, scalar column assignment — skips the batched
        lookup plumbing and full-frame value assembly on a hit.
        Returns ``None`` on a miss (the generic path then handles the
        compute-once protocol)."""
        blobs, prefetched = self._lookup_many([key])
        blob = blobs[0]
        if blob is None:
            return None
        vals = self._decode_value(blob)
        self.stats.add(hits=1, prefetched=prefetched)
        self._note_call(1, 0)
        self._note_access([key])
        out = inp
        for ci, c in enumerate(self.value_cols):
            v = vals[ci]
            if isinstance(v, (int, float, np.floating, np.integer)):
                col = np.asarray([v], dtype=np.float64)
            else:
                col = np.empty(1, dtype=object)
                col[0] = v
            out = out.assign(**{c: col})
        return out

    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0:
            return inp
        with trace.span("cache.lookup", cache=type(self).__name__,
                        rows=len(inp)):
            keys = self._keys_of(inp)
            if len(inp) == 1 and self.verify_fraction == 0:
                hit = self._transform_single(inp, keys[0])
                if hit is not None:
                    return hit
                # already probed — the compute-once recheck under the
                # lock re-queries anyway
                found: List[Optional[bytes]] = [None]
                prefetched = 0
            else:
                found, prefetched = self._lookup_many(keys)
            miss_idx = [i for i, v in enumerate(found) if v is None]

            if not miss_idx and self.codec == KV_CODEC \
                    and self.verify_fraction == 0:
                cols = decode_kv_batch(found, len(self.value_cols))
                if cols is not None:
                    # warm all-float batch: one frombuffer/reshape instead
                    # of N pickle.loads + per-row column assembly
                    self.stats.add(hits=len(keys), prefetched=prefetched)
                    self._note_call(len(keys), 0)
                    self._note_access(keys)
                    out_frame = inp
                    for ci, c in enumerate(self.value_cols):
                        out_frame = out_frame.assign(
                            **{c: np.ascontiguousarray(cols[:, ci])})
                    return out_frame

            values: List[Optional[Tuple]] = [
                self._decode_value(v) if v is not None else None
                for v in found]

        if miss_idx:
            miss_idx = self._fill_misses(inp, keys, values, miss_idx)
        self.stats.add(hits=len(keys) - len(miss_idx), misses=len(miss_idx),
                       prefetched=prefetched)
        self._note_call(len(keys) - len(miss_idx), len(miss_idx))
        self._note_access(keys)          # hits + fresh inserts alike

        if self.verify_fraction > 0 and len(keys) > len(miss_idx):
            self._verify(inp, keys, values, miss_idx)

        out_frame = inp
        for ci, c in enumerate(self.value_cols):
            col = np.empty(len(inp), dtype=object)
            col[:] = [v[ci] for v in values]
            # preserve numeric dtype when possible
            try:
                col = col.astype(np.float64) if all(
                    isinstance(x, (int, float, np.floating, np.integer))
                    for x in col.tolist()) else col
            except Exception:
                pass
            out_frame = out_frame.assign(**{c: col})
        return out_frame

    def _fill_misses(self, inp: ColFrame, keys: List[bytes],
                     values: List[Optional[Tuple]],
                     miss_idx: List[int]) -> List[int]:
        """Compute-once miss handling: under the backend's exclusive
        lock, re-check the missing keys (another thread/process may have
        inserted them since the optimistic lookup), run the wrapped
        transformer only on what is still absent, and insert.  Returns
        the indices this call actually computed.

        Holding the lock across the compute is what makes the
        exactly-once guarantee hold; the price is that cold-cache
        misses serialize across workers sharing one store (hits stay
        concurrent).  Run cold warm-ups uncached, or accept first-run
        serialization for never-recompute semantics."""
        with trace.span("cache.fill", cache=type(self).__name__,
                        rows=len(miss_idx)), self._backend.lock():
            recheck = self._recheck_many([keys[i] for i in miss_idx])
            still = []
            for i, blob in zip(miss_idx, recheck):
                if blob is None:
                    still.append(i)
                else:
                    values[i] = self._decode_value(blob)
            if not still:
                return []
            t = self._require_transformer(len(still))
            # dedup identical keys within the miss batch
            uniq: dict = {}
            for i in still:
                uniq.setdefault(keys[i], []).append(i)
            rep_rows = [idxs[0] for idxs in uniq.values()]
            miss_frame = inp.take(np.asarray(rep_rows, dtype=np.int64))
            t0 = time.perf_counter()
            with trace.span("cache.compute", rows=len(rep_rows)):
                out = t(miss_frame)
            self.stats.add(compute_s=time.perf_counter() - t0,
                           compute_queries=n_frame_queries(miss_frame))
            if len(out) != len(rep_rows):
                raise ValueError(
                    f"{type(self).__name__}: wrapped transformer returned "
                    f"{len(out)} rows for {len(rep_rows)} inputs — "
                    f"{type(self).__name__} requires a row-wise (1:1) "
                    f"transformer")
            new_items = []
            for j, (k, idxs) in enumerate(uniq.items()):
                val = tuple(out[c][j] for c in self.value_cols)
                new_items.append((k, self._encode_value(val)))
                for i in idxs:
                    values[i] = val
            with trace.span("cache.write", rows=len(new_items)):
                if not self.readonly:    # stale-readonly: never insert
                    # under write-behind this *enqueues* inside the
                    # locked section (the racing recheck sees the
                    # overlay); the barrier makes it durable before the
                    # lock releases so other processes' rechecks see it
                    self._store_many(new_items)
                    self.stats.add(inserts=len(new_items))
                self._write_barrier()
            return still

    # -- determinism verification (beyond paper §6) ---------------------------
    def _verify(self, inp: ColFrame, keys: List[bytes],
                values: List[Optional[Tuple]], miss_idx: List[int]):
        t = self.transformer
        if t is None:
            return
        hit_idx = [i for i in range(len(keys)) if i not in set(miss_idx)]
        rng = np.random.default_rng(0)
        n = max(1, int(len(hit_idx) * self.verify_fraction))
        sample = rng.choice(hit_idx, size=min(n, len(hit_idx)), replace=False)
        frame = inp.take(np.asarray(sample, dtype=np.int64))
        fresh = t(frame)
        for j, i in enumerate(sample):
            got = tuple(fresh[c][j] for c in self.value_cols)
            exp = values[i]
            ok = all(_val_eq(g, e) for g, e in zip(got, exp))
            if not ok:
                raise AssertionError(
                    f"KeyValueCache determinism violation at key index {i}: "
                    f"cached {exp!r} vs fresh {got!r}")
        self.stats.add(verified=len(sample))


def _val_eq(a, b) -> bool:
    if isinstance(a, (float, np.floating)) and isinstance(b, (float, np.floating)):
        return bool(np.isclose(a, b, rtol=1e-5, atol=1e-6))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.allclose(np.asarray(a), np.asarray(b),
                                rtol=1e-5, atol=1e-6))
    return a == b
