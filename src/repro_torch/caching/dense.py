"""DenseScorerCache — dense-array scorer cache (paper §4.2 impl. detail).

Counterpart of ``repro.caching.dense``: the same ``scores.npy`` /
``npids.json`` / ``queries.json`` layout (float32, NaN = "not cached"),
so a directory filled by either package serves the other.

When a large proportion of a corpus is scored (e.g. exhaustive
cross-encoder studies), SQLite pays high per-row overheads re-storing
document identifiers.  The paper's alternative backend uses HDF5 plus an
``npids`` docno⇄index sidecar.  HDF5 is unavailable offline, so we use a
functionally identical layout:

* ``scores.npy`` — a memory-mapped float32 matrix ``[n_query_rows, n_docs]``
  with NaN = "not cached";
* ``npids.json`` — the docno enumeration (docno → column index);
* ``queries.json`` — query string → row index (grown on demand).

Like every cache family here, the directory is provenance-managed: a
checksummed ``manifest.json`` records the wrapped transformer's
fingerprint (``on_stale`` = ``error``/``recompute``/``readonly``
applies as usual), budgets from ``caching/economics.py`` are enforced
row-granularly by :meth:`DenseScorerCache.evict`, and an
``access.json`` sidecar feeds TTL-then-LRU victim selection.  The
plan compiler does *not* select this family automatically:
``auto_cache`` routes one-to-many retriever nodes — including the
``dense_topk``-backed ``ir/dense.py`` ``DenseRetriever`` — to
``RetrieverCache`` (whole rankings, any registry backend) and
pointwise scorers to ``ScorerCache``; ``DenseScorerCache`` is the
hand-placed alternative for exhaustive (query × docno) scoring
studies where per-row backend overheads dominate.

The sidecar JSON files are written with the shared atomic-rename
primitive and row allocation / matrix growth happen under the shared
``FileLock`` (``backends.py``), so concurrent shards/threads *of one
process* never observe a torn sidecar or clobber each other's row
assignments.  Concurrent **writer processes** remain unsupported for
this family specifically: each process holds its own in-memory row
map and memmap handle, which the lock cannot reconcile (readers of a
warm cache are fine).  For a directory shared by concurrent writers
use ``ScorerCache`` with any registry backend that does cross-process
locking (``"dbm"``, ``"sqlite"``, or ``"tiered:<disk>"`` —
``caching/backends.py``, ``caching/tiered.py``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.frame import ColFrame
from ..core.pipeline import add_ranks
from .backends import FileLock, atomic_write_bytes
from .base import CacheTransformer
from .economics import AccessStats, CacheBudget

__all__ = ["DenseScorerCache"]


class DenseScorerCache(CacheTransformer):
    """(query row, docno column) → float32 score, dense storage."""

    GROW = 64  # row-capacity growth quantum

    def __init__(self, path: Optional[str] = None, transformer: Any = None,
                 *, docnos: Optional[Sequence[str]] = None,
                 verify_fraction: float = 0.0,
                 fingerprint: Optional[str] = None,
                 on_stale: str = "error",
                 budget: Any = None):
        super().__init__(path, transformer, verify_fraction=verify_fraction,
                         fingerprint=fingerprint, on_stale=on_stale,
                         budget=budget)
        self._npids_path = os.path.join(self.path, "npids.json")
        # the docno enumeration is the cache's key space, not a cached
        # value: keep it across an on_stale="recompute" wipe so the
        # normal reopen-without-docnos path can still rebuild (pass
        # ``docnos`` explicitly when the corpus itself changed)
        if docnos is None and os.path.exists(self._npids_path):
            try:
                with open(self._npids_path) as f:
                    docnos = json.load(f)
            except (OSError, ValueError):
                pass
        self._open_manifest(backend="dense",
                            key_columns=("query", "docno"),
                            value_columns=("score",))
        self._queries_path = os.path.join(self.path, "queries.json")
        self._scores_path = os.path.join(self.path, "scores.npy")
        self._write_lock = FileLock(os.path.join(self.path, ".lock"))
        if os.path.exists(self._npids_path):
            with open(self._npids_path) as f:
                self.docnos: List[str] = json.load(f)
        else:
            if docnos is None:
                raise ValueError("DenseScorerCache needs `docnos` on first "
                                 "creation (the npids enumeration)")
            self.docnos = [str(d) for d in docnos]
            atomic_write_bytes(self._npids_path,
                               json.dumps(self.docnos).encode())
        self._doc_idx: Dict[str, int] = {d: i for i, d in
                                         enumerate(self.docnos)}
        if os.path.exists(self._queries_path):
            with open(self._queries_path) as f:
                self._query_rows: Dict[str, int] = json.load(f)
        else:
            self._query_rows = {}
        self._mat = self._open_matrix()

    # -- storage --------------------------------------------------------------
    def _open_matrix(self) -> np.memmap:
        n_docs = len(self.docnos)
        if not os.path.exists(self._scores_path):
            cap = max(self.GROW, len(self._query_rows))
            mat = np.lib.format.open_memmap(
                self._scores_path, mode="w+", dtype=np.float32,
                shape=(cap, n_docs))
            mat[:] = np.nan
            mat.flush()
            return mat
        return np.lib.format.open_memmap(self._scores_path, mode="r+")

    def _row_for(self, query: str, create: bool) -> Optional[int]:
        row = self._query_rows.get(query)
        if row is None and create:
            # first *free* row index, not len(): eviction leaves gaps in
            # the occupied-row set, and reusing len() would collide with
            # a still-occupied row
            used = set(self._query_rows.values())
            row = next(i for i in range(len(used) + 1) if i not in used)
            if row >= self._mat.shape[0]:
                self._grow(row + 1)
            self._query_rows[query] = row
            atomic_write_bytes(self._queries_path,
                               json.dumps(self._query_rows).encode())
        return row

    def _grow(self, need: int):
        old = self._mat
        cap = max(need, old.shape[0] * 2, self.GROW)
        tmp = self._scores_path + ".tmp"
        new = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.float32,
                                        shape=(cap, old.shape[1]))
        new[:old.shape[0]] = old[:]
        new[old.shape[0]:] = np.nan
        new.flush()
        del old
        os.replace(tmp, self._scores_path)
        self._mat = np.lib.format.open_memmap(self._scores_path, mode="r+")

    def _close_backend(self):
        try:
            self._mat.flush()
            del self._mat
        except Exception:
            pass

    def __len__(self) -> int:
        if not self._query_rows:
            return 0
        rows = sorted(self._query_rows.values())
        return int(np.sum(~np.isnan(self._mat[rows])))

    # -- transform --------------------------------------------------------------
    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0:
            return inp
        queries = [str(q) for q in inp["query"].tolist()]
        docnos = [str(d) for d in inp["docno"].tolist()]
        scores = np.full(len(inp), np.nan, dtype=np.float64)
        miss_idx: List[int] = []
        for i, (q, d) in enumerate(zip(queries, docnos)):
            row = self._query_rows.get(q)
            col = self._doc_idx.get(d)
            if col is None:
                raise KeyError(f"docno {d!r} not in npids enumeration")
            if row is not None:
                v = float(self._mat[row, col])
                if not np.isnan(v):
                    scores[i] = v
                    continue
            miss_idx.append(i)
        self.stats.add(hits=len(inp) - len(miss_idx),
                       misses=len(miss_idx))
        self._note_call(len(inp) - len(miss_idx), len(miss_idx))
        self._note_access(sorted({q.encode("utf-8") for q in queries}))

        if miss_idx:
            t = self._require_transformer(len(miss_idx))
            sub = inp.take(np.asarray(miss_idx, dtype=np.int64))
            out = t(sub)
            if len(out) != len(miss_idx):
                raise ValueError("DenseScorerCache requires a pointwise "
                                 "(1:1) scorer")
            fresh = np.asarray(out["score"], dtype=np.float64)
            if self.readonly:            # stale-readonly: never insert
                for j, i in enumerate(miss_idx):
                    scores[i] = fresh[j]
            else:
                with self._write_lock:   # row alloc + growth are exclusive
                    for j, i in enumerate(miss_idx):
                        row = self._row_for(queries[i], create=True)
                        col = self._doc_idx[docnos[i]]
                        self._mat[row, col] = np.float32(fresh[j])
                        scores[i] = fresh[j]
                    self._mat.flush()
                self.stats.add(inserts=len(miss_idx))

        return add_ranks(inp.assign(score=scores))

    # -- cache economics: row-granular eviction ------------------------------
    def evict(self, budget: Any = None, *,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Row-level eviction: the unit of storage is a query row, so
        TTL/LRU victims are whole rows (NaN-ed out and their row index
        returned to the free pool).  ``max_entries``/``max_bytes``
        budget the non-NaN *cells* (matching ``__len__``) at 4 bytes
        per stored score."""
        eff = CacheBudget.coerce(budget)
        if eff.empty():
            eff = self.budget
        if eff.empty():
            return {"skipped": "no budget (none passed, none recorded)"}
        if self.readonly:
            return {"skipped": "readonly cache (stale-readonly policy)"}
        now = time.time() if now is None else float(now)
        self._flush_access()
        access = AccessStats.load(self.path)
        created = self._manifest.created_at \
            if self._manifest is not None else 0.0
        rows = []                        # (last_used, key, query, row, cells)
        for q, r in self._query_rows.items():
            key = q.encode("utf-8")
            cells = int(np.sum(~np.isnan(self._mat[r])))
            rows.append((access.last_used(key, created), key, q, r, cells))
        rows.sort(key=lambda t: (t[0], t[1]))
        n_cells = sum(t[4] for t in rows)

        victims = []
        survivors = rows
        if eff.ttl_seconds is not None:
            cutoff = now - float(eff.ttl_seconds)
            expired = [t for t in rows if t[0] <= cutoff]
            survivors = rows[len(expired):]
            victims.extend(expired)
        n_expired = len(victims)
        left = n_cells - sum(t[4] for t in victims)
        i = 0
        while i < len(survivors) and (
                (eff.max_entries is not None and left > eff.max_entries)
                or (eff.max_bytes is not None and left * 4 > eff.max_bytes)):
            victims.append(survivors[i])
            left -= survivors[i][4]
            i += 1

        evicted_cells = n_cells - left
        if victims:
            with self._write_lock:
                for _, _, q, r, _ in victims:
                    self._mat[r] = np.nan
                    self._query_rows.pop(q, None)
                self._mat.flush()
                atomic_write_bytes(self._queries_path,
                                   json.dumps(self._query_rows).encode())
            access.forget([t[1] for t in victims])
            access.save(self.path)
        # refresh counts immediately (not only on close) so a verify
        # against the still-open cache sees the post-eviction truth
        self._update_manifest()
        return {"examined": len(rows), "expired": n_expired,
                "evicted": len(victims),
                "evicted_bytes": int(evicted_cells * 4),
                "entries_before": int(n_cells),
                "entries_after": int(left),
                "bytes_after": int(left * 4),
                "bytes_approximate": True,
                "unevictable": 0}
