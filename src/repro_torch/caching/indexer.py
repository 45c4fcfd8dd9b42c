"""IndexerCache — caching an ordered indexing stream (paper §4.4).

Counterpart of ``repro.caching.indexer``, with the same log, offsets and
``npids.json`` files.

Stores an entire sequence of input rows (order matters — e.g. recursive
graph bisection reorderings).  Unlike the other caches it *is* an
indexer: it is placed after the expensive encoder
(``splade >> IndexerCache(path)``) rather than wrapping it.  Iterating
over the cache replays the stream row by row; if a ``docno`` column is
present an npids sidecar provides forward-index lookups.

Storage: one append-only log of zlib-compressed pickled rows + an
offsets array, plus ``npids.json`` for docno → ordinal lookup.
"""
from __future__ import annotations

import json
import os
import pickle
import zlib
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

from ..core.frame import ColFrame
from ..core.pipeline import Indexer
from .base import CacheTransformer

__all__ = ["IndexerCache"]


class IndexerCache(CacheTransformer, Indexer):
    """Sequence cache: write once via .index(), replay via iteration."""

    def __init__(self, path: Optional[str] = None, *,
                 fingerprint: Optional[str] = None,
                 on_stale: str = "error"):
        CacheTransformer.__init__(self, path, None, fingerprint=fingerprint,
                                  on_stale=on_stale)
        self._open_manifest(backend="log", key_columns=("docno",))
        self._log_path = os.path.join(self.path, "rows.log")
        self._off_path = os.path.join(self.path, "offsets.npy")
        self._npids_path = os.path.join(self.path, "npids.json")

    # -- writing ---------------------------------------------------------------
    def index(self, corpus_iter: Iterable[dict]) -> "IndexerCache":
        if self.readonly:
            raise RuntimeError(
                f"IndexerCache at {self.path!r} opened read-only "
                f"(stale provenance); refusing to overwrite the stream")
        offsets: List[int] = []
        docnos: List[str] = []
        with open(self._log_path, "wb") as log:
            pos = 0
            for row in corpus_iter:
                if not isinstance(row, dict):
                    row = dict(row)
                blob = zlib.compress(
                    pickle.dumps(row, protocol=pickle.HIGHEST_PROTOCOL), 1)
                log.write(len(blob).to_bytes(8, "little"))
                log.write(blob)
                offsets.append(pos)
                pos += 8 + len(blob)
                if "docno" in row:
                    docnos.append(str(row["docno"]))
                self.stats.add(inserts=1)
        np.save(self._off_path, np.asarray(offsets, dtype=np.int64))
        if docnos:
            with open(self._npids_path, "w") as f:
                json.dump(docnos, f)
        return self

    @property
    def built(self) -> bool:
        return os.path.exists(self._off_path)

    def __len__(self) -> int:
        if not self.built:
            return 0
        return int(np.load(self._off_path).shape[0])

    # -- replay ------------------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        if not self.built:
            return
        with open(self._log_path, "rb") as log:
            while True:
                head = log.read(8)
                if len(head) < 8:
                    return
                n = int.from_bytes(head, "little")
                yield pickle.loads(zlib.decompress(log.read(n)))

    def get_corpus_iter(self) -> Iterator[dict]:
        return iter(self)

    # -- forward-index lookups (docno → row) --------------------------------------
    def _docno_ordinals(self) -> Dict[str, int]:
        if not os.path.exists(self._npids_path):
            raise KeyError("IndexerCache has no docno column — forward "
                           "index unavailable")
        with open(self._npids_path) as f:
            return {d: i for i, d in enumerate(json.load(f))}

    def get(self, docno: str) -> dict:
        ords = self._docno_ordinals()
        i = ords[str(docno)]
        offsets = np.load(self._off_path)
        with open(self._log_path, "rb") as log:
            log.seek(int(offsets[i]))
            n = int.from_bytes(log.read(8), "little")
            row = pickle.loads(zlib.decompress(log.read(n)))
            self.stats.add(hits=1)
            return row

    # -- as a transformer: forward-index text lookup (D-side join) ----------------
    def transform(self, inp: ColFrame) -> ColFrame:
        rows = [self.get(d) for d in inp["docno"].tolist()]
        out = inp
        if rows:
            extra_cols = set().union(*[set(r) for r in rows]) - {"docno"}
            for c in sorted(extra_cols):
                col = np.empty(len(inp), dtype=object)
                col[:] = [r.get(c) for r in rows]
                out = out.assign(**{c: col})
        return out

    def signature(self):
        return ("IndexerCache", os.path.abspath(self.path), len(self))
