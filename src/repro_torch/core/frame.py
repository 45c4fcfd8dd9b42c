"""Column-oriented relation store (the Q/D/R/RA data model).

Counterpart of ``repro.core.frame``, copied: it is numpy only.

The paper's platform instantiates relations as pandas DataFrames or lists
of dictionaries.  pandas is not available in this environment, so we
provide ``ColFrame`` — a small, fast, numpy-backed column store with the
relational operations the pipeline algebra needs (select, concat, sort,
group-by, hash join, key-based dedup).  Transformers accept and return
``ColFrame`` (and, like the paper's platform, lists of dicts are mapped
in/out transparently).

Relation types (extensible — extra columns always allowed):
  Q  (qid, query)
  D  (docno, text, ...)
  R  (qid, docno, score, rank, ...)
  RA (qid, docno, label)
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ColFrame", "Q", "D", "R", "RA", "relation_of"]

# Canonical relation signatures (required columns).
Q = frozenset({"qid", "query"})
D = frozenset({"docno", "text"})
R = frozenset({"qid", "docno", "score", "rank"})
RA = frozenset({"qid", "docno", "label"})

_RELATION_NAMES = [("R", R), ("RA", RA), ("Q", Q), ("D", D)]


def relation_of(frame: "ColFrame") -> Optional[str]:
    """Best-effort classification of a frame into Q/D/R/RA."""
    cols = set(frame.columns)
    for name, req in _RELATION_NAMES:
        if req <= cols:
            return name
    return None


def _as_column(values: Any, length: Optional[int] = None) -> np.ndarray:
    if isinstance(values, np.ndarray):
        arr = values
    elif np.isscalar(values) or isinstance(values, str):
        if length is None:
            raise ValueError("scalar column requires a known frame length")
        if isinstance(values, str):
            arr = np.empty(length, dtype=object)
            arr[:] = values
        else:
            arr = np.full(length, values)
        return arr
    else:
        values = list(values)
        if values and isinstance(values[0], str):
            arr = np.empty(len(values), dtype=object)
            arr[:] = values
        else:
            arr = np.asarray(values)
    if arr.dtype.kind in ("U", "S"):
        obj = np.empty(arr.shape[0], dtype=object)
        obj[:] = arr.tolist()
        arr = obj
    return arr


class ColFrame:
    """An ordered, column-oriented relation."""

    __slots__ = ("_cols", "_len")

    def __init__(self, data: Optional[Mapping[str, Any]] = None, *, _unsafe=None):
        if _unsafe is not None:
            self._cols = _unsafe
            self._len = len(next(iter(_unsafe.values()))) if _unsafe else 0
            return
        self._cols: Dict[str, np.ndarray] = {}
        self._len = 0
        if data:
            lengths = [len(v) for v in data.values()
                       if isinstance(v, (np.ndarray, list, tuple))]
            n = lengths[0] if lengths else 0
            for name, values in data.items():
                col = _as_column(values, length=n)
                if self._cols and len(col) != self._len:
                    raise ValueError(
                        f"column {name!r} has length {len(col)}, expected {self._len}")
                self._cols[name] = col
                self._len = len(col)

    # -- construction -------------------------------------------------
    @classmethod
    def from_dicts(cls, rows: Iterable[Mapping[str, Any]]) -> "ColFrame":
        rows = list(rows)
        if not rows:
            return cls()
        cols: Dict[str, list] = {k: [] for k in rows[0].keys()}
        for r in rows:
            for k in cols:
                cols[k].append(r.get(k))
        return cls({k: v for k, v in cols.items()})

    @classmethod
    def coerce(cls, obj: Any) -> "ColFrame":
        if isinstance(obj, ColFrame):
            return obj
        if isinstance(obj, Mapping):
            return cls(obj)
        if isinstance(obj, (list, tuple)):
            return cls.from_dicts(obj)
        raise TypeError(f"cannot coerce {type(obj).__name__} to ColFrame")

    @classmethod
    def empty(cls, columns: Sequence[str]) -> "ColFrame":
        return cls({c: np.empty(0, dtype=object) for c in columns})

    # -- basics --------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    @property
    def columns(self) -> Tuple[str, ...]:
        return tuple(self._cols.keys())

    def __contains__(self, col: str) -> bool:
        return col in self._cols

    def __getitem__(self, col: str) -> np.ndarray:
        return self._cols[col]

    def get(self, col: str, default=None):
        return self._cols.get(col, default)

    def to_dicts(self) -> List[Dict[str, Any]]:
        names = self.columns
        cols = [self._cols[n] for n in names]
        return [dict(zip(names, vals)) for vals in zip(*[c.tolist() for c in cols])] \
            if self._len else []

    def copy(self) -> "ColFrame":
        return ColFrame(_unsafe={k: v.copy() for k, v in self._cols.items()})

    def __repr__(self) -> str:
        return f"ColFrame({self._len} rows × {list(self.columns)})"

    # -- row/column algebra ---------------------------------------------
    def take(self, idx: np.ndarray) -> "ColFrame":
        idx = np.asarray(idx)
        return ColFrame(_unsafe={k: v[idx] for k, v in self._cols.items()})

    def head(self, n: int) -> "ColFrame":
        return self.take(np.arange(min(n, self._len)))

    def mask(self, m: np.ndarray) -> "ColFrame":
        return self.take(np.nonzero(np.asarray(m))[0])

    def select(self, cols: Sequence[str]) -> "ColFrame":
        return ColFrame(_unsafe={c: self._cols[c] for c in cols})

    def drop(self, cols: Sequence[str]) -> "ColFrame":
        cols = set(cols)
        return ColFrame(_unsafe={k: v for k, v in self._cols.items()
                                 if k not in cols})

    def assign(self, **newcols: Any) -> "ColFrame":
        out = dict(self._cols)
        for name, values in newcols.items():
            out[name] = _as_column(values, length=self._len)
            if len(out[name]) != self._len and self._cols:
                raise ValueError(f"assign({name}): bad length")
        return ColFrame(_unsafe=out)

    def rename(self, mapping: Mapping[str, str]) -> "ColFrame":
        return ColFrame(_unsafe={mapping.get(k, k): v
                                 for k, v in self._cols.items()})

    # -- ordering -------------------------------------------------------
    def sort_values(self, by: Sequence[str], ascending=True) -> "ColFrame":
        if isinstance(by, str):
            by = [by]
        if isinstance(ascending, bool):
            ascending = [ascending] * len(by)
        keys = []
        # np.lexsort sorts by the LAST key first.
        for col, asc in zip(reversed(by), reversed(list(ascending))):
            arr = self._cols[col]
            if arr.dtype == object:
                # factorize strings for lexsort
                uniq, inv = np.unique(arr.astype(str), return_inverse=True)
                arr = inv
            keys.append(arr if asc else -arr)
        order = np.lexsort(keys) if keys else np.arange(self._len)
        return self.take(order)

    # -- grouping -------------------------------------------------------
    def group_indices(self, by: Sequence[str]) -> Dict[Tuple, np.ndarray]:
        """Stable mapping group-key-tuple -> row indices."""
        if isinstance(by, str):
            by = [by]
        if self._len == 0:
            return {}
        key_cols = [self._cols[c] for c in by]
        codes = _row_codes(key_cols)
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        boundaries = np.nonzero(np.diff(sorted_codes))[0] + 1
        splits = np.split(order, boundaries)
        out: Dict[Tuple, np.ndarray] = {}
        for idxs in splits:
            i0 = idxs[0]
            key = tuple(c[i0] for c in key_cols)
            out[key] = idxs
        return out

    # -- key utilities ----------------------------------------------------
    def key_tuples(self, by: Sequence[str]) -> List[Tuple]:
        if isinstance(by, str):
            by = [by]
        cols = [self._cols[c].tolist() for c in by]
        return list(zip(*cols)) if self._len else []

    def dedup(self, by: Sequence[str], keep: str = "first") -> "ColFrame":
        keys = self.key_tuples(by)
        seen: Dict[Tuple, int] = {}
        for i, k in enumerate(keys):
            if keep == "first":
                seen.setdefault(k, i)
            else:
                seen[k] = i
        idx = np.array(sorted(seen.values()), dtype=np.int64)
        return self.take(idx)

    # -- concat / join -----------------------------------------------------
    @staticmethod
    def concat(frames: Sequence["ColFrame"]) -> "ColFrame":
        frames = [f for f in frames if len(f)]
        if not frames:
            return ColFrame()
        cols = list(frames[0].columns)
        common = [c for c in cols if all(c in f for f in frames)]
        out = {}
        for c in common:
            parts = [f[c] for f in frames]
            if any(p.dtype == object for p in parts):
                merged = np.empty(sum(len(p) for p in parts), dtype=object)
                ofs = 0
                for p in parts:
                    merged[ofs:ofs + len(p)] = p
                    ofs += len(p)
                out[c] = merged
            else:
                out[c] = np.concatenate(parts)
        return ColFrame(_unsafe=out)

    def merge(self, other: "ColFrame", on: Sequence[str],
              how: str = "inner", suffix: str = "_r") -> "ColFrame":
        """Hash join (left keys -> first matching right row)."""
        if isinstance(on, str):
            on = [on]
        rkeys = {}
        for j, k in enumerate(other.key_tuples(on)):
            rkeys.setdefault(k, j)
        lidx, ridx, matched = [], [], []
        for i, k in enumerate(self.key_tuples(on)):
            j = rkeys.get(k)
            if j is not None:
                lidx.append(i)
                ridx.append(j)
                matched.append(True)
            elif how == "left":
                lidx.append(i)
                ridx.append(-1)
                matched.append(False)
        lidx = np.asarray(lidx, dtype=np.int64)
        ridx = np.asarray(ridx, dtype=np.int64)
        matched = np.asarray(matched, dtype=bool)
        out = {k: v[lidx] if len(lidx) else np.empty(0, dtype=v.dtype)
               for k, v in self._cols.items()}
        for k, v in other._cols.items():
            if k in on:
                continue
            name = k if k not in out else k + suffix
            if len(ridx):
                col = v[np.where(ridx >= 0, ridx, 0)]
                if how == "left" and not matched.all():
                    col = col.astype(object)
                    col[~matched] = None
            else:
                col = np.empty(0, dtype=v.dtype)
            out[name] = col
        return ColFrame(_unsafe=out)

    # -- equality (used in tests: cache transparency invariant) -----------
    def equals(self, other: "ColFrame", cols: Optional[Sequence[str]] = None,
               rtol: float = 1e-6, atol: float = 1e-6) -> bool:
        cols = list(cols or self.columns)
        if any(c not in other for c in cols) or len(self) != len(other):
            return False
        for c in cols:
            a, b = self._cols[c], other[c]
            if a.dtype == object or b.dtype == object:
                if not all(x == y for x, y in zip(a.tolist(), b.tolist())):
                    return False
            elif np.issubdtype(a.dtype, np.floating):
                if not np.allclose(a, b.astype(a.dtype), rtol=rtol, atol=atol):
                    return False
            else:
                if not np.array_equal(a, b):
                    return False
        return True


def _row_codes(key_cols: List[np.ndarray]) -> np.ndarray:
    """Integer codes identifying distinct key tuples."""
    code = np.zeros(len(key_cols[0]), dtype=np.int64)
    mult = 1
    for col in reversed(key_cols):
        if col.dtype == object:
            _, inv = np.unique(col.astype(str), return_inverse=True)
        else:
            _, inv = np.unique(col, return_inverse=True)
        code = code + inv.astype(np.int64) * mult
        mult *= int(inv.max(initial=0)) + 1
    return code
