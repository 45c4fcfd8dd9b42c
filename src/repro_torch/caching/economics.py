"""Cache economics: budgets, per-entry access stats, LRU/TTL eviction.

Counterpart of ``repro.caching.economics``, with the same sidecar and
manifest formats.  The cache families make caches correct, shareable
and self-describing; this module makes them *bounded*.  Three pieces:

* :class:`CacheBudget` — a per-family resource envelope (entry count,
  store bytes, entry TTL).  Budgets are recorded in the directory's v2
  ``manifest.json`` (``caching/provenance.py``), so every tool that can
  see the directory knows its limits — enforcement does not depend on
  the process that configured the budget still being around.

* :class:`AccessStats` — a per-directory ``access.json`` sidecar
  mapping entry keys to ``[last_used_ts, hit_count]``.  Cache families
  note accesses in memory (``CacheTransformer._note_access``) and merge
  them into the sidecar on close / eviction; the eviction pass ranks
  entries least-recently-used first from it.  The sidecar is advisory:
  entries it does not know about are assumed as old as the directory.

* :func:`evict_entries` / :func:`enforce_dir` — the eviction pass:
  TTL-expired entries go first, then LRU entries until the store is
  within its entry/byte budget, deleted through the backend's
  ``delete_many``.  Crucially the manifest's ``entry_count`` is
  refreshed *immediately* after any destructive operation (not only on
  ``close()``), so a verifier reading the manifest stays truthful
  against a still-open backend.

``enforce_dir`` is the offline entry point: it
re-opens the directory's family from its manifest alone (no transformer
needed — eviction never computes) and runs the family's ``evict()``.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .backends import CacheBackend, atomic_write_bytes
from .provenance import CacheManifest, ManifestError

__all__ = ["CacheBudget", "AccessStats", "ACCESS_STATS_NAME",
           "evict_entries", "enforce_dir", "open_family_for_dir"]

ACCESS_STATS_NAME = "access.json"

BudgetLike = Union["CacheBudget", Dict[str, Any], int, None]


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheBudget:
    """A cache family's resource envelope; ``None`` fields are
    unbounded.  An all-``None`` budget is "no budget" (``empty()``)."""

    max_entries: Optional[int] = None
    max_bytes: Optional[int] = None
    ttl_seconds: Optional[float] = None

    def empty(self) -> bool:
        return (self.max_entries is None and self.max_bytes is None
                and self.ttl_seconds is None)

    @classmethod
    def coerce(cls, value: BudgetLike) -> "CacheBudget":
        """Accept a ``CacheBudget``, a ``{"max_entries": ...}`` dict, a
        bare int (entry budget — the common CLI shorthand) or ``None``
        (empty budget)."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, bool):
            raise TypeError(f"cache budget cannot be a bool: {value!r}")
        if isinstance(value, int):
            return cls(max_entries=value)
        if isinstance(value, dict):
            unknown = set(value) - {"max_entries", "max_bytes",
                                    "ttl_seconds"}
            if unknown:
                raise ValueError(
                    f"unknown cache budget field(s) {sorted(unknown)}; "
                    f"valid: max_entries, max_bytes, ttl_seconds")
            return cls(**value)
        raise TypeError(
            f"cache budget must be a CacheBudget, dict, int or None — "
            f"got {type(value).__name__}: {value!r}")

    @classmethod
    def from_manifest(cls, m: Optional[CacheManifest]) -> "CacheBudget":
        if m is None:
            return cls()
        return cls(max_entries=m.max_entries, max_bytes=m.max_bytes,
                   ttl_seconds=m.ttl_seconds)

    def record_in(self, m: CacheManifest) -> bool:
        """Write this budget into a manifest; True when it changed."""
        changed = (m.max_entries, m.max_bytes, m.ttl_seconds) != \
            (self.max_entries, self.max_bytes, self.ttl_seconds)
        m.max_entries = self.max_entries
        m.max_bytes = self.max_bytes
        m.ttl_seconds = self.ttl_seconds
        return changed


# ---------------------------------------------------------------------------
# per-entry access stats (the eviction pass's recency signal)
# ---------------------------------------------------------------------------

class AccessStats:
    """``access.json``: hex-encoded entry key → [last_used_ts, hits].

    Keys are the *backend-level* keys (pickled tuples for KeyValueCache,
    sha256 digests for RetrieverCache, utf-8 query strings for
    DenseScorerCache) so the eviction pass can hand them straight to
    ``delete_many``.  Writes are atomic and merge-on-save, so two
    closers of one directory lose at most recency precision, never the
    file."""

    def __init__(self, data: Optional[Dict[str, List[float]]] = None):
        self._data: Dict[str, List[float]] = dict(data or {})

    # -- io ------------------------------------------------------------------
    @staticmethod
    def path_of(dirpath: str) -> str:
        return os.path.join(dirpath, ACCESS_STATS_NAME)

    @classmethod
    def load(cls, dirpath: str) -> "AccessStats":
        path = cls.path_of(dirpath)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError("not an object")
            data = {str(k): [float(v[0]), int(v[1])]
                    for k, v in doc.items()}
        except (OSError, ValueError, TypeError, IndexError):
            data = {}
        return cls(data)

    def save(self, dirpath: str) -> None:
        atomic_write_bytes(
            self.path_of(dirpath),
            json.dumps(self._data, sort_keys=True).encode("utf-8"))

    # -- updates -------------------------------------------------------------
    def merge_pending(self, pending: Dict[bytes, List[float]]) -> None:
        """Fold a family's in-memory ``{key: [last_ts, hits]}`` deltas
        in (later timestamps win; hit counts add)."""
        for k, (ts, hits) in pending.items():
            hk = k.hex()
            cur = self._data.get(hk)
            if cur is None:
                self._data[hk] = [float(ts), int(hits)]
            else:
                cur[0] = max(cur[0], float(ts))
                cur[1] += int(hits)

    def forget(self, keys: Sequence[bytes]) -> None:
        for k in keys:
            self._data.pop(k.hex(), None)

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._data)

    def keys_bytes(self) -> List[bytes]:
        return [bytes.fromhex(k) for k in self._data]

    def last_used(self, key: bytes, default: float = 0.0) -> float:
        e = self._data.get(key.hex())
        return e[0] if e is not None else default

    def hits(self, key: bytes) -> int:
        e = self._data.get(key.hex())
        return int(e[1]) if e is not None else 0

    def total_hits(self) -> int:
        return int(sum(e[1] for e in self._data.values()))


# ---------------------------------------------------------------------------
# the eviction pass
# ---------------------------------------------------------------------------

def evict_entries(backend: CacheBackend, dirpath: str,
                  budget: CacheBudget, *,
                  access: Optional[AccessStats] = None,
                  created_at: float = 0.0,
                  now: Optional[float] = None) -> Dict[str, Any]:
    """Bring ``backend`` within ``budget``: TTL-expired entries first,
    then least-recently-used until both the entry and byte budgets
    hold.  Returns an accounting report; the caller refreshes the
    manifest (families do this via ``CacheTransformer.evict``).

    Entries the access sidecar has never seen are treated as old as the
    directory (``created_at``), so pre-economics stores evict oldest-
    unknown first rather than surviving TTLs forever.  Backends that
    cannot enumerate entries (``pickle``) fall back to the sidecar's
    key set as the candidate pool — entries written before access
    tracking are then unevictable and reported as such.
    """
    now = time.time() if now is None else float(now)
    access = access if access is not None else AccessStats.load(dirpath)
    approx_bytes = False
    try:
        stats = backend.entry_stats()
        total_bytes = sum(s for _, s in stats)
    except NotImplementedError:
        keys = access.keys_bytes()
        sizes = backend.stat_entries(keys)
        stats = [(k, s) for k, s in zip(keys, sizes) if s is not None]
        total_bytes = sum(s for _, s in stats)
        approx_bytes = True
    n_total = len(backend)

    entries = sorted(
        ((access.last_used(k, created_at), k, s) for k, s in stats),
        key=lambda t: (t[0], t[1]))

    evict: List[Tuple[float, bytes, int]] = []
    survivors = entries
    if budget.ttl_seconds is not None:
        cutoff = now - float(budget.ttl_seconds)
        expired = [e for e in entries if e[0] <= cutoff]
        survivors = entries[len(expired):]
        evict.extend(expired)
    n_expired = len(evict)

    n_left = n_total - len(evict)
    bytes_left = total_bytes - sum(s for _, _, s in evict)
    i = 0
    while i < len(survivors) and (
            (budget.max_entries is not None
             and n_left > budget.max_entries)
            or (budget.max_bytes is not None
                and bytes_left > budget.max_bytes)):
        e = survivors[i]
        evict.append(e)
        n_left -= 1
        bytes_left -= e[2]
        i += 1

    deleted = 0
    if evict:
        victim_keys = [k for _, k, _ in evict]
        deleted = backend.delete_many(victim_keys)
        access.forget(victim_keys)
        access.save(dirpath)

    entries_after = len(backend)
    unevictable = 0
    if budget.max_entries is not None \
            and entries_after > budget.max_entries:
        unevictable = entries_after - budget.max_entries
    return {"examined": len(stats), "expired": n_expired,
            "evicted": deleted,
            "evicted_bytes": int(sum(s for _, _, s in evict)),
            "entries_before": int(n_total),
            "entries_after": int(entries_after),
            "bytes_after": int(bytes_left),
            "bytes_approximate": approx_bytes,
            "unevictable": int(unevictable)}


# ---------------------------------------------------------------------------
# offline enforcement
# ---------------------------------------------------------------------------

def open_family_for_dir(dirpath: str, manifest: CacheManifest):
    """Re-open a cache directory's family from its manifest alone (no
    transformer — eviction never computes).  ``None`` for families that
    do not support budget enforcement (IndexerCache's append-only log)
    or stores with nothing on disk (``memory``)."""
    backend = manifest.backend
    if backend is None or backend == "memory" or backend == "log":
        return None
    family = manifest.family
    common = dict(fingerprint=None, on_stale="error")
    if family in ("KeyValueCache", "ScorerCache"):
        from .kv import KeyValueCache
        return KeyValueCache(
            dirpath, None, key=tuple(manifest.key_columns) or "text",
            value=tuple(manifest.value_columns) or "text",
            backend=backend, **common)
    if family == "RetrieverCache":
        from .retriever import RetrieverCache
        return RetrieverCache(
            dirpath, None,
            key=tuple(manifest.key_columns) or ("qid", "query"),
            backend=backend, **common)
    if family == "DenseScorerCache" or backend == "dense":
        from .dense import DenseScorerCache
        return DenseScorerCache(dirpath, None, **common)
    return None


def enforce_dir(dirpath: str, budget: BudgetLike = None, *,
                now: Optional[float] = None) -> Dict[str, Any]:
    """Enforce a budget on one cache directory, offline.

    ``budget=None`` uses the budget recorded in the directory's
    manifest.  Returns the eviction report, or ``{"skipped": reason}``
    when there is nothing to do / the family cannot be enforced."""
    try:
        manifest = CacheManifest.load(dirpath)
    except ManifestError as e:
        return {"skipped": f"unreadable manifest: {e}"}
    if manifest is None:
        return {"skipped": "no manifest"}
    eff = CacheBudget.coerce(budget)
    if eff.empty():
        eff = CacheBudget.from_manifest(manifest)
    if eff.empty():
        return {"skipped": "no budget (none passed, none recorded)"}
    family = open_family_for_dir(dirpath, manifest)
    if family is None:
        return {"skipped": f"family {manifest.family!r} (backend "
                           f"{manifest.backend!r}) does not support "
                           f"eviction"}
    try:
        return family.evict(eff, now=now)
    finally:
        family.close()
