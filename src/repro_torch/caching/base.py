"""Shared machinery for explicit caches (paper §4).

Counterpart of ``repro.caching.base``, with its asynchronous data plane
(prefetch staging and write-behind puts, ``caching/dataplane.py``).

Common behaviours across all cache families:

* **temporary mode** — omit the path and a temp directory is created and
  deleted when the cache is closed / used as a context manager (§4.5);
* **no-transformer mode** — a cache constructed without a wrapped
  transformer raises ``CacheMissError`` on miss (§4.5);
* **Lazy transformers** — resolved only when first needed (§4.5);
* **determinism verification** — beyond-paper: ``verify_fraction>0``
  re-executes a sample of *hit* rows through the wrapped transformer and
  asserts the cached values match (the paper §6 notes determinism is
  assumed; it is checkable, so we check);
* **hit/miss accounting** — exposed as ``stats``.
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.pipeline import Transformer
from .economics import AccessStats, CacheBudget, evict_entries
from .provenance import CacheManifest, ManifestError, StaleCacheError

__all__ = ["CacheMissError", "CacheStats", "CacheTransformer",
           "n_frame_queries", "resolve_transformer", "pickle_key",
           "pickle_value", "unpickle_value"]

#: valid ``on_stale=`` policies (see CacheTransformer)
ON_STALE_POLICIES = ("error", "recompute", "readonly")


class CacheMissError(KeyError):
    """Raised on a miss when no wrapped transformer was provided."""


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    verified: int = 0
    #: how many of ``hits`` were served from the prefetch staging map
    #: rather than an inline backend read.  Counted *here*, by the node
    #: that consumed the entry — the I/O pool never touches stats — so
    #: hit rates stay honest under overlap: ``hits``/``misses`` are
    #: identical with prefetch on or off, and ``prefetched`` only says
    #: how many round trips left the critical path.
    prefetched: int = 0
    #: wall seconds spent inside the *wrapped transformer* on the miss
    #: path, and the input queries those computes covered.  This is the
    #: raw recompute cost — cache lookups/inserts excluded — which is
    #: what the planner's cost model (core/cost.py) needs: the wrapper
    #: call time a run records for a cached node is dominated by store
    #: round trips, so folding it would make every cached node look
    #: exactly as expensive as its cache and the cache-place pass could
    #: never learn that recompute is cheaper.
    compute_s: float = 0.0
    compute_queries: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, *, hits: int = 0, misses: int = 0, inserts: int = 0,
            verified: int = 0, prefetched: int = 0, compute_s: float = 0.0,
            compute_queries: int = 0) -> None:
        """Atomic increment — cache families are shared by the
        concurrent plan executor, so counter updates must not race."""
        with self._lock:
            self.hits += hits
            self.misses += misses
            self.inserts += inserts
            self.verified += verified
            self.prefetched += prefetched
            self.compute_s += compute_s
            self.compute_queries += compute_queries

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def __str__(self):
        return (f"hits={self.hits} misses={self.misses} "
                f"hit_rate={self.hit_rate:.3f}")


def n_frame_queries(frame: Any) -> int:
    """How many input *queries* a frame covers: unique qids when the
    column exists, else rows.  Per-query is the planner cost model's
    unit, so the families normalize ``CacheStats.compute_s`` by this."""
    try:
        if "qid" in frame:
            return len(set(frame["qid"].tolist()))
    except Exception:
        pass
    return len(frame)


def resolve_transformer(t: Any) -> Optional[Transformer]:
    """Resolve Lazy wrappers (the reference's ``caching/lazy.py``) to a
    concrete transformer."""
    if t is None:
        return None
    if hasattr(t, "_resolve_lazy"):
        return t._resolve_lazy()
    return t


def pickle_key(vals: Tuple) -> bytes:
    return pickle.dumps(vals, protocol=pickle.HIGHEST_PROTOCOL)


def pickle_value(vals: Tuple) -> bytes:
    return pickle.dumps(vals, protocol=pickle.HIGHEST_PROTOCOL)


def unpickle_value(b: bytes) -> Tuple:
    return pickle.loads(b)


class CacheTransformer(Transformer):
    """Base for cache components that wrap a transformer.

    Provenance (beyond-paper; see ``caching/provenance.py``): pass
    ``fingerprint=`` (usually ``transformer.fingerprint()`` or a
    planner node fingerprint) and the cache checks it against the
    directory's ``manifest.json`` on open.  On mismatch the
    ``on_stale`` policy applies:

    * ``"error"`` (default) — raise :class:`StaleCacheError`;
    * ``"recompute"`` — discard the stale entries (the directory is
      wiped) and recompute from the wrapped transformer;
    * ``"readonly"`` — serve the existing entries as-is but never
      write (misses are computed yet not inserted).

    Without a ``fingerprint`` the manifest is still written/maintained
    (family, backend, schema, timestamps, entry counts) so the
    directory stays inspectable (the reference's ``repro cache`` CLI
    reads it).
    """

    def __init__(self, path: Optional[str], transformer: Any = None,
                 *, verify_fraction: float = 0.0,
                 fingerprint: Optional[str] = None,
                 on_stale: str = "error",
                 budget: Any = None,
                 async_writes: Optional[bool] = None):
        if on_stale not in ON_STALE_POLICIES:
            raise ValueError(f"on_stale must be one of {ON_STALE_POLICIES}, "
                             f"got {on_stale!r}")
        self._transformer_raw = transformer
        # write-behind is *opt-in* (the plan compiler passes True for
        # planner-inserted caches): deferring puts keeps compute-once
        # exact within a process but relaxes it across processes
        # sharing a directory, and a bare family must preserve the
        # strict cross-process contract its docstring promises
        self._async_writes = bool(async_writes) if async_writes is not None \
            else False
        self._staging = None                  # StagingMap, see dataplane.py
        self._writer = None                   # WriteBehindWriter or None
        self.codec: Optional[str] = None      # negotiated via the manifest
        self._budget = CacheBudget.coerce(budget)
        #: in-memory {backend key: [last_used_ts, hits]} deltas, merged
        #: into the directory's access.json sidecar by _flush_access
        self._access_pending: Dict[bytes, List[float]] = {}
        self._access_lock = threading.Lock()
        self._temporary = path is None
        if path is None:
            path = tempfile.mkdtemp(prefix="repro-torch-cache-")
        self.path = path
        os.makedirs(self.path, exist_ok=True)
        self.stats = CacheStats()
        #: per-call hit/miss counts, thread-local (see call_with_counts)
        self._call_tls = threading.local()
        self.verify_fraction = float(verify_fraction)
        self.provenance_fingerprint = fingerprint
        self.on_stale = on_stale
        #: set by ``_open_manifest`` under the "readonly" stale policy
        self.readonly = False
        self._manifest: Optional[CacheManifest] = None
        self._closed = False

    # -- provenance ----------------------------------------------------------
    @property
    def manifest(self) -> Optional[CacheManifest]:
        return self._manifest

    def _open_manifest(self, *, backend: Optional[str],
                       key_columns: Sequence[str] = (),
                       value_columns: Sequence[str] = (),
                       codec: Optional[str] = None) -> None:
        """Validate (or create) this directory's manifest.

        Families call this *before* opening their store, so that the
        ``recompute`` policy can wipe a stale directory first.

        ``codec`` is the serialization scheme this family would use for
        a *fresh* directory (see ``caching/codecs.py``); an existing
        directory keeps whatever its manifest records — ``None`` means
        the legacy pickle scheme, so pre-codec dirs stay warm — and a
        manifest naming a codec this build does not know trips the
        normal staleness machinery (the entries are unreadable to us).
        """
        try:
            existing = CacheManifest.load(self.path)
        except ManifestError:
            if self.on_stale != "recompute":
                raise
            self._wipe_dir()
            existing = None
        if existing is not None:
            reasons = self._stale_reasons(existing, backend,
                                          key_columns, value_columns,
                                          codec)
            if reasons:
                if self.on_stale == "error":
                    raise StaleCacheError(
                        f"{type(self).__name__} at {self.path!r} is stale: "
                        f"{'; '.join(reasons)}.  Pass on_stale='recompute' "
                        f"to discard the cached entries, or "
                        f"on_stale='readonly' to use them anyway without "
                        f"writing")
                if self.on_stale == "recompute":
                    self._wipe_dir()
                    existing = None
                else:                              # readonly
                    self.readonly = True
        if existing is None:
            self._manifest = CacheManifest.new(
                family=type(self).__name__, backend=backend,
                fingerprint=self.provenance_fingerprint,
                transformer=self._transformer_label(),
                key_columns=list(key_columns),
                value_columns=list(value_columns),
                codec=codec)
            self._manifest.save(self.path)
        else:
            # adopt (incl. pre-provenance dirs); record our fingerprint
            # the first time one is known for this directory
            if existing.fingerprint is None \
                    and self.provenance_fingerprint is not None \
                    and not self.readonly:
                existing.fingerprint = self.provenance_fingerprint
                existing.save(self.path)
            self._manifest = existing
        # record a constructor-passed budget so offline enforcement
        # (``economics.enforce_dir``, close()) sees it without this process
        if not self._budget.empty() and not self.readonly:
            if self._budget.record_in(self._manifest) \
                    and not self._temporary:
                self._manifest.save(self.path)
        #: the scheme every subsequent read/write of this store uses
        self.codec = getattr(self._manifest, "codec", None)

    def _stale_reasons(self, m: CacheManifest, backend: Optional[str],
                       key_columns: Sequence[str],
                       value_columns: Sequence[str],
                       codec: Optional[str] = None) -> list:
        reasons = []
        ours = self.provenance_fingerprint
        if ours is not None and m.fingerprint is not None \
                and m.fingerprint != ours:
            reasons.append(f"recorded fingerprint {m.fingerprint} != "
                           f"expected {ours}")
        # combinator selectors (tiered:/mmap:) are pure accelerators
        # over the same store files, so compatibility is decided by the
        # *storage identity* — a dir warmed with "sqlite" opens warm
        # under "mmap:sqlite" (the fleet's read-mostly tier), while
        # "dbm" vs "sqlite" still trips staleness
        from .backends import storage_identity
        if backend is not None and m.backend is not None \
                and storage_identity(m.backend) != storage_identity(backend):
            reasons.append(f"recorded backend {m.backend!r} != "
                           f"requested {backend!r}")
        if key_columns and m.key_columns \
                and list(key_columns) != list(m.key_columns):
            reasons.append(f"recorded key columns {m.key_columns} != "
                           f"requested {list(key_columns)}")
        if value_columns and m.value_columns \
                and list(value_columns) != list(m.value_columns):
            reasons.append(f"recorded value columns {m.value_columns} != "
                           f"requested {list(value_columns)}")
        # a recorded codec we don't implement means the stored bytes are
        # unreadable to this build; a recorded codec of None is always
        # fine (the legacy pickle scheme every build speaks)
        recorded_codec = getattr(m, "codec", None)
        if recorded_codec is not None and recorded_codec != codec:
            reasons.append(f"recorded codec {recorded_codec!r} is not "
                           f"supported here (this build speaks "
                           f"{codec!r} and the legacy pickle scheme)")
        return reasons

    def _transformer_label(self) -> Optional[str]:
        t = self._transformer_raw
        if t is None:
            return None
        try:
            return repr(t)
        except Exception:
            return type(t).__name__

    def _wipe_dir(self) -> None:
        """Discard every entry (and the manifest) under ``self.path``."""
        for name in os.listdir(self.path):
            p = os.path.join(self.path, name)
            if os.path.isdir(p) and not os.path.islink(p):
                shutil.rmtree(p, ignore_errors=True)
            else:
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def _update_manifest(self) -> None:
        """Refresh last-use timestamp and entry count on disk.  A
        manifest refresh is a write-behind flush point: the recorded
        entry count must describe the *durable* store."""
        if self._manifest is None or self.readonly or self._temporary:
            return
        self._drain_writes()
        try:
            n = len(self)                    # families define __len__
        except Exception:
            n = self._manifest.entry_count
        self._manifest.entry_count = int(n)
        self._manifest.last_used_at = time.time()
        self._manifest.save(self.path)

    # -- cache economics: budgets, access stats, eviction --------------------
    @property
    def budget(self) -> CacheBudget:
        """Effective budget: the constructor's, else the manifest's."""
        if not self._budget.empty():
            return self._budget
        return CacheBudget.from_manifest(self._manifest)

    def _note_access(self, keys: Sequence[bytes]) -> None:
        """Record that ``keys`` were read/written now — feeds the LRU
        eviction pass via the access.json sidecar (flushed on close /
        evict, not per call)."""
        if self._temporary or not keys:
            return
        now = time.time()
        with self._access_lock:
            pend = self._access_pending
            for k in keys:
                cur = pend.get(k)
                if cur is None:
                    pend[k] = [now, 1]
                else:
                    cur[0] = now
                    cur[1] += 1

    def _flush_access(self) -> None:
        with self._access_lock:
            pending, self._access_pending = self._access_pending, {}
        if not pending or self._temporary or self.readonly:
            return
        stats = AccessStats.load(self.path)
        stats.merge_pending(pending)
        stats.save(self.path)

    def evict(self, budget: Any = None, *,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Bring the store within ``budget`` (default: the recorded /
        constructor budget): TTL-expired entries first, then LRU.
        Returns the eviction report (see ``economics.evict_entries``).

        The manifest's entry count is refreshed *immediately* — not
        only on ``close()`` — so a verifier reading the manifest stays
        truthful against a still-open backend."""
        eff = CacheBudget.coerce(budget)
        if eff.empty():
            eff = self.budget
        if eff.empty():
            return {"skipped": "no budget (none passed, none recorded)"}
        if self.readonly:
            return {"skipped": "readonly cache (stale-readonly policy)"}
        backend = getattr(self, "_backend", None)
        if backend is None:
            raise NotImplementedError(
                f"{type(self).__name__} does not support budget eviction")
        self._drain_writes()                 # evict over the durable store
        self._flush_access()
        created = self._manifest.created_at \
            if self._manifest is not None else 0.0
        report = evict_entries(backend, self.path, eff,
                               created_at=created, now=now)
        self._update_manifest()
        return report

    # -- per-call accounting -------------------------------------------------
    # ``stats`` is cumulative and shared: when several threads, shards
    # or services use one cache, deriving a caller's hits/misses from
    # counter *deltas* misattributes concurrent calls.  Families instead
    # note each call's own counts into thread-local storage; callers
    # that need per-call numbers (the serving layer, the streaming
    # executor) read them back with ``pop_call_counts`` /
    # ``call_with_counts`` — race-free because a transform call runs
    # wholly on the calling thread.

    def _note_call(self, hits: int, misses: int) -> None:
        prev = getattr(self._call_tls, "counts", (0, 0))
        self._call_tls.counts = (prev[0] + int(hits), prev[1] + int(misses))

    def pop_call_counts(self) -> Tuple[int, int]:
        """(hits, misses) accumulated by this thread's calls since the
        last pop; resets to (0, 0)."""
        counts = getattr(self._call_tls, "counts", (0, 0))
        self._call_tls.counts = (0, 0)
        return counts

    def call_with_counts(self, inp: Any) -> Tuple[Any, int, int]:
        """Run the cache and return ``(output, hits, misses)`` for THIS
        call only, regardless of concurrent users of the same cache."""
        self.pop_call_counts()
        out = self(inp)
        hits, misses = self.pop_call_counts()
        return out, hits, misses

    # -- asynchronous data plane (see caching/dataplane.py) ------------------
    # Families that own a backend call ``_init_dataplane()`` after
    # opening it; everything here degrades to the synchronous path when
    # they don't (``_staging``/``_writer`` stay None).

    def _init_dataplane(self) -> None:
        from .dataplane import StagingMap, WriteBehindWriter, \
            write_behind_default
        backend = getattr(self, "_backend", None)
        if backend is None:                   # pragma: no cover - guard
            return
        self._staging = StagingMap()
        if self._async_writes and write_behind_default() \
                and not self.readonly:
            # the writer drains under the backend's re-entrant lock
            # (taken before its own flush lock) so background drains,
            # lock-holding barriers and flush points order consistently
            self._writer = WriteBehindWriter(backend.put_many,
                                             lock=backend.lock)

    @property
    def prefetchable(self) -> bool:
        """Whether prefetching this cache's backend can pay: the
        backend must exist and not already be a memory-speed read path
        (backends declare via ``prefetchable``; the in-memory LRU and
        the mmap snapshot tier opt out — staging a dict/page-cache read
        only adds bookkeeping)."""
        backend = getattr(self, "_backend", None)
        return backend is not None and self._staging is not None \
            and bool(getattr(backend, "prefetchable", True))

    def prefetch_columns(self) -> Optional[Tuple[str, ...]]:
        """The input columns that fully determine this cache's keys, or
        ``None`` when the family does not support key prefetch.
        Executors use this to decide *when* a node's keys are known:
        at submit time if the source frame carries the columns, else
        the moment the upstream node completes."""
        return None

    def prefetch_keys(self, frame: Any) -> List[bytes]:
        """Backend keys for ``frame`` — overridden by families that
        support prefetch."""
        raise NotImplementedError

    def prefetch_async(self, frame: Any):
        """Issue ``get_many`` for ``frame``'s keys on the I/O pool;
        results land in the staging map for the next ``transform`` /
        ``serve_from_store`` over the same keys.  Returns the pool
        future (``None`` when there is nothing to fetch).  No stats,
        no access notes — accounting happens at consumption.
        """
        if not self.prefetchable or self._closed:
            return None
        try:
            keys = self.prefetch_keys(frame)
        except (NotImplementedError, KeyError):
            return None
        todo = self._staging.covered(keys)
        if not todo:
            return None
        backend = self._backend
        staging = self._staging
        writer = self._writer

        def fetch():
            want = todo
            if writer is not None:
                pending = writer.overlay_many(want)
                if pending:
                    staging.deposit(pending.items())
                    want = [k for k in want if k not in pending]
                    if not want:
                        return
            staging.deposit(zip(want, backend.get_many(want)))

        from .dataplane import io_pool
        fut = io_pool().submit(fetch)
        self._staging.track(fut, todo)
        return fut

    def discard_staging(self) -> None:
        """Drop unconsumed staged entries (run teardown)."""
        if self._staging is not None:
            self._staging.discard()

    def _lookup_many(self, keys: Sequence[bytes]
                     ) -> Tuple[List[Optional[bytes]], int]:
        """Read ``keys`` through the data plane: the write-behind
        overlay first (pending entries must be visible), then the
        staging map, then the backend for whatever remains.  Returns
        ``(blobs, n_prefetched)`` — the second number is how many
        non-None blobs came out of the staging map, for
        ``CacheStats.prefetched`` attribution by the caller."""
        n = len(keys)
        out: List[Optional[bytes]] = [None] * n
        remaining = list(range(n))
        if self._writer is not None:
            pending = self._writer.overlay_many(keys)
            if pending:
                remaining = []
                for i, k in enumerate(keys):
                    v = pending.get(k)
                    if v is not None:
                        out[i] = v
                    else:
                        remaining.append(i)
        prefetched = 0
        if remaining and self._staging is not None:
            # pop_many waits on any in-flight prefetch covering these
            # keys before looking — the consumer must not race past a
            # fetch that is about to land and hit the backend twice
            staged = self._staging.pop_many([keys[i] for i in remaining])
            if staged:
                left = []
                for i in remaining:
                    k = keys[i]
                    if k in staged:
                        out[i] = staged[k]   # may be a staged miss (None)
                        if staged[k] is not None:
                            prefetched += 1
                    else:
                        left.append(i)
                remaining = left
        if remaining:
            fetched = self._backend.get_many([keys[i] for i in remaining])
            for i, v in zip(remaining, fetched):
                out[i] = v
        return out, prefetched

    def _recheck_many(self, keys: Sequence[bytes]
                      ) -> List[Optional[bytes]]:
        """The locked miss-path recheck: the write-behind overlay (a
        racing thread's compute may still be pending) then the backend.
        The staging map is deliberately *not* consulted — its deposits
        predate the lock and were already offered to ``_lookup_many``."""
        if self._writer is None:
            return self._backend.get_many(keys)
        pending = self._writer.overlay_many(keys)
        out: List[Optional[bytes]] = [pending.get(k) for k in keys]
        remaining = [i for i, v in enumerate(out) if v is None]
        if remaining:
            fetched = self._backend.get_many([keys[i] for i in remaining])
            for i, v in zip(remaining, fetched):
                out[i] = v
        return out

    def _store_many(self, items: Sequence[Tuple[bytes, bytes]]) -> None:
        """Miss-path put: enqueue on the write-behind writer when one
        is live, else write through synchronously.  Called inside the
        compute-once critical section either way — the *enqueue* under
        the lock is the sentinel that keeps in-process compute-once
        exact (the recheck sees the overlay), while durability is
        deferred to :meth:`_write_barrier` / the flush points."""
        if self._writer is not None:
            self._writer.put(list(items))
        else:
            self._backend.put_many(items)

    def _write_barrier(self) -> None:
        """Durability barrier before the backend's cross-process lock is
        released (see ``WriteBehindWriter.barrier``): other processes'
        locked rechecks cannot see the in-memory overlay, so the puts
        must be on disk by the time they can acquire the lock — this is
        what keeps compute-exactly-once exact across processes under
        write-behind."""
        if self._writer is not None:
            self._writer.barrier()

    def _drain_writes(self) -> None:
        """Synchronously flush pending write-behind state (flush points:
        ``close()``, ``drain()``, manifest refresh, eviction, store
        enumeration)."""
        if self._writer is not None:
            self._writer.flush()

    def drain(self) -> None:
        """Make every accepted write durable and the sidecars current —
        the executor/service quiescence hook (graceful fleet drain)."""
        self._drain_writes()
        self._flush_access()

    # -- wrapped transformer -------------------------------------------------
    @property
    def transformer(self) -> Optional[Transformer]:
        t = resolve_transformer(self._transformer_raw)
        return t

    def _require_transformer(self, n_misses: int) -> Transformer:
        t = self.transformer
        if t is None:
            raise CacheMissError(
                f"{type(self).__name__} at {self.path!r}: {n_misses} cache "
                f"misses but no transformer was provided")
        return t

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        if self._writer is not None:
            try:
                self._writer.close()     # final write-behind flush
            except Exception:
                pass                     # entries recompute; never corrupt
        if not self.budget.empty() and not self.readonly:
            try:
                self.evict()             # automatic budget enforcement
            except Exception:
                pass
        try:
            self._flush_access()
            self._update_manifest()
        except Exception:
            pass                         # manifest refresh is best-effort
        self.discard_staging()
        self._close_backend()
        if self._temporary:
            shutil.rmtree(self.path, ignore_errors=True)
        self._closed = True

    def _close_backend(self) -> None:  # pragma: no cover - overridden
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        # Best-effort temp cleanup.  During interpreter shutdown module
        # globals (os/shutil/tempfile) may already be torn down, in which
        # case close() can raise things `except Exception` does not stop
        # (the attribute machinery itself may be gone) — so bail out
        # early when finalizing, and never propagate from a finalizer.
        try:
            if getattr(self, "_closed", True):
                return
            if sys is None or sys.is_finalizing() or shutil is None:
                return
            self.close()
        except BaseException:
            pass

    # -- transparency: caches delegate the wrapped transformer's
    #    scheduling metadata — a hand-wrapped cache must not launder a
    #    shardable=False declaration into the class default.
    @property
    def shardable(self) -> bool:
        t = self._transformer_raw
        if t is not None and hasattr(t, "_resolve_lazy") \
                and not getattr(t, "constructed", True):
            # don't force a Lazy to construct just to read metadata;
            # an unconstructed Lazy reports its own declaration
            return bool(getattr(t, "shardable", True))
        return bool(getattr(self.transformer, "shardable", True))

    # -- equality: caches are transparent, so they inherit the wrapped
    #    transformer's signature for LCP purposes *plus* a cache marker.
    def signature(self):
        inner = self.transformer
        return (type(self).__name__,
                inner.signature() if inner is not None else None,
                os.path.abspath(self.path))
