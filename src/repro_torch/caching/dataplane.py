"""Asynchronous cache data plane: the I/O pool, staging maps and
write-behind stores that take cache round trips off the executor's
critical path.

Counterpart of ``repro.caching.dataplane``, copied: it is plain Python.
The pool only moves bytes between a backend and the caches' overlays;
it never runs transformer code, so it never touches CUDA.

The paper's premise is that caching must never change *what* a pipeline
computes — only when the bytes move.  Everything here preserves that
contract by construction:

* **I/O pool** — one small, per-process thread pool shared by every
  cache family.  Prefetches and write-behind flushes run here; the
  pool never executes transformer code, so compute stays on the
  executor's own threads and a pool stall can only delay I/O, never
  results.

* **``StagingMap``** — a per-cache overlay where prefetched
  ``get_many`` results land before the owning node consumes them.
  The contract: entries are *only* deposited by prefetch tasks, are
  popped (consumed at most once) by the first ``transform`` /
  ``serve_from_store`` that asks for the key, and anything left over
  is discarded when the run ends.  Because deposits come straight from
  the backend and backend entries are immutable (deterministic
  transformers never rewrite a key with a different value), serving
  from the staging map is observationally identical to reading the
  backend — hit/miss accounting happens at the consuming node, never
  at the pool.

* **``WriteBehindWriter``** — a bounded background writer per cache
  store.  Miss-path puts land in an in-memory pending overlay that
  every read consults, and a pool task drains the overlay to the
  backend in batches; ``flush()`` drains synchronously and is called
  from ``close()``/``drain()``/manifest refresh/store enumeration, so
  every durable observation of the store sees the writes.  A crash
  before flush loses only pending entries — the store itself is never
  half-written (each backend's ``put_many`` is atomic at entry
  granularity) — so recovery is recompute, never corruption.

Compute-once note: within a process the locked recheck consults the
overlay, and *across* processes the families call :meth:`barrier`
before releasing the backend's cross-process lock — the overlay is
invisible to other processes, so the barrier is what keeps the
exactly-once guarantee intact under write-behind.  Bare cache families
still leave write-behind off by default; the plan compiler (whose
executors own the run lifecycle and drain on close) switches it on for
planner-inserted caches.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "io_pool", "prefetch_default", "write_behind_default",
    "StagingMap", "WriteBehindWriter",
]

# -- the shared per-process I/O pool -----------------------------------------

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_PID: Optional[int] = None
_POOL_LOCK = threading.Lock()

#: default I/O pool width; cache round trips are I/O bound (file reads,
#: sqlite calls, zlib — all release the GIL) so a handful of threads
#: covers many concurrent branch prefetches
DEFAULT_IO_THREADS = 4


def io_pool() -> ThreadPoolExecutor:
    """The process-wide cache I/O pool, created lazily and re-created
    after a ``fork`` (a forked child must not share the parent's worker
    threads — they do not survive the fork)."""
    global _POOL, _POOL_PID
    pid = os.getpid()
    if _POOL is None or _POOL_PID != pid:
        with _POOL_LOCK:
            if _POOL is None or _POOL_PID != pid:
                width = int(os.environ.get(
                    "REPRO_IO_THREADS", DEFAULT_IO_THREADS))
                _POOL = ThreadPoolExecutor(
                    max_workers=max(1, width),
                    thread_name_prefix="repro-torch-cache-io")
                _POOL_PID = pid
    return _POOL


def prefetch_default() -> bool:
    """Process-wide prefetch kill switch (``REPRO_PREFETCH=0``)."""
    return os.environ.get("REPRO_PREFETCH", "1") != "0"


def write_behind_default() -> bool:
    """Process-wide write-behind kill switch (``REPRO_WRITE_BEHIND=0``)."""
    return os.environ.get("REPRO_WRITE_BEHIND", "1") != "0"


# -- staging map -------------------------------------------------------------

class StagingMap:
    """Overlay where prefetched backend reads land until consumed.

    Thread-safe; shared by every concurrent batch flowing through one
    cache instance (the streaming executor interleaves batches), which
    is safe precisely because deposits are immutable backend blobs —
    two batches racing on one qid pop the same bytes either would have
    read inline.

    ``pop`` semantics: a consumer takes staged entries out of the map
    (they are owned by exactly one lookup), and ``pop_many`` first
    waits for any in-flight prefetch whose key set intersects the
    request — the consumer would otherwise race past a fetch that is
    about to land and read the backend twice for nothing.
    """

    #: safety valve — beyond this many staged blobs new deposits are
    #: dropped (the consumer falls through to the backend, correctness
    #: unaffected); generous enough that only a runaway prefetcher hits it
    MAX_STAGED = 262_144

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._staged: Dict[bytes, Optional[bytes]] = {}
        #: in-flight prefetch futures and the key set each will deposit
        self._inflight: Dict[Future, frozenset] = {}

    # -- producer side (I/O pool) -------------------------------------------
    def covered(self, keys: Sequence[bytes]) -> List[bytes]:
        """The subset of ``keys`` neither staged nor in flight — what a
        new prefetch should actually fetch (dedup against ourselves)."""
        with self._lock:
            inflight = set()
            for ks in self._inflight.values():
                inflight |= ks
            return [k for k in keys
                    if k not in self._staged and k not in inflight]

    def track(self, fut: Future, keys: Sequence[bytes]) -> None:
        """Register an in-flight fetch; the future must eventually call
        :meth:`deposit` (or fail) for these keys."""
        with self._lock:
            self._inflight[fut] = frozenset(keys)
        fut.add_done_callback(self._untrack)

    def _untrack(self, fut: Future) -> None:
        with self._lock:
            self._inflight.pop(fut, None)

    def deposit(self, pairs: Iterable[Tuple[bytes, Optional[bytes]]]) -> None:
        """Stage fetched blobs.  ``None`` results (backend misses) are
        staged too — they tell the consumer "the backend was asked and
        had nothing", saving the inline re-read on the miss path."""
        with self._lock:
            for k, v in pairs:
                if len(self._staged) >= self.MAX_STAGED:
                    break
                self._staged.setdefault(k, v)

    # -- consumer side (executor threads) -----------------------------------
    def pop_many(self, keys: Sequence[bytes]
                 ) -> Dict[bytes, Optional[bytes]]:
        """Blobs staged for ``keys``, removed from the map.  Waits for
        intersecting in-flight fetches first.  Keys absent from the
        result were never prefetched — read them from the backend."""
        with self._lock:
            waits = [f for f, ks in self._inflight.items()
                     if not ks.isdisjoint(keys)]
        for f in waits:
            try:
                f.result()
            except Exception:       # a failed prefetch is just a non-fetch
                pass
        out: Dict[bytes, Optional[bytes]] = {}
        with self._lock:
            for k in keys:
                if k in self._staged:
                    out[k] = self._staged.pop(k)
        return out

    def discard(self) -> None:
        """Drop everything staged (run teardown — leftovers are entries
        the run prefetched but never consumed)."""
        with self._lock:
            self._staged.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._staged)


# -- write-behind ------------------------------------------------------------

class WriteBehindWriter:
    """Bounded background writer over one backend's ``put_many``.

    Pending entries stay readable through :meth:`overlay_many` until a
    drain has made them durable — the overlay entry is removed only
    *after* ``put_many`` returns, so a read can never observe a window
    where an enqueued entry is neither in the overlay nor on disk.
    """

    #: entries per backend ``put_many`` batch while draining
    DRAIN_BATCH = 1024
    #: pending entries beyond which ``put`` applies backpressure by
    #: draining synchronously on the calling thread
    MAX_PENDING = 8192

    def __init__(self, put_many: Callable[[List[Tuple[bytes, bytes]]], None],
                 *, lock: Optional[Callable[[], object]] = None,
                 max_pending: int = MAX_PENDING) -> None:
        self._put_many = put_many
        #: the backend's re-entrant compute-once lock (a zero-arg
        #: context-manager factory).  Drains take it BEFORE
        #: ``_flush_lock`` — the same order as the miss path (which
        #: holds it when it enqueues and when ``barrier()`` drains) —
        #: so a background drain and a lock-holding barrier can never
        #: deadlock on the pair
        self._backend_lock = lock
        self._max_pending = max_pending
        self._lock = threading.Lock()          # overlay + queue state
        self._flush_lock = threading.Lock()    # serializes drains
        self._overlay: Dict[bytes, bytes] = {}
        self._order: List[bytes] = []
        self._task_live = False
        self._closed = False
        #: test hook — ``REPRO_WRITE_BEHIND_HOLD=1`` disables the
        #: background drain so pending state is deterministic (the
        #: crash-consistency test kills a process in exactly this window)
        self._hold = os.environ.get("REPRO_WRITE_BEHIND_HOLD") == "1"

    # -- producer (miss path, under the compute-once lock) -------------------
    def put(self, items: Sequence[Tuple[bytes, bytes]]) -> None:
        if not items:
            return
        with self._lock:
            if self._closed:
                raise RuntimeError("write-behind writer is closed")
            for k, v in items:
                if k not in self._overlay:
                    self._order.append(k)
                self._overlay[k] = v
            backlog = len(self._order)
        if self._hold:
            return
        if backlog > self._max_pending:
            self.flush()                       # backpressure: drain inline
        else:
            self._schedule()

    def _schedule(self) -> None:
        with self._lock:
            if self._task_live or not self._order:
                return
            self._task_live = True
        io_pool().submit(self._background_drain)

    def _background_drain(self) -> None:
        try:
            self._drain()
        finally:
            with self._lock:
                self._task_live = False
                rearm = bool(self._order) and not self._closed
            if rearm:                          # a put raced the drain
                self._schedule()

    def _drain(self) -> None:
        if self._backend_lock is not None:
            with self._backend_lock():
                self._drain_ordered()
        else:
            self._drain_ordered()

    def _drain_ordered(self) -> None:
        with self._flush_lock:
            while True:
                with self._lock:
                    batch_keys = self._order[:self.DRAIN_BATCH]
                    del self._order[:len(batch_keys)]
                    batch = [(k, self._overlay[k]) for k in batch_keys]
                if not batch:
                    return
                try:
                    self._put_many(batch)
                except Exception:
                    # keep the entries readable (and re-flushable): put
                    # them back at the front and surface on next flush
                    with self._lock:
                        self._order[:0] = batch_keys
                    raise
                with self._lock:
                    for k in batch_keys:
                        self._overlay.pop(k, None)

    # -- consumer (read paths) ----------------------------------------------
    def overlay_many(self, keys: Sequence[bytes]) -> Dict[bytes, bytes]:
        """Pending (not yet durable) entries among ``keys``."""
        with self._lock:
            if not self._overlay:
                return {}
            return {k: self._overlay[k] for k in keys if k in self._overlay}

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._order)

    # -- flush points --------------------------------------------------------
    def barrier(self) -> None:
        """Durability barrier for the compute-once protocol: families
        call this *before releasing the backend's cross-process lock*,
        so a racing process's locked recheck observes every put of this
        miss batch and the exactly-once guarantee survives write-behind
        (the in-memory overlay is invisible across processes).  Honors
        the HOLD test hook — which is exactly a simulated crash inside
        the pre-flush window."""
        if self._hold:
            return
        self._drain()

    def flush(self) -> None:
        """Drain synchronously; on return every accepted put is durable
        (modulo a concurrent ``put`` racing in after the drain)."""
        self._drain()

    def close(self) -> None:
        """Final flush, then reject further puts."""
        with self._lock:
            self._closed = True
        self._drain()
