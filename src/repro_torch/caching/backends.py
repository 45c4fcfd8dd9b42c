"""Pluggable storage backends for the explicit cache families (§4).

Counterpart of ``repro.caching.backends``: the same store formats, so a
directory written by either package opens in the other.  The
combinator selectors ``"tiered[:<disk>]"`` and ``"mmap[:<disk>]"``
validate and normalize as in the reference, and open a
:class:`~repro_torch.caching.tiered.TieredBackend` and a
:class:`~repro_torch.caching.mmap_tier.MmapTier`.

Before this module each cache family rolled its own persistence —
``KeyValueCache`` embedded SQLite, ``RetrieverCache`` embedded ``dbm``,
``DenseScorerCache`` hand-managed memmaps.  All of them reduce to the
same contract: an (optionally persistent) ``bytes → bytes`` map with
batched lookup/insert.  ``CacheBackend`` names that contract once and
the families select an implementation via a ``backend=`` parameter
(also plumbed through ``auto_cache`` and the execution planner).

Implementations:

* ``"memory"`` — a bounded in-process LRU (no persistence; ideal for
  planner-inserted memos inside a single run);
* ``"pickle"`` — one file per entry under the cache directory, written
  with atomic renames (content-addressed like a git object store);
* ``"dbm"``    — a single ``dbm`` database, every open/read/write under
  an inter-process file lock (gdbm handles cannot be shared);
* ``"sqlite"`` — the paper's §4.1 choice, kept as the
  ``KeyValueCache`` default.

Concurrency contract (the executor in ``core/plan.py`` relies on it):

* every method is safe to call from multiple threads of one process;
* on-disk backends are safe against concurrent *processes* sharing one
  cache directory: writes happen under an ``fcntl`` file lock and/or an
  atomic ``os.replace``, so readers never observe torn entries;
* ``lock()`` exposes the same exclusive lock to callers, letting the
  cache families implement *compute-once* misses: take the lock,
  re-check, compute only what is still absent, insert, release.  Two
  shards (or two CI jobs) racing on the same key therefore compute it
  exactly once (stress-tested for every backend in the reference,
  whose stores these are).  The exactly-once guarantee deliberately
  serializes *miss computation* across workers sharing one store; pure
  hits stay concurrent (lock-free pickle reads, shared-flock dbm
  reads, WAL sqlite reads).
"""
from __future__ import annotations

import hashlib
import os
import sqlite3
import tempfile
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Type, Union

try:                                     # POSIX; on other platforms the
    import fcntl                         # thread lock still serializes
except ImportError:                      # pragma: no cover - linux CI
    fcntl = None

__all__ = ["CacheBackend", "MemoryLRUBackend", "PickleDirBackend",
           "DbmBackend", "SQLiteBackend", "FileLock", "atomic_write_bytes",
           "open_backend", "resolve_backend_name", "select_backend",
           "BACKENDS", "split_tiered", "split_mmap", "split_combinator",
           "registered_selectors", "storage_identity",
           "backend_store_exists", "measure_round_trip"]


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------

def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via a same-directory temp file and an
    atomic ``os.replace`` — concurrent readers see the old blob or the
    new blob, never a torn one."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class FileLock:
    """Re-entrant exclusive lock spanning threads *and* processes.

    A ``threading.RLock`` serializes threads of this process; an
    ``fcntl.flock`` on a sidecar file serializes against other
    processes.  Usable as a context manager.
    """

    def __init__(self, path: str):
        self.path = path
        self._tlock = threading.RLock()
        self._depth = 0
        self._fd: Optional[int] = None
        self._owner: Optional[int] = None

    def held(self) -> bool:
        """True when the *calling thread* holds this lock (lets read
        paths inside a compute-once critical section skip re-locking)."""
        return self._owner == threading.get_ident()

    def acquire(self) -> None:
        self._tlock.acquire()
        try:
            if self._depth == 0 and fcntl is not None:
                fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX)
                except BaseException:
                    os.close(fd)
                    raise
                self._fd = fd
            self._depth += 1
            self._owner = threading.get_ident()
        except BaseException:
            # roll back the thread lock so a failed acquire (unwritable
            # lock file, interrupt) surfaces instead of deadlocking
            # every other thread touching this cache
            self._tlock.release()
            raise

    def release(self) -> None:
        try:
            if self._depth == 1:
                self._owner = None
                if self._fd is not None:
                    fcntl.flock(self._fd, fcntl.LOCK_UN)
                    os.close(self._fd)
                    self._fd = None
        finally:
            self._depth -= 1
            self._tlock.release()

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


@contextmanager
def _shared_flock(path: str):
    """A short-lived *shared* flock for read paths: concurrent readers
    proceed together, while a writer holding the exclusive ``FileLock``
    on the same file excludes them."""
    if fcntl is None:                    # pragma: no cover - linux CI
        yield
        return
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_SH)
        yield
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)


def _store_file(path: str, preferred: str, legacy: str) -> str:
    """Resolve a backend's store file, honouring directories written by
    the pre-backend cache families (kv.sqlite3 / retriever.db) so warm
    caches stay warm across the refactor."""
    new = os.path.join(path, preferred)
    old = os.path.join(path, legacy)
    if not os.path.exists(new) and _legacy_store_exists(old):
        return old
    return new


def _legacy_store_exists(base: str) -> bool:
    # dbm flavours append suffixes (gdbm: none; ndbm: .db; dumb: .dat)
    if os.path.exists(base):
        return True
    return any(os.path.exists(base + suf) for suf in (".db", ".dat", ".dir"))


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------

class CacheBackend:
    """``bytes → bytes`` store with batched access and an exclusive lock.

    Subclasses implement ``get_many`` / ``put_many`` / ``__len__`` /
    ``_close``; everything else is shared.  ``close()`` is idempotent.
    """

    #: registry name, set on concrete classes
    name: str = ""
    #: whether entries survive the process (drives test parametrization)
    persistent: bool = True
    #: whether ``items()``/``entry_stats()`` can enumerate the store
    #: (``mmap:<disk>`` snapshots require it; pickle stores hashed keys
    #: only and opts out)
    enumerable: bool = True
    #: whether moving this backend's reads onto the I/O pool can pay
    #: (see ``caching/dataplane.py``): disk stores say yes, while a
    #: memory-speed read path (the in-process LRU, the mmap snapshot
    #: tier) opts out — staging a dict lookup only adds bookkeeping
    prefetchable: bool = True

    def __init__(self, path: Optional[str]):
        self.path = path
        self._closed = False
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._lock = FileLock(os.path.join(path, ".lock"))
        else:
            self._lock = threading.RLock()   # memory backend: threads only

    # -- required ----------------------------------------------------------
    def get_many(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        raise NotImplementedError

    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def items(self) -> List[Tuple[bytes, bytes]]:
        """All ``(key, value)`` entries (drives ``repro cache export``).

        Optional: backends that cannot recover keys from their store
        raise ``NotImplementedError`` and are exported as raw files.
        """
        raise NotImplementedError(
            f"{type(self).__name__} cannot enumerate entries")

    def delete_many(self, keys: Sequence[bytes]) -> int:
        """Remove entries (eviction / budget enforcement); returns the
        number actually deleted.  Absent keys are ignored."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support entry deletion")

    def entry_stats(self) -> List[Tuple[bytes, int]]:
        """``(key, value_size_bytes)`` for every entry — the eviction
        pass ranks these by recency.  Backends that cannot enumerate
        keys raise ``NotImplementedError`` (same contract as
        ``items()``); the default derives sizes from ``items()``."""
        return [(k, len(v)) for k, v in self.items()]

    def stat_entries(self, keys: Sequence[bytes]
                     ) -> List[Optional[int]]:
        """Value sizes for the given keys (``None`` = absent).  Works on
        every backend — including ones whose stores cannot enumerate —
        at the cost of reading the values."""
        return [len(v) if v is not None else None
                for v in self.get_many(keys)]

    @classmethod
    def store_exists(cls, path: str) -> bool:
        """Whether ``path`` already holds this backend's store files —
        answered *without* opening (and thereby creating) a store, for
        offline inspection (``repro cache verify`` / ``export``)."""
        return False

    def _close(self) -> None:
        pass

    # -- shared ------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        """Single-key lookup.  The default delegates to ``get_many``;
        backends override it with a leaner path (one SELECT, one file
        read) — the read-through fast path the serving layer leans on
        for per-request lookups."""
        return self.get_many([key])[0]

    def put(self, key: bytes, value: bytes) -> None:
        self.put_many([(key, value)])

    @contextmanager
    def lock(self):
        """Exclusive section across threads and (for disk backends)
        processes — the compute-once critical section."""
        with self._lock:
            yield self

    def close(self) -> None:
        if self._closed:
            return
        self._close()
        self._closed = True


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------

class MemoryLRUBackend(CacheBackend):
    """Bounded in-process LRU; ``path`` is ignored (no persistence)."""

    name = "memory"
    persistent = False
    prefetchable = False                 # reads are already a dict lookup

    def __init__(self, path: Optional[str] = None, *,
                 capacity: int = 1_000_000):
        super().__init__(None)
        self.capacity = int(capacity)
        self._data: "OrderedDict[bytes, bytes]" = OrderedDict()

    def get_many(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        with self._lock:
            out: List[Optional[bytes]] = []
            for k in keys:
                v = self._data.get(k)
                if v is not None:
                    self._data.move_to_end(k)
                out.append(v)
            return out

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            v = self._data.get(key)
            if v is not None:
                self._data.move_to_end(key)
            return v

    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> None:
        with self._lock:
            for k, v in items:
                self._data[k] = v
                self._data.move_to_end(k)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def items(self) -> List[Tuple[bytes, bytes]]:
        with self._lock:
            return list(self._data.items())

    def delete_many(self, keys: Sequence[bytes]) -> int:
        with self._lock:
            return sum(self._data.pop(k, None) is not None for k in keys)


class PickleDirBackend(CacheBackend):
    """One file per entry, named by the SHA-256 of the key, written with
    atomic renames.  Lock-free reads; concurrent writers of the same key
    are idempotent (deterministic transformers ⇒ identical blobs), so a
    lost race costs a rewrite, never a torn entry."""

    name = "pickle"
    enumerable = False

    def __init__(self, path: str):
        if path is None:
            raise ValueError("PickleDirBackend requires a directory")
        super().__init__(path)
        self._objdir = os.path.join(path, "objects")
        os.makedirs(self._objdir, exist_ok=True)

    def _file_of(self, key: bytes) -> str:
        h = hashlib.sha256(key).hexdigest()
        return os.path.join(self._objdir, h[:2], h[2:] + ".bin")

    def get(self, key: bytes) -> Optional[bytes]:
        try:
            with open(self._file_of(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def get_many(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        out: List[Optional[bytes]] = []
        for k in keys:
            try:
                with open(self._file_of(k), "rb") as f:
                    out.append(f.read())
            except FileNotFoundError:
                out.append(None)
        return out

    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> None:
        for k, v in items:
            fp = self._file_of(k)
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            atomic_write_bytes(fp, v)

    def __len__(self) -> int:
        n = 0
        for _, _, files in os.walk(self._objdir):
            n += sum(f.endswith(".bin") for f in files)
        return n

    def items(self) -> List[Tuple[bytes, bytes]]:
        # entry files are named by the *hash* of the key; the key itself
        # is unrecoverable, so this store exports as raw files instead
        raise NotImplementedError(
            "PickleDirBackend stores hashed keys only; export the cache "
            "directory as raw files")

    def delete_many(self, keys: Sequence[bytes]) -> int:
        n = 0
        for k in keys:
            try:
                os.unlink(self._file_of(k))
                n += 1
            except FileNotFoundError:
                pass
        return n

    def stat_entries(self, keys: Sequence[bytes]) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        for k in keys:
            try:
                out.append(os.path.getsize(self._file_of(k)))
            except OSError:
                out.append(None)
        return out

    @classmethod
    def store_exists(cls, path: str) -> bool:
        return os.path.isdir(os.path.join(path, "objects"))


class DbmBackend(CacheBackend):
    """A single ``dbm`` database (the paper's §4.3 retriever store).

    gdbm handles are single-writer and do not observe other writers, so
    the database is opened per operation: writes under the exclusive
    inter-process file lock, reads under a *shared* flock (concurrent
    readers proceed together; a writer excludes them) — so concurrent
    shards, threads and CI jobs sharing one cache directory never
    corrupt the store, and pure cache hits do not serialize.
    """

    name = "dbm"

    def __init__(self, path: str):
        if path is None:
            raise ValueError("DbmBackend requires a directory")
        super().__init__(path)
        self._file = _store_file(path, "cache.dbm", "retriever.db")
        import dbm
        self._dbm = dbm
        with self._lock:                     # create eagerly for readers
            db = dbm.open(self._file, "c")
            db.close()

    @contextmanager
    def _read_locked(self):
        # inside our own exclusive section (compute-once recheck), a
        # shared flock on the same file would deadlock — skip it
        if self._lock.held():
            yield
        else:
            with _shared_flock(self._lock.path):
                yield

    def get_many(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        with self._read_locked():
            db = self._dbm.open(self._file, "r")
            try:
                return [db[k] if k in db else None for k in keys]
            finally:
                db.close()

    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> None:
        with self._lock:
            db = self._dbm.open(self._file, "c")
            try:
                for k, v in items:
                    db[k] = v
            finally:
                db.close()

    def __len__(self) -> int:
        with self._read_locked():
            db = self._dbm.open(self._file, "r")
            try:
                return len(db)
            finally:
                db.close()

    def items(self) -> List[Tuple[bytes, bytes]]:
        with self._read_locked():
            db = self._dbm.open(self._file, "r")
            try:
                return [(bytes(k), bytes(db[k])) for k in db.keys()]
            finally:
                db.close()

    def delete_many(self, keys: Sequence[bytes]) -> int:
        n = 0
        with self._lock:
            db = self._dbm.open(self._file, "w")
            try:
                for k in keys:
                    if k in db:
                        del db[k]
                        n += 1
            finally:
                db.close()
        return n

    @classmethod
    def store_exists(cls, path: str) -> bool:
        return _legacy_store_exists(os.path.join(path, "cache.dbm")) or \
            _legacy_store_exists(os.path.join(path, "retriever.db"))


_SQLITE_SCHEMA = """
CREATE TABLE IF NOT EXISTS kv (
  key   BLOB PRIMARY KEY,
  value BLOB NOT NULL
) WITHOUT ROWID;
"""


class SQLiteBackend(CacheBackend):
    """SQLite store (the paper's §4.1 KeyValueCache implementation).

    One connection shared across threads (``check_same_thread=False``)
    behind an in-process lock; SQLite's WAL journal already lets
    concurrent *processes* read alongside a writer, so reads and writes
    deliberately avoid the inter-process ``FileLock`` — it is reserved
    for ``lock()`` (the compute-once critical section).
    """

    name = "sqlite"

    def __init__(self, path: str):
        if path is None:
            raise ValueError("SQLiteBackend requires a directory")
        super().__init__(path)
        self._conn_lock = threading.Lock()
        self._db = sqlite3.connect(
            _store_file(path, "cache.sqlite3", "kv.sqlite3"),
            check_same_thread=False)
        self._db.executescript(_SQLITE_SCHEMA)
        # bulk lookups are much faster with a page cache
        self._db.execute("PRAGMA cache_size = -65536")
        self._db.execute("PRAGMA journal_mode = WAL")
        self._db.execute("PRAGMA synchronous = NORMAL")

    def get_many(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        out: List[Optional[bytes]] = [None] * len(keys)
        CHUNK = 900                          # sqlite var limit is 999
        # a key may occur several times in one lookup batch (e.g. a
        # micro-batch coalescing concurrent requests for the same hot
        # query) — every occurrence must resolve, not just the last
        pos: Dict[bytes, List[int]] = {}
        for i, k in enumerate(keys):
            pos.setdefault(k, []).append(i)
        uniq = list(pos)
        with self._conn_lock:
            for lo in range(0, len(uniq), CHUNK):
                chunk = uniq[lo:lo + CHUNK]
                q = ("SELECT key, value FROM kv WHERE key IN (%s)"
                     % ",".join("?" * len(chunk)))
                for k, v in self._db.execute(q, chunk):
                    blob = bytes(v)
                    for i in pos[bytes(k)]:
                        out[i] = blob
        return out

    def get(self, key: bytes) -> Optional[bytes]:
        with self._conn_lock:
            row = self._db.execute(
                "SELECT value FROM kv WHERE key = ?", (key,)).fetchone()
        return bytes(row[0]) if row is not None else None

    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> None:
        with self._conn_lock:
            with self._db:
                self._db.executemany(
                    "INSERT OR REPLACE INTO kv (key, value) VALUES (?, ?)",
                    items)

    def __len__(self) -> int:
        with self._conn_lock:
            (n,) = self._db.execute("SELECT COUNT(*) FROM kv").fetchone()
        return int(n)

    def items(self) -> List[Tuple[bytes, bytes]]:
        with self._conn_lock:
            return [(bytes(k), bytes(v)) for k, v in
                    self._db.execute("SELECT key, value FROM kv")]

    def delete_many(self, keys: Sequence[bytes]) -> int:
        CHUNK = 900
        n = 0
        with self._conn_lock:
            with self._db:
                for lo in range(0, len(keys), CHUNK):
                    chunk = list(keys[lo:lo + CHUNK])
                    cur = self._db.execute(
                        "DELETE FROM kv WHERE key IN (%s)"
                        % ",".join("?" * len(chunk)), chunk)
                    n += cur.rowcount
        return n

    def entry_stats(self) -> List[Tuple[bytes, int]]:
        with self._conn_lock:
            return [(bytes(k), int(n)) for k, n in self._db.execute(
                "SELECT key, length(value) FROM kv")]

    @classmethod
    def store_exists(cls, path: str) -> bool:
        return os.path.exists(os.path.join(path, "cache.sqlite3")) or \
            os.path.exists(os.path.join(path, "kv.sqlite3"))

    def _close(self) -> None:
        try:
            self._db.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

BACKENDS: Dict[str, Type[CacheBackend]] = {
    "memory": MemoryLRUBackend,
    "pickle": PickleDirBackend,
    "dbm": DbmBackend,
    "sqlite": SQLiteBackend,
}

#: default disk tier of the bare ``"tiered"`` / ``"mmap"`` selectors
TIERED_DEFAULT_DISK = "sqlite"

#: combinator selectors: accelerator tiers composed *over* a persistent
#: registry backend (``"<combinator>[:<disk>]"``).  ``requires_enumerable``
#: marks combinators that must enumerate the disk store (the mmap tier
#: packs a snapshot of every entry, so it cannot sit over ``pickle``).
_COMBINATORS: Dict[str, Dict[str, bool]] = {
    "tiered": {"requires_enumerable": False},
    "mmap": {"requires_enumerable": True},
}


def _combinator_disks(combinator: str) -> List[str]:
    """Registry disk names a combinator may compose over."""
    req = _COMBINATORS[combinator]["requires_enumerable"]
    return sorted(n for n, cls in BACKENDS.items()
                  if cls.persistent and (cls.enumerable or not req))


def _split_combinator_as(combinator: str, name: str) -> Optional[str]:
    """The validated disk-tier name of a ``"<combinator>[:<disk>]"``
    selector; ``None`` when ``name`` is not that combinator at all."""
    if not isinstance(name, str) or \
            not (name == combinator or name.startswith(combinator + ":")):
        return None
    disk = name.partition(":")[2] or TIERED_DEFAULT_DISK
    if disk not in _combinator_disks(combinator):
        known = ", ".join(f"'{combinator}:{n}'"
                          for n in _combinator_disks(combinator))
        extra = (" that can enumerate its entries"
                 if _COMBINATORS[combinator]["requires_enumerable"] else "")
        raise ValueError(
            f"unknown {combinator} cache selector {name!r}; the disk tier "
            f"must be a persistent registry backend{extra} — valid "
            f"selectors are {known} (bare '{combinator}' means "
            f"'{combinator}:{TIERED_DEFAULT_DISK}')")
    return disk


def split_tiered(name: str) -> Optional[str]:
    """The disk-tier registry name of a ``"tiered"`` /
    ``"tiered:<disk>"`` selector, validated; ``None`` when ``name`` is
    not a tiered selector at all.  Raises ``ValueError`` for a tiered
    selector over an unknown or non-persistent disk tier."""
    return _split_combinator_as("tiered", name)


def split_mmap(name: str) -> Optional[str]:
    """The disk-tier registry name of an ``"mmap"`` / ``"mmap:<disk>"``
    selector, validated; ``None`` when ``name`` is not an mmap selector.
    Raises ``ValueError`` over a disk tier that is unknown,
    non-persistent, or cannot enumerate its entries (``pickle``)."""
    return _split_combinator_as("mmap", name)


def split_combinator(name: str) -> Optional[Tuple[str, str]]:
    """``(combinator, disk)`` for a combinator selector, validated;
    ``None`` for plain registry names (and non-strings)."""
    for combinator in _COMBINATORS:
        disk = _split_combinator_as(combinator, name)
        if disk is not None:
            return combinator, disk
    return None


def registered_selectors() -> List[str]:
    """Every valid ``backend=`` selector string: the registry names
    plus each combinator over each admissible disk tier.  This is the
    list unknown-selector errors print and the CLI help references."""
    out = sorted(BACKENDS)
    for combinator in sorted(_COMBINATORS):
        out.extend(f"{combinator}:{n}" for n in _combinator_disks(combinator))
    return out


def storage_identity(name) -> Optional[str]:
    """The disk store a selector ultimately persists into — combinator
    prefixes stripped (``"tiered:sqlite"`` / ``"mmap:sqlite"`` →
    ``"sqlite"``).  Combinators are pure accelerators over the same
    store files, so two selectors with equal storage identity can open
    the same warm cache directory interchangeably (this is what the
    manifest staleness check compares).  Unknown/invalid selectors pass
    through unchanged — the caller's name validation reports them."""
    if not isinstance(name, str):
        return name
    try:
        combo = split_combinator(name)
    except ValueError:
        return name
    return combo[1] if combo is not None else name


def resolve_backend_name(spec: Union[str, CacheBackend, None],
                         default: str = "sqlite") -> str:
    """The registry name a ``backend=`` selector resolves to, validated
    *without* opening a store (so callers can check manifests first).

    Besides the registry names, the combinator selectors compose an
    accelerator tier over a named disk backend — ``"tiered[:<disk>]"``
    (:class:`~repro_torch.caching.tiered.TieredBackend`, a memory-LRU
    front) and ``"mmap[:<disk>]"``
    (:class:`~repro_torch.caching.mmap_tier.MmapTier`, a packed
    read-only snapshot shared across processes) — and normalize
    to the explicit ``"<combinator>:<disk>"`` form (what manifests
    record).

    Raises ``TypeError`` for selectors that are neither a name, an
    instance nor ``None``, and ``ValueError`` (listing every registered
    selector) for unknown names.
    """
    if isinstance(spec, CacheBackend):
        return spec.name or type(spec).__name__
    if spec is None:
        spec = default
    if not isinstance(spec, str):
        raise TypeError(
            f"cache backend selector must be a registry name "
            f"({', '.join(repr(n) for n in sorted(BACKENDS))}), a "
            f"CacheBackend instance, or None — got "
            f"{type(spec).__name__}: {spec!r}")
    combo = split_combinator(spec)
    if combo is not None:
        return f"{combo[0]}:{combo[1]}"
    if spec not in BACKENDS:
        known = ", ".join(repr(n) for n in registered_selectors())
        raise ValueError(
            f"unknown cache backend {spec!r}; registered selectors are "
            f"{known} — 'tiered:<disk>' is a memory-LRU front over a disk "
            f"backend, 'mmap:<disk>' a packed read-only snapshot whose "
            f"hits skip the inter-process lock (pass a CacheBackend "
            f"instance for a custom store)")
    return spec


def select_backend(selector: Union[str, CacheBackend, None],
                   default: str = "sqlite") -> str:
    """Public backend-selection API: validate a ``backend=`` selector
    and return the normalized registry name it resolves to, without
    opening (or creating) any store.

    Accepts plain registry names (``"memory"`` / ``"pickle"`` /
    ``"dbm"`` / ``"sqlite"``), the combinator forms ``"tiered[:<disk>]"``
    and ``"mmap[:<disk>]"``, a :class:`CacheBackend` instance (resolves
    to its ``name``), or ``None`` (resolves to ``default``).  Unknown
    selectors raise ``ValueError`` listing every registered selector
    (see :func:`registered_selectors`).
    """
    return resolve_backend_name(selector, default)


def open_backend(spec: Union[str, CacheBackend, None], path: Optional[str],
                 default: str = "sqlite") -> CacheBackend:
    """Resolve a ``backend=`` argument: an instance passes through, a
    name is looked up in ``BACKENDS``, ``None`` means ``default``,
    ``"tiered[:<disk>]"`` builds a ``TieredBackend`` and
    ``"mmap[:<disk>]"`` an ``MmapTier`` over the named disk backend.
    Unknown selectors raise with the registered selectors spelled
    out."""
    if isinstance(spec, CacheBackend):
        return spec
    name = resolve_backend_name(spec, default)
    combo = split_combinator(name)
    if combo is not None:
        combinator, disk = combo
        if combinator == "tiered":
            from .tiered import TieredBackend   # deferred: imports us
            return TieredBackend(path, disk=disk)
        from .mmap_tier import MmapTier         # deferred: imports us
        return MmapTier(path, disk=disk)
    return BACKENDS[name](path)


# one measurement per resolved selector per process — the figure feeds
# cost *estimates*, so amortizing it is more valuable than freshness
_ROUND_TRIP_CACHE: Dict[str, float] = {}
_ROUND_TRIP_LOCK = threading.Lock()


def measure_round_trip(spec: Union[str, CacheBackend, None], *,
                       default: str = "sqlite", payload_bytes: int = 2048,
                       n_entries: int = 32, n_rounds: int = 3) -> float:
    """Measured warm per-entry round-trip cost of a backend selector
    (seconds): the amortized cost of one entry in a batched
    ``get_many`` over a freshly-written throwaway store.

    This is the figure the plan compiler's ``cache-place`` pass weighs
    against a node's estimated recompute cost — caching a stage whose
    recompute is cheaper than this round trip only *adds* latency (and
    disk), so the planner skips it.  Microbenchmarked once per resolved
    selector per process (cached); combinator selectors
    (``tiered:<disk>`` / ``mmap:<disk>``) measure the combinator's own
    warm-hit path, which is the one serving traffic sees.
    """
    name = resolve_backend_name(spec, default)
    with _ROUND_TRIP_LOCK:
        hit = _ROUND_TRIP_CACHE.get(name)
    if hit is not None:
        return hit
    import shutil
    import time
    tmp = tempfile.mkdtemp(prefix="repro-torch-rt-")
    try:
        backend = open_backend(name, tmp)
        try:
            payload = b"\x5a" * max(1, int(payload_bytes))
            keys = [b"rt-%06d" % i for i in range(max(1, int(n_entries)))]
            backend.put_many((k, payload) for k in keys)
            backend.get_many(keys)       # warm any front tier / page cache
            best = float("inf")
            for _ in range(max(1, int(n_rounds))):
                t0 = time.perf_counter()
                backend.get_many(keys)
                best = min(best, time.perf_counter() - t0)
            per_entry = best / len(keys)
        finally:
            backend.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with _ROUND_TRIP_LOCK:
        _ROUND_TRIP_CACHE[name] = per_entry
    return per_entry


def backend_store_exists(name: Optional[str], path: str) -> bool:
    """``store_exists`` by resolved backend *name*, understanding the
    ``tiered:<disk>`` / ``mmap:<disk>`` combinators (whose on-disk
    footprint is their disk tier's) — for offline inspection without
    opening a store."""
    try:
        combo = split_combinator(name) if isinstance(name, str) else None
    except ValueError:
        return False
    if combo is not None:
        return BACKENDS[combo[1]].store_exists(path)
    if name in BACKENDS:
        return BACKENDS[name].store_exists(path)
    return False
