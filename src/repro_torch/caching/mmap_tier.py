"""MmapTier — a packed, read-only, lock-free snapshot over a disk store.

Counterpart of ``repro.caching.mmap_tier``: the same pack file, byte
for byte, so a snapshot written by either package maps in the other.

The fleet-scaling piece of the paper's precomputation story: with N
worker processes serving the *same* warm cache directory (the
reference's ``serve/fleet.py``), every hit on the ``dbm`` backend takes a shared
``flock`` and re-opens the database, and ``sqlite`` hits pay an SQL
round-trip under a connection lock.  For read-mostly traffic — which is
exactly what a warmed cache serves — none of that coordination buys
anything: the entries are immutable (deterministic transformers) and
already on disk.

``MmapTier`` therefore snapshots the disk store into a packed
append-only file (``mmap-snapshot.pack``, written with an atomic
rename) and ``mmap``s it read-only.  Hits resolve against the mapping
with **no file lock, no db open, no syscall beyond the page fault** —
the OS page cache is shared across every worker process mapping the
same file, so N workers serve hits from one copy of the data:

* **reads** probe the snapshot first and fall through to the disk
  backend on a snapshot miss, so the tier is observationally identical
  to the bare disk store;
* **writes still go through the locked compute-once path** — ``put``
  lands in the disk backend only, and ``lock()`` delegates to the disk
  tier's inter-process ``FileLock``, so concurrent misses across the
  fleet compute exactly once, same as every other backend;
* **refresh on a miss-rate trigger** — keys written after the snapshot
  was taken are tracked (and served from disk); once ``refresh_after``
  fall-throughs have *found* entries the snapshot lacks, the tier
  repacks, so a worker that keeps missing into a growing store
  converges back to lock-free hits.

Consistency contract: the snapshot may lag the disk store, never
contradict it.  A key written or deleted *through this tier* is
shadowed (always resolved against disk) until the next refresh; a key
written by a *foreign process* is found via the disk fall-through (a
snapshot miss), counted toward the refresh trigger.  Since cache
entries are append-only — deterministic transformers never rewrite a
key with a different value — a stale snapshot can only be missing
entries, not wrong about them.

Selected as ``"mmap"`` (sqlite disk tier) or ``"mmap:<disk>"`` through
the normal registry plumbing (``caching.select_backend``); the disk
tier must be able to enumerate its entries, so ``mmap:pickle`` is
rejected at selector-validation time.
"""
from __future__ import annotations

import mmap
import os
import struct
import threading
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .backends import (BACKENDS, CacheBackend, atomic_write_bytes,
                       split_mmap)

__all__ = ["MmapTier", "DEFAULT_REFRESH_AFTER", "PACK_FILE"]

#: snapshot fall-throughs that *found* a disk entry before a repack
DEFAULT_REFRESH_AFTER = 64

#: the packed snapshot's file name inside the cache directory
PACK_FILE = "mmap-snapshot.pack"

_MAGIC = b"RMMPACK1"
_HEADER = struct.Struct("<8sQ")          # magic, entry count
_ENTRY = struct.Struct("<II")            # key length, value length


def _pack_entries(entries: Iterable[Tuple[bytes, bytes]], path: str) -> int:
    """Write a packed snapshot atomically; returns the entry count."""
    chunks: List[bytes] = []
    n = 0
    for k, v in entries:
        chunks.append(_ENTRY.pack(len(k), len(v)))
        chunks.append(bytes(k))
        chunks.append(bytes(v))
        n += 1
    atomic_write_bytes(path, _HEADER.pack(_MAGIC, n) + b"".join(chunks))
    return n


class _Snapshot:
    """One immutable mapped view of a pack file plus its key index.

    Never mutated after construction; the tier swaps whole snapshots
    atomically, and readers keep a local reference — so a concurrent
    refresh can never invalidate a lookup in flight.  The mapping is
    closed by GC once the last reader drops its reference.
    """

    __slots__ = ("_mm", "_index", "path")

    def __init__(self, path: str):
        self.path = path
        self._index: Dict[bytes, Tuple[int, int]] = {}
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < _HEADER.size:
                raise ValueError(f"truncated snapshot pack {path!r}")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, count = _HEADER.unpack_from(self._mm, 0)
        if magic != _MAGIC:
            raise ValueError(f"bad snapshot magic in {path!r}")
        off = _HEADER.size
        for _ in range(count):
            klen, vlen = _ENTRY.unpack_from(self._mm, off)
            off += _ENTRY.size
            key = bytes(self._mm[off:off + klen])
            off += klen
            self._index[key] = (off, vlen)
            off += vlen

    def get(self, key: bytes) -> Optional[bytes]:
        e = self._index.get(key)
        if e is None:
            return None
        off, vlen = e
        return bytes(self._mm[off:off + vlen])

    def __len__(self) -> int:
        return len(self._index)


class MmapTier(CacheBackend):
    """Read-mostly accelerator: lock-free mmap'd snapshot reads over a
    persistent disk backend; writes and compute-once locking delegate
    to the disk tier."""

    persistent = True
    #: snapshot hits are lock-free page-cache reads — prefetching them
    #: onto the I/O pool would only copy memory-speed lookups into a
    #: staging map, so the data plane skips this tier entirely
    prefetchable = False

    def __init__(self, path: Optional[str], *,
                 disk: str = "sqlite",
                 refresh_after: int = DEFAULT_REFRESH_AFTER):
        if isinstance(disk, CacheBackend):
            self.disk: CacheBackend = disk
        else:
            resolved = split_mmap(f"mmap:{disk}")
            if path is None:
                raise ValueError(
                    "MmapTier requires a cache directory (its snapshot "
                    "pack lives next to the disk store)")
            self.disk = BACKENDS[resolved](path)
        # no super().__init__: the disk tier already owns the directory
        # and its FileLock (same reasoning as TieredBackend — a second
        # FileLock on the sidecar would deadlock the nested
        # lock()->put_many path)
        self.path = self.disk.path
        self.name = f"mmap:{self.disk.name}"
        self.refresh_after = max(1, int(refresh_after))
        self.refreshes = 0
        self._pack_path = os.path.join(self.path, PACK_FILE)
        self._mutate_lock = threading.Lock()
        #: keys written/deleted through this tier since the snapshot —
        #: always resolved against disk until the next refresh
        self._shadow: Set[bytes] = set()
        self._found_on_disk = 0
        self._snap: Optional[_Snapshot] = None
        self._closed = False
        self.refresh()

    # -- snapshot lifecycle --------------------------------------------------
    def refresh(self) -> int:
        """Repack the snapshot from the disk store and swap it in;
        returns the new snapshot's entry count.  Enumeration happens
        through the disk backend's own read path (shared flock / WAL
        read), so a concurrent writer is excluded exactly as it would
        be for any bulk read."""
        with self._mutate_lock:
            _pack_entries(self.disk.items(), self._pack_path)
            snap = _Snapshot(self._pack_path)
            # single reference swap: in-flight readers keep the old
            # snapshot alive via their local reference
            self._snap = snap
            self._shadow = set()
            self._found_on_disk = 0
            self.refreshes += 1
            return len(snap)

    def _note_found_on_disk(self) -> None:
        self._found_on_disk += 1
        if self._found_on_disk >= self.refresh_after:
            self.refresh()

    # -- reads (snapshot first, disk fall-through) ---------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        snap, shadow = self._snap, self._shadow
        if key not in shadow:
            v = snap.get(key)
            if v is not None:
                return v
        v = self.disk.get(key)
        if v is not None and key not in shadow:
            # the snapshot lacks an entry the store has: count toward
            # the refresh trigger
            self._note_found_on_disk()
        return v

    def get_many(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        snap, shadow = self._snap, self._shadow
        out: List[Optional[bytes]] = [None] * len(keys)
        miss: List[int] = []
        for i, k in enumerate(keys):
            v = snap.get(k) if k not in shadow else None
            if v is None:
                miss.append(i)
            else:
                out[i] = v
        if miss:
            fetched = self.disk.get_many([keys[i] for i in miss])
            stale = 0
            for i, v in zip(miss, fetched):
                out[i] = v
                if v is not None and keys[i] not in shadow:
                    stale += 1
            for _ in range(stale):
                self._note_found_on_disk()
        return out

    # -- writes (disk only: the locked compute-once path) --------------------
    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> None:
        items = list(items)
        self.disk.put_many(items)
        with self._mutate_lock:
            self._shadow.update(k for k, _ in items)

    def delete_many(self, keys: Sequence[bytes]) -> int:
        n = self.disk.delete_many(keys)
        with self._mutate_lock:
            self._shadow.update(keys)
        return n

    # -- parity views: the disk tier is the source of truth -----------------
    def __len__(self) -> int:
        return len(self.disk)

    def items(self) -> List[Tuple[bytes, bytes]]:
        return self.disk.items()

    def entry_stats(self) -> List[Tuple[bytes, int]]:
        return self.disk.entry_stats()

    def stat_entries(self, keys: Sequence[bytes]) -> List[Optional[int]]:
        return self.disk.stat_entries(keys)

    # -- compute-once: delegate the cross-process exclusive section ---------
    @contextmanager
    def lock(self):
        with self.disk.lock():
            yield self

    @classmethod
    def store_exists(cls, path: str) -> bool:   # pragma: no cover - the
        # CLI resolves mmap selectors through backend_store_exists,
        # which dispatches on the *disk* tier's class
        return False

    def close(self) -> None:
        if self._closed:
            return
        self.disk.close()
        self._snap = None                # GC unmaps once readers drop it
        self._closed = True
