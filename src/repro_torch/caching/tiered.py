"""TieredBackend — a memory-LRU front tier over any disk backend.

Counterpart of ``repro.caching.tiered``: the same tiers over the same
disk stores, so a directory written through it opens in either package.

The cache-economics layer of the paper's precomputation story: disk
stores (`sqlite`/`dbm`/`pickle`, ``backends.py``) make entries durable
and shareable, but every hit still pays a syscall or an SQL round-trip.
``TieredBackend`` composes a bounded in-process
:class:`~repro_torch.caching.backends.MemoryLRUBackend` *in front of* a disk
backend so repeat lookups inside one process are dictionary reads while
the disk tier remains the durable source of truth:

* **write-through puts** — every insert lands in both tiers, so the
  front never holds an entry the disk tier lacks;
* **promote-on-hit** — disk-tier hits are copied into the front, so a
  key's second lookup is served from memory;
* **observational parity** — ``get``/``get_many``/``items()``/
  ``__len__``/``delete_many`` are bit-identical to the bare disk
  backend, across close/reopen cycles too: the front is a pure
  accelerator, never an independent store.

Selected through the normal registry plumbing as ``"tiered"`` (sqlite
disk tier) or ``"tiered:<disk>"``, so ``ExecutionPlan`` and
``auto_cache`` pick it up via their existing
``cache_backend=``/``backend=`` parameters with no API change.

Scope: the front tier is per-process and is *not* invalidated by other
processes writing the shared disk store.  That is safe for the cache
families' append-only usage (entries are only ever inserted or evicted,
never rewritten with different values — deterministic transformers), and
``lock()``/``delete_many`` go through the disk tier so compute-once and
eviction stay correct across processes; but a foreign process's
evictions are not seen by this process's front until it re-opens.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterable, List, Optional, Sequence, Tuple

from .backends import (BACKENDS, CacheBackend, MemoryLRUBackend,
                       split_tiered)

__all__ = ["TieredBackend", "DEFAULT_FRONT_CAPACITY"]

#: default bound of the memory front tier (entries, not bytes)
DEFAULT_FRONT_CAPACITY = 65536


class TieredBackend(CacheBackend):
    """Memory-LRU front over a persistent disk backend (write-through,
    promote-on-hit)."""

    persistent = True
    #: still worth prefetching: the front only absorbs *repeat* reads,
    #: so a run's first pass over a warm store pays the disk tier's
    #: round trip (read by the reference's data plane)
    prefetchable = True

    def __init__(self, path: Optional[str], *,
                 disk: str = "sqlite",
                 front_capacity: int = DEFAULT_FRONT_CAPACITY):
        if isinstance(disk, CacheBackend):
            self.disk: CacheBackend = disk
        else:
            resolved = split_tiered(f"tiered:{disk}")
            self.disk = BACKENDS[resolved](path)
        # no super().__init__: the disk tier already owns the directory
        # and its FileLock — a second FileLock on the same sidecar file
        # would deadlock the nested lock()->put_many path (flock is
        # per-open-file-description, not re-entrant across fds)
        self.path = self.disk.path
        self.name = f"tiered:{self.disk.name}"
        self.front = MemoryLRUBackend(capacity=front_capacity)
        self._closed = False

    # -- reads (probe front, fall through, promote) -------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        v = self.front.get(key)
        if v is not None:
            return v
        v = self.disk.get(key)
        if v is not None:
            self.front.put(key, v)
        return v

    def get_many(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        out = self.front.get_many(keys)
        miss = [i for i, v in enumerate(out) if v is None]
        if not miss:
            return out
        fetched = self.disk.get_many([keys[i] for i in miss])
        promote = []
        for i, v in zip(miss, fetched):
            if v is not None:
                out[i] = v
                promote.append((keys[i], v))
        if promote:
            self.front.put_many(promote)
        return out

    # -- writes (write-through) ---------------------------------------------
    def put_many(self, items: Iterable[Tuple[bytes, bytes]]) -> None:
        items = list(items)
        self.disk.put_many(items)
        self.front.put_many(items)

    def delete_many(self, keys: Sequence[bytes]) -> int:
        self.front.delete_many(keys)
        return self.disk.delete_many(keys)

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
    def store_exists(cls, path: str) -> bool:   # pragma: no cover -
        # backend_store_exists resolves tiered selectors on the *disk*
        # tier's class
        return False

    def close(self) -> None:
        if self._closed:
            return
        self.disk.close()
        self.front.close()
        self._closed = True
