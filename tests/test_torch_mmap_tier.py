"""The port's mmap snapshot tier (``repro_torch.caching.mmap_tier``)
against the reference's (``repro.caching.mmap_tier``): the packed
snapshot file byte for byte, each package mapping the other's pack, the
``mmap[:<disk>]`` selector, the tier's read, write-shadowing, delete
and refresh behaviour on one op sequence, the storage-identity rule
that lets a ``sqlite`` directory serve as ``mmap:sqlite``, and a warm
plan over ``mmap:sqlite`` with no misses in both packages."""
import os

import numpy as np
import pytest
import torch

import repro.caching as jcache
import repro.caching.mmap_tier as jmmap
import repro.core as jcore
import repro_torch.caching as tcache
import repro_torch.caching.mmap_tier as tmmap
import repro_torch.core as tcore
from repro_torch.caching.provenance import set_digest_device
from _torch_parity import frames_equal, pin_round_trip, pipeline_sets, toy

torch.set_num_threads(1)
set_digest_device("cpu")

PKGS = {"ref": (jcore, jcache, jmmap), "port": (tcore, tcache, tmmap)}
ENTRY_SETS = {
    "empty": [],
    "one": [(b"k", b"v")],
    "binary": [(bytes([i, 255 - i]) * (i + 1), bytes(range(i % 256)) * 3)
               for i in range(40)],
    "wide": [(b"key-%05d" % i, os.urandom(0) + b"x" * (i * 37 % 4096))
             for i in range(300)],
    "empty-values": [(b"a", b""), (b"", b"b"), (b"c", b"")],
}


@pytest.mark.parametrize("name", list(ENTRY_SETS))
def test_packed_snapshot_bytes_equal_reference(tmp_path, name):
    entries = ENTRY_SETS[name]
    paths = {k: str(tmp_path / f"{k}.pack") for k in PKGS}
    counts = {k: mod._pack_entries(iter(entries), paths[k])
              for k, (_, _, mod) in PKGS.items()}
    assert counts["port"] == counts["ref"] == len(entries)
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()
    # each package maps the other's pack
    for mine, theirs in (("port", "ref"), ("ref", "port")):
        snap = PKGS[mine][2]._Snapshot(paths[theirs])
        assert len(snap) == len(dict(entries))
        for k, v in entries:
            assert snap.get(k) == dict(entries)[k]
        assert snap.get(b"absent-key") is None


def test_selector_and_registry_match_reference(tmp_path):
    for sel in ("mmap", "mmap:dbm", "mmap:sqlite", "sqlite", "tiered"):
        assert tcache.split_mmap(sel) == jcache.split_mmap(sel)
        assert tcache.select_backend(sel) == jcache.select_backend(sel)
        assert tcache.storage_identity(sel) == jcache.storage_identity(sel)
    for bad, match in (("mmap:memory", "persistent"),
                       ("mmap:pickle", "enumerate"), ("mmap:redis", "mmap")):
        for mod in (tcache, jcache):
            with pytest.raises(ValueError, match=match):
                mod.split_mmap(bad)
    assert tcache.registered_selectors() == jcache.registered_selectors()
    for sel in ("mmap", "mmap:dbm"):
        opened = [m.open_backend(sel, str(tmp_path / f"{k}{sel}"))
                  for k, (_, m, _) in PKGS.items()]
        assert [(type(o).__name__, o.name, o.disk.name, o.persistent,
                 o.prefetchable) for o in opened][0] == \
            [(type(o).__name__, o.name, o.disk.name, o.persistent,
              o.prefetchable) for o in opened][1]
        assert type(opened[1]) is tcache.MmapTier
        for o in opened:
            o.close()
            o.close()                                    # idempotent


def _drive(cache_mod, mmap_mod, root, disk):
    """One op sequence over a tier with ``refresh_after=3``: reads that
    come from the snapshot, from disk through the shadow, after a
    delete, and keys a foreign writer put into the store, which repack
    the snapshot on the third find.  Returns everything observable."""
    seen = []
    bare = cache_mod.open_backend(disk, root)
    bare.put_many([(b"w%d" % i, b"warm-%d" % i) for i in range(5)])
    bare.close()
    t = mmap_mod.MmapTier(root, disk=disk, refresh_after=3)
    seen.append(("packed", os.path.exists(os.path.join(
        root, mmap_mod.PACK_FILE)), t.refreshes, len(t._snap)))
    seen.append(("snapshot", [t._snap.get(b"w%d" % i) for i in range(6)]))
    seen.append(("get_many", t.get_many([b"w0", b"w4", b"nope"])))
    t.put_many([(b"a", b"1"), (b"w0", b"warm-0")])
    seen.append(("shadowed", t._snap.get(b"a"), t.get(b"a"), t.get(b"w0"),
                 t.refreshes))
    seen.append(("delete", t.delete_many([b"w1", b"missing"]),
                 t.get(b"w1"), t.get_many([b"w1", b"w2"]), len(t)))
    seen.append(("refresh", t.refresh(), t._snap.get(b"a"),
                 t._snap.get(b"w1"), t.refreshes))
    foreign = cache_mod.open_backend(disk, root)
    foreign.put_many([(b"f%d" % i, b"v%d" % i) for i in range(4)])
    seen.append(("foreign", [t.get(b"f%d" % i) for i in range(3)],
                 t.refreshes, t._snap.get(b"f3")))
    foreign.close()
    seen.append(("misses", t.get(b"nope"), t.get_many([b"nope2"]),
                 t.refreshes))
    seen.append(("views", sorted(t.items()), sorted(t.entry_stats()),
                 t.stat_entries([b"a", b"nope"])))
    with t.lock():
        with t.lock():
            t.put(b"locked", b"yes")
    seen.append(("locked", t.get(b"locked")))
    t.close()
    with open(os.path.join(root, mmap_mod.PACK_FILE), "rb") as f:
        seen.append(("pack", f.read()))
    return seen


@pytest.mark.parametrize("disk", ["sqlite", "dbm"])
def test_tier_behaviour_equals_reference(tmp_path, disk):
    got = {}
    for k, (_, cache_mod, mmap_mod) in PKGS.items():
        root = str(tmp_path / k)
        os.makedirs(root)
        got[k] = _drive(cache_mod, mmap_mod, root, disk)
    assert got["port"] == got["ref"]
    assert got["port"][4][4] == 5          # a delete hides the entry
    assert got["port"][6][2] == 3          # the third foreign find repacks


def _expander(core):
    return core.GenericTransformer(
        lambda inp: inp.assign(query=np.array(
            [q + "!" for q in inp["query"].tolist()], dtype=object)),
        "expander", key_columns=("qid", "query"), value_columns=("query",))


def test_storage_identity_relaxes_staleness_as_reference(tmp_path):
    """Warming with ``sqlite`` and serving with ``mmap:sqlite`` is not
    a backend mismatch; another disk store is, in both packages."""
    for k, (core, cache, _) in PKGS.items():
        d = str(tmp_path / k)
        topics = core.ColFrame({"qid": [f"q{i}" for i in range(6)],
                                "query": [f"terms {i}" for i in range(6)]})
        with cache.KeyValueCache(d, _expander(core), key=("qid", "query"),
                                 value=("query",), backend="sqlite") as kv:
            kv(topics)
        with cache.KeyValueCache(d, _expander(core), key=("qid", "query"),
                                 value=("query",),
                                 backend="mmap:sqlite") as kv2:
            assert kv2(topics)["query"].tolist() == \
                [f"terms {i}!" for i in range(6)]
            assert (kv2.stats.hits, kv2.stats.misses) == (6, 0)
        with pytest.raises(cache.StaleCacheError, match="backend"):
            cache.KeyValueCache(d, _expander(core), key=("qid", "query"),
                                value=("query",), backend="dbm")


@pytest.mark.parametrize("run_kw", [
    pytest.param({}, id="sequential"),
    pytest.param({"n_shards": 3, "max_workers": 3}, id="concurrent"),
])
def test_warm_plan_over_mmap_misses_nothing(tmp_path, monkeypatch, run_kw):
    """A plan warmed through ``sqlite`` and run again over
    ``mmap:sqlite`` misses nothing and prefetches nothing (the tier
    opts out of the data plane) in either package, with equal outputs
    and counts."""
    pin_round_trip(monkeypatch, 1e-5)
    passes = ["normalize", "cse", "pushdown", "cache-prune"]
    got = {}
    for k, (core, _, _) in PKGS.items():
        t = toy(core)
        pipes = pipeline_sets(t)["mixed"]
        rows = []
        for backend in ("sqlite", "mmap:sqlite", "mmap:sqlite"):
            with core.ExecutionPlan(pipes, cache_dir=str(tmp_path / k),
                                    cache_backend=backend,
                                    optimize=passes) as plan:
                outs, st = plan.run(t.queries(), **run_kw)
            rows.append((outs, (st.cache_hits, st.cache_misses,
                                st.cache_prefetched)))
        got[k] = rows
    for (touts, tst), (jouts, jst) in zip(got["port"], got["ref"]):
        assert tst == jst
        assert all(frames_equal(a, b) for a, b in zip(touts, jouts))
    cold, warm, again = (r[1] for r in got["port"])
    assert cold[0] == 0 and cold[1] > 0
    assert warm == again == (cold[1], 0, 0)
