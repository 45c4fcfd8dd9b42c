"""Cache parity: the port's key digests, value codecs, storage
backends, eviction and ``ScorerCache`` are byte-compatible with the
reference (``repro.caching``): a store written by either package is
served by the other."""
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import repro.caching as jcache
import repro.caching.codecs as jcodecs
import repro.caching.economics as jecon
import repro.core as jcore
import repro_torch.caching as tcache
import repro_torch.caching.codecs as tcodecs
import repro_torch.caching.economics as tecon
import repro_torch.core as tcore
from repro_torch.caching.provenance import set_digest_device
from _torch_parity import toy

torch.set_num_threads(1)
set_digest_device("cpu")

COLUMNS = {
    "str": np.array(["alpha", "béta", "", "a\x00b", "x" * 300],
                    dtype=object),
    "int": np.array([0, -1, 2**62, 7, 3], dtype=np.int64),
    "float": np.array([0.0, -0.0, 1.5, np.inf, 1e-300]),
    "mixed": np.array(["s", 3, (1, "t"), None, b"by"], dtype=object),
    "unicode": np.array(["ünï", "日本", "🙂", "q", "qq"], dtype=object),
}


@pytest.mark.parametrize("names", [("str",), ("int",), ("float",),
                                   ("mixed",), ("unicode",),
                                   ("str", "int", "float")])
def test_keys_byte_identical_to_reference(names):
    cols = [COLUMNS[n] for n in names]
    keys = tcodecs.vector_keys(cols)
    assert keys == jcodecs.vector_keys(cols)
    kinds = [c.dtype.kind for c in cols]
    for i, k in enumerate(keys):
        row = [c[i] for c in cols]
        assert tcodecs.scalar_key(row, kinds) == k == \
            jcodecs.scalar_key(row, kinds)


def test_kv_codec_blobs_equal_and_round_trip():
    for vals in [(1.5,), (0.25, -3.0), ("text",), (1, "a", None), ()]:
        blob = tcodecs.encode_kv_value(vals)
        assert blob == jcodecs.encode_kv_value(vals)
        assert tcodecs.decode_kv_value(blob) == jcodecs.decode_kv_value(blob)
        assert tcodecs.decode_kv_value(blob) == tuple(vals)
    blobs = [tcodecs.encode_kv_value((float(i), -float(i)))
             for i in range(5)]
    np.testing.assert_array_equal(tcodecs.decode_kv_batch(blobs, 2),
                                  jcodecs.decode_kv_batch(blobs, 2))
    assert tcodecs.decode_kv_batch(blobs + [b"\x01x"], 2) is None


def test_columnar_codec_blobs_equal_and_round_trip():
    cols = [("qid", np.array(["q1", "q2", "q3"], dtype=object)),
            ("docno", np.array(["d1", "dé", ""], dtype=object)),
            ("score", np.array([1.5, -0.0, 2.0 ** -40])),
            ("rank", np.array([0, 1, 2], dtype=np.int64)),
            ("feat", np.array([(1, 2), None, "x"], dtype=object))]
    blob = tcodecs.encode_columnar_frame(cols, 3)
    assert blob == jcodecs.encode_columnar_frame(cols, 3)
    out = tcodecs.decode_columnar_frame(blob)
    ref = jcodecs.decode_columnar_frame(blob)
    for name, arr in cols:
        assert out[name].tolist() == arr.tolist() == ref[name].tolist()
        assert out[name].dtype == ref[name].dtype


@pytest.mark.parametrize("backend", ["pickle", "dbm", "sqlite"])
def test_backend_stores_cross_package(tmp_path, backend):
    items = [(b"k%03d" % i, os.urandom(1 + i)) for i in range(40)]
    for write, read in ((tcache, jcache), (jcache, tcache)):
        d = str(tmp_path / f"{backend}-{write.__name__}")
        b = write.open_backend(backend, d)
        b.put_many(items[:30])
        b.put(b"solo", b"v")
        b.close()
        r = read.open_backend(backend, d)
        assert r.get_many([k for k, _ in items]) == \
            [v for _, v in items[:30]] + [None] * 10
        assert r.get(b"solo") == b"v" and len(r) == 31
        assert r.delete_many([b"k000", b"zz"]) == 1 and len(r) == 30
        r.close()
        assert tcache.backend_store_exists(backend, d) == \
            jcache.backend_store_exists(backend, d) is True


def test_memory_backend_and_registry_match_reference(tmp_path):
    b = tcache.open_backend("memory", None)
    b.put_many([(b"a", b"1"), (b"b", b"2")])
    assert b.get_many([b"a", b"c"]) == [b"1", None] and len(b) == 2
    assert tcache.registered_selectors() == jcache.registered_selectors()
    for sel in ("sqlite", None, "tiered", "mmap:dbm", "tiered:pickle"):
        assert tcache.select_backend(sel) == jcache.select_backend(sel)
        assert tcache.storage_identity(sel) == jcache.storage_identity(sel)
    for bad in ("nope", "mmap:pickle", "tiered:memory"):
        with pytest.raises(ValueError):
            tcache.select_backend(bad)
    # the tiered selector opens the reference's TieredBackend layout;
    # the mmap tier is not ported yet
    for sel in ("tiered", "tiered:sqlite", "tiered:pickle"):
        opened = [m.open_backend(sel, str(tmp_path / f"{m.__name__}{sel}"))
                  for m in (tcache, jcache)]
        kinds = [(type(o).__name__, o.name, type(o.disk).__name__)
                 for o in opened]
        assert kinds[0] == kinds[1] and kinds[0][0] == "TieredBackend"
        for o in opened:
            o.close()
    with pytest.raises(NotImplementedError, match="tiers-and-data-plane"):
        tcache.open_backend("mmap:sqlite", str(tmp_path / "mmap"))
    assert tcache.measure_round_trip("memory") > 0
    assert tcache.measure_round_trip("tiered:sqlite") > 0


def test_file_lock_is_exclusive(tmp_path):
    path = str(tmp_path / "lock")
    inside, peak = [0], [0]

    def worker():
        for _ in range(20):
            with tcache.FileLock(path):
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
                time.sleep(0.0005)
                inside[0] -= 1

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert peak[0] == 1


def _evicted(econ, cache_mod, d, budget, now):
    b = cache_mod.open_backend("sqlite", d)
    try:
        report = econ.evict_entries(b, d, budget, created_at=1000.0,
                                    now=now)
        return report, sorted(k for k, _ in b.items())
    finally:
        b.close()


@pytest.mark.parametrize("budget", [{"max_entries": 6},
                                    {"ttl_seconds": 50.0},
                                    {"max_bytes": 200},
                                    {"max_entries": 8, "ttl_seconds": 30.0}])
def test_eviction_order_equals_reference(tmp_path, budget):
    src = str(tmp_path / "src")
    b = tcache.open_backend("sqlite", src)
    keys = [b"e%02d" % i for i in range(12)]
    b.put_many((k, b"v" * (10 + 3 * i)) for i, k in enumerate(keys))
    b.close()
    stats = tecon.AccessStats()
    stats.merge_pending({k: [1000.0 + 10.0 * ((i * 7) % 12), i % 3 + 1]
                         for i, k in enumerate(keys[:10])})
    stats.save(src)
    out = {}
    for name, econ, mod in (("port", tecon, tcache),
                            ("ref", jecon, jcache)):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        out[name] = _evicted(econ, mod, d, tcache.CacheBudget.coerce(budget)
                             if name == "port"
                             else jcache.CacheBudget.coerce(budget),
                             now=1100.0)
    assert out["port"] == out["ref"]
    assert out["port"][0]["evicted"] > 0


def _scorer(core):
    t = toy(core)
    return t.docno_scorer("ce", mult=0.5)


def _candidates(core):
    t = toy(core)
    return (t.retriever("r1", n=5) % 4)(t.queries())


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_scorer_cache_directory_served_across_packages(tmp_path, direction):
    fill, serve = (jcache, jcore), (tcache, tcore)
    if direction == "port->reference":
        fill, serve = serve, fill
    d = str(tmp_path / "mono")
    with fill[0].ScorerCache(d, _scorer(fill[1]), backend="sqlite") as c:
        filled = c(_candidates(fill[1]))
        assert c.stats.misses == len(filled) == 12
    # no transformer: a single miss would raise CacheMissError
    with serve[0].ScorerCache(d, None, backend="sqlite") as c:
        served = c(_candidates(serve[1]))
        assert (c.stats.hits, c.stats.misses) == (12, 0)
    a = filled.sort_values(["qid", "docno"])
    b = served.sort_values(["qid", "docno"])
    assert a["docno"].tolist() == b["docno"].tolist()
    assert np.array_equal(np.asarray(a["score"], dtype=np.float64),
                          np.asarray(b["score"], dtype=np.float64))
    assert a["rank"].tolist() == b["rank"].tolist()
    m = jcache.CacheManifest.load(d)
    assert m.codec == "kv-fnv128-pack1" and m.entry_count == 12


def test_scorer_cache_counts_and_budget(tmp_path):
    d = str(tmp_path / "b")
    scorer = _scorer(tcore)
    with tcache.ScorerCache(d, scorer, budget=5) as c:
        c(_candidates(tcore))
        c(_candidates(tcore))
        out, hits, misses = c.call_with_counts(_candidates(tcore))
        assert (hits, misses) == (12, 0) and scorer.calls == 1
        assert c.stats.hits == 24 and c.stats.inserts == 12
    assert len(tcache.KeyValueCache(d, None, key=("query", "docno"),
                                    value=("score",))) == 5
    assert tecon.enforce_dir(d, 3)["entries_after"] == 3
    with pytest.raises(tcache.CacheMissError):
        with tcache.ScorerCache(str(tmp_path / "empty"), None) as c:
            c(_candidates(tcore))
