"""The explicit cache families of the port (``RetrieverCache``,
``DenseScorerCache``, ``IndexerCache``, ``Lazy``, the Artifact hub and
the ``tiered`` backend) against the reference's (``repro.caching``):
equal results and counts on the same inputs (mirrors
tests/test_caching.py, test_tiered.py and test_artifact_lazy.py), and
each family's directory filled by one package and served by the other
with no transformer (``fingerprint=None``), byte for byte."""
import json
import os

import numpy as np
import pytest
import torch

import repro.caching as jcache
import repro.core as jcore
import repro.ir as jir
import repro_torch.caching as tcache
import repro_torch.core as tcore
import repro_torch.ir as tir
from repro_torch.caching.provenance import set_digest_device
from _torch_parity import frames_equal

torch.set_num_threads(1)
set_digest_device("cpu")

COLS = ["qid", "docno", "score", "rank"]
PKGS = {"ref": (jcore, jcache, jir), "port": (tcore, tcache, tir)}
DIRECTIONS = ["reference->port", "port->reference"]


def counting_scorer(core):
    """A pointwise scorer of (query, docno) that counts the rows it
    scores (tests/test_caching.py's ``CountingScorer``)."""
    class CountingScorer(core.GenericTransformer):
        def __init__(self):
            self.calls = 0

            def fn(inp):
                self.calls += len(inp)
                s = np.array([float(len(str(d)) % 7) + float(str(q)[-1] == "1")
                              for q, d in zip(inp["query"].tolist(),
                                              inp["docno"].tolist())])
                return inp.assign(score=s)
            super().__init__(fn, "counting_scorer",
                             key_columns=("query", "docno"),
                             value_columns=("score",))
    return CountingScorer()


@pytest.fixture(scope="module")
def world():
    """Per package: corpus, BM25 index, topics and a BM25 result frame."""
    out = {}
    for name, (core, caching, ir) in PKGS.items():
        corpus = ir.msmarco_like(1, scale=0.04)
        index = ir.InvertedIndex.build(corpus.get_corpus_iter())
        topics = corpus.get_topics()
        out[name] = dict(core=core, caching=caching, ir=ir, corpus=corpus,
                         index=index, topics=topics,
                         results=index.bm25(num_results=20)(topics))
    return out


def _both(world, fn):
    return {name: fn(**w) for name, w in world.items()}


# -- RetrieverCache ----------------------------------------------------------

def test_retriever_cache_round_trip_and_partial_hits(world):
    def run(core, caching, index, topics, **_):
        bm25 = index.bm25(num_results=15)
        with caching.RetrieverCache(None, bm25) as rc:
            cold, hot = rc(topics), rc(topics)
            direct = bm25(topics)
            assert frames_equal(cold, direct) and frames_equal(hot, direct)
            counts = (rc.stats.hits, rc.stats.misses, rc.stats.inserts)
        with caching.RetrieverCache(None, index.bm25(num_results=5)) as rc:
            rc(topics.head(3))
            rc(topics)
            counts += (rc.stats.hits, rc.stats.misses, len(rc))
        return hot, counts
    got = _both(world, run)
    assert got["port"][1] == got["ref"][1]
    n = len(world["port"]["topics"])
    assert got["port"][1] == (n, n, n, 3, n, n)
    assert frames_equal(got["port"][0], got["ref"][0])


def test_serve_from_store_equals_reference(world):
    def run(core, caching, index, topics, **_):
        with caching.RetrieverCache(None, index.bm25(num_results=8)) as rc:
            assert rc.serve_from_store(topics) is None     # cold: a miss
            rc(topics.head(4))
            assert rc.serve_from_store(topics) is None     # partly warm
            served = rc.serve_from_store(topics.head(4))
            keyless = core.ColFrame({"qid": topics["qid"][:4].tolist()})
            assert rc.serve_from_store(keyless) is None
            return served, (rc.stats.hits, rc.stats.misses)
    got = _both(world, run)
    assert got["port"][1] == got["ref"][1] == (4, 4)
    assert frames_equal(got["port"][0], got["ref"][0])


# -- DenseScorerCache --------------------------------------------------------

def test_dense_scorer_cache_equals_sqlite_scorer_cache(world):
    def run(core, caching, corpus, results, **_):
        s1, s2 = counting_scorer(core), counting_scorer(core)
        docnos = corpus.docs["docno"].tolist()
        with caching.ScorerCache(None, s1) as sc, \
                caching.DenseScorerCache(None, s2, docnos=docnos) as dc:
            a, b = sc(results), dc(results)
            assert a.equals(b, cols=COLS)
            b2 = dc(results)
            assert s2.calls == len(results) and b2.equals(b)
            counts = (dc.stats.hits, dc.stats.misses, dc.stats.inserts,
                      len(dc))
        with caching.DenseScorerCache(None, counting_scorer(core),
                                      docnos=docnos) as dc:
            dc.GROW = 2
            dc(results)                  # more than 2 queries: growth
            counts += (len(dc._query_rows), dc._mat.shape[0])
        return b, counts
    got = _both(world, run)
    assert got["port"][1] == got["ref"][1]
    assert frames_equal(got["port"][0], got["ref"][0])


def test_dense_scorer_cache_eviction_equals_reference(world, tmp_path):
    def run(core, caching, corpus, results, **_):
        d = str(tmp_path / caching.__name__)
        with caching.DenseScorerCache(d, counting_scorer(core),
                                      docnos=corpus.docs["docno"].tolist()
                                      ) as dc:
            dc(results)
            report = dc.evict({"max_entries": 30}, now=1e12)
            return ({k: v for k, v in report.items()},
                    sorted(dc._query_rows), len(dc))
    got = _both(world, run)
    assert got["port"] == got["ref"]
    assert got["port"][0]["evicted"] > 0


# -- IndexerCache ------------------------------------------------------------

def test_indexer_cache_order_and_text_loading(world):
    def run(core, caching, ir, corpus, **_):
        with caching.IndexerCache(None) as ic:
            ic.index(corpus.get_corpus_iter())
            replay = list(ic)
            orig = list(corpus.get_corpus_iter())
            assert [r["docno"] for r in replay] == \
                [r["docno"] for r in orig]
            assert ic.get(orig[7]["docno"])["text"] == orig[7]["text"]
            assert ir.InvertedIndex.build(ic).n_docs == len(orig)
            frame = core.ColFrame({"qid": ["q", "q"], "docno": [
                orig[0]["docno"], orig[3]["docno"]]})
            loaded = ic(frame)
            return replay, loaded["text"].tolist(), len(ic)
    got = _both(world, run)
    assert got["port"] == got["ref"]


# -- Lazy ----------------------------------------------------------------------

def test_lazy_constructs_once_and_never_on_a_full_hit(world, tmp_path):
    def run(core, caching, results, **_):
        built = []
        lazy = caching.Lazy(lambda: (built.append(1),
                                     counting_scorer(core))[1],
                            name="lazy_scorer")
        d = str(tmp_path / caching.__name__)
        with caching.ScorerCache(d, lazy) as sc:
            assert not lazy.constructed
            sc(results)
            sc(results)
            first = (len(built), lazy.construction_count, sc.stats.hits)
        cold = caching.Lazy(lambda: (built.append(2),
                                     counting_scorer(core))[1])
        with caching.ScorerCache(d, cold) as sc:
            out = sc(results)            # hot: the model is never built
            assert not cold.constructed
        return first + (built, cold.signature()), out
    got = _both(world, run)
    assert got["port"][0] == got["ref"][0]
    assert got["port"][0][:2] == (1, 1) and got["port"][0][3] == [1]
    assert frames_equal(got["port"][1], got["ref"][1])


# -- Artifact hub ----------------------------------------------------------------

@pytest.mark.parametrize("direction", DIRECTIONS)
def test_hub_round_trip_across_packages(world, tmp_path, monkeypatch,
                                        direction):
    monkeypatch.setenv("REPRO_HUB", str(tmp_path / "hub"))
    push, pull = ("ref", "port") if direction == DIRECTIONS[0] \
        else ("port", "ref")
    w = world[push]
    with w["caching"].ScorerCache(None, counting_scorer(w["core"])) as sc:
        sc(w["results"])
        dest = sc.to_hf("grp/scores")
    assert w["caching"].hub_dir() == str(tmp_path / "hub")
    meta = json.load(open(os.path.join(dest, "metadata.json")))
    assert meta["artifact_type"] == "ScorerCache"
    w = world[pull]
    local = w["caching"].from_hub("grp/scores")
    fresh = counting_scorer(w["core"])
    with w["caching"].ScorerCache(local, fresh) as sc2:
        sc2(w["results"])
        assert fresh.calls == 0 and sc2.stats.hit_rate == 1.0
    via = w["caching"].Artifact.from_hf("grp/scores",
                                        w["caching"].ScorerCache)
    assert len(via) == len(w["results"])
    via.close()
    with pytest.raises(FileNotFoundError):
        w["caching"].from_hub("grp/missing")


def test_every_family_has_the_artifact_methods():
    for name in ("KeyValueCache", "ScorerCache", "DenseScorerCache",
                 "RetrieverCache", "IndexerCache"):
        cls = getattr(tcache, name)
        assert callable(cls.to_hf) and callable(cls.to_zenodo)


# -- tiered backend ----------------------------------------------------------------

def test_tiered_backend_equals_bare_disk(tmp_path):
    items = [(b"k%02d" % i, b"v" * (i + 1)) for i in range(20)]
    views = {}
    for name, caching in (("port", tcache), ("ref", jcache)):
        b = caching.open_backend("tiered:sqlite", str(tmp_path / name))
        assert type(b).__name__ == "TieredBackend"
        assert b.name == "tiered:sqlite"
        b.put_many(items[:12])
        assert len(b.front) == 12            # write-through
        b.front.delete_many([k for k, _ in items[:12]])
        assert b.get(b"k03") == items[3][1] and len(b.front) == 1  # promote
        got = b.get_many([b"k01", b"zz", b"k01"])
        with b.lock():
            b.put_many(items[12:])           # nested put under the lock
        assert b.delete_many([b"k00", b"nope"]) == 1
        views[name] = (got, len(b), sorted(b.items()),
                       [k for k, _ in sorted(b.entry_stats())])
        b.close()
        bare = caching.open_backend("sqlite", str(tmp_path / name))
        assert sorted(bare.items()) == views[name][2]
        bare.close()
    assert views["port"] == views["ref"]
    assert views["port"][0] == [items[1][1], None, items[1][1]]


# -- one package fills, the other serves -------------------------------------------

def _fill_and_serve(family, fill, serve, d):
    """Fill ``d`` with ``family`` in package ``fill``, serve it from
    package ``serve`` with no transformer; returns (filled, served,
    serve-side (hits, misses))."""
    if family == "retriever":
        with fill["caching"].RetrieverCache(
                d, fill["index"].bm25(num_results=12)) as c:
            filled = c(fill["topics"])
        with serve["caching"].RetrieverCache(d, None) as c:
            served = c(serve["topics"])
            return filled, served, (c.stats.hits, c.stats.misses)
    if family == "dense":
        docnos = fill["corpus"].docs["docno"].tolist()
        with fill["caching"].DenseScorerCache(
                d, counting_scorer(fill["core"]), docnos=docnos) as c:
            filled = c(fill["results"])
        with serve["caching"].DenseScorerCache(d, None) as c:
            served = c(serve["results"])
            return filled, served, (c.stats.hits, c.stats.misses)
    if family == "indexer":
        with fill["caching"].IndexerCache(d) as c:
            c.index(fill["corpus"].get_corpus_iter())
        frame = fill["results"].head(30)
        filled = fill["corpus"].text_map()
        with serve["caching"].IndexerCache(d) as c:
            rows = list(c)
            served = c(serve["results"].head(30))
            assert [r["docno"] for r in rows] == \
                list(serve["corpus"].docs["docno"].tolist())
            return ([filled[x] for x in frame["docno"].tolist()],
                    served["text"].tolist(), (c.stats.hits, 0))
    # a key-value cache over the tiered backend
    qe = fill["ir"].QueryExpander(2)
    with fill["caching"].KeyValueCache(d, qe, key=("qid", "query"),
                                       value=("query",),
                                       backend="tiered:sqlite") as c:
        filled = c(fill["topics"])
    with serve["caching"].KeyValueCache(d, None, key=("qid", "query"),
                                        value=("query",),
                                        backend="tiered:sqlite") as c:
        served = c(serve["topics"])
        return filled, served, (c.stats.hits, c.stats.misses)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("family", ["retriever", "dense", "indexer",
                                    "tiered-kv"])
def test_directory_served_across_packages(world, tmp_path, family,
                                          direction):
    fill, serve = (world["ref"], world["port"]) \
        if direction == DIRECTIONS[0] else (world["port"], world["ref"])
    d = str(tmp_path / family)
    filled, served, (hits, misses) = _fill_and_serve(family, fill, serve, d)
    assert misses == 0 and hits > 0
    if family == "indexer":
        assert filled == served
    else:
        assert frames_equal(filled, served)
    if family == "tiered-kv":
        assert filled["query"].tolist() == served["query"].tolist()
    m = jcache.CacheManifest.load(d)
    assert m.family == {"retriever": "RetrieverCache",
                        "dense": "DenseScorerCache",
                        "indexer": "IndexerCache",
                        "tiered-kv": "KeyValueCache"}[family]


@pytest.mark.parametrize("family", ["retriever", "dense", "tiered-kv"])
def test_stores_byte_identical_to_reference(world, tmp_path, family):
    """The same inputs through each package's family leave the same
    keys, blobs, sidecars and manifest fields."""
    dirs = {}
    for name, w in world.items():
        d = str(tmp_path / name)
        _fill_and_serve(family, w, w, d)
        dirs[name] = d
    manifests = [jcache.CacheManifest.load(dirs[n]) for n in ("port", "ref")]
    for f in ("family", "codec", "backend", "key_columns", "value_columns",
              "entry_count"):
        assert getattr(manifests[0], f) == getattr(manifests[1], f), f
    if family == "dense":
        mats = [np.load(os.path.join(dirs[n], "scores.npy"))
                for n in ("port", "ref")]
        assert mats[0].dtype == mats[1].dtype == np.float32
        assert np.array_equal(mats[0], mats[1], equal_nan=True)
        for side in ("npids.json", "queries.json"):
            a, b = [json.load(open(os.path.join(dirs[n], side)))
                    for n in ("port", "ref")]
            assert a == b
        return
    stores = []
    for n in ("port", "ref"):
        b = jcache.open_backend(manifests[0].backend, dirs[n])
        stores.append(sorted(b.items()))
        b.close()
    assert stores[0] == stores[1] and len(stores[0]) > 0


@pytest.mark.parametrize("family", ["retriever", "dense"])
def test_offline_eviction_opens_the_family_like_reference(world, tmp_path,
                                                          family):
    reports = {}
    for name, w in world.items():
        d = str(tmp_path / name)
        _fill_and_serve(family, w, w, d)
        econ = {"port": tcache, "ref": jcache}[name]
        reports[name] = econ.enforce_dir(d, {"max_entries": 20}, now=1e12)
    assert reports["port"] == reports["ref"]
    assert reports["port"]["evicted"] > 0
