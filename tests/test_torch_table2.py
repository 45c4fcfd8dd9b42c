"""The paper's Table 2 (``benchmarks/table2_reproduction.py``) in both
packages: ``[bm25 % k >> text >> mono % 10 >> duo for k in (20, 50,
100, 200)]`` in its four settings — (1) no sharing, (2) prefix
precomputation, (3) + a cold ``ScorerCache`` around Mono, (4) + the same
cache hot — and (3′) and (4′), the same cold then hot through the
planner-inserted caches of ``Experiment(cache_dir=...)``, run by the
reference and by the port on the CPU from bridged weights.  Means and
per-query values agree within 1e-6, and the work counts (BM25 queries,
Mono and Duo pairs, cache hits and misses, plan nodes executed, node
cache directories) are equal."""
import os

import jax
import numpy as np
import pytest
import torch

import repro.caching as jcache
import repro.core as jcore
import repro.ir as jir
import repro.models.cross_encoder as jce
import repro_torch.caching as tcache
import repro_torch.core as tcore
import repro_torch.ir as tir
import repro_torch.models.cross_encoder as tce
from repro_torch.caching.provenance import set_digest_device
from _torch_parity import pin_round_trip
from repro_torch.kernels.cachekey_hash import cachekey_hash

torch.set_num_threads(1)
set_digest_device("cpu")

# A config name of its own: the reference's process-wide compile cache
# keys executables by (name, input shapes), not by weights.
SMALL = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab_size=2048,
             max_len=16)
CUTS = (20, 50, 100, 200)
MEASURES = ["nDCG@10", "MAP"]
NAMES = [f"k={k}" for k in CUTS]
# (3′) and (4′) are settings 5 and 6
SETTINGS = [(False, None), (True, None), (True, "cold"), (True, "hot"),
            (True, "dir-cold"), (True, "dir-hot")]


def _table2(pkg, corpus, cache_dir, plan_dir, params=None):
    """The four settings; returns per-setting (result, counts)."""
    core, caching, ir, ce = pkg
    bridged = params is not None
    kw = {"device": "cpu"} if bridged else {}
    cfg = ce.EncoderConfig(name="torch-parity-table2", **SMALL)
    index = ir.InvertedIndex.build(corpus.get_corpus_iter())
    tl = ir.TextLoader(corpus.text_map())
    # the first 20 of the 53 topics keep the file cheap on the CPU
    topics, qrels = corpus.get_topics().head(20), corpus.get_qrels()
    rows = []
    for pre, cached in SETTINGS:
        bm25 = index.bm25(num_results=max(CUTS))
        seen = [0]
        orig = bm25.transform

        def counting(inp, _orig=orig, _seen=seen):
            _seen[0] += len(inp)
            return _orig(inp)
        bm25.transform = counting
        mono = ce.MonoScorer(cfg, **kw, **({"params": params[0]}
                                           if bridged else {}))
        duo = ce.DuoScorer(cfg, max_docs=10, **kw,
                           **({"params": params[1]} if bridged else {}))
        cache = None if cached in (None, "dir-cold", "dir-hot") else \
            caching.ScorerCache(cache_dir, mono, backend="sqlite")
        stage = mono if cache is None else cache
        systems = [bm25 % k >> tl >> stage % 10 >> duo for k in CUTS]
        planned = {} if cache is not None or cached is None else {
            "precompute_mode": "plan", "cache_dir": plan_dir}
        res = core.Experiment(systems, topics, qrels, MEASURES,
                              precompute_prefix=pre, names=NAMES, **planned)
        stats = (cache.stats.hits, cache.stats.misses) if cache else None
        if cache is not None:
            cache.close()
        if planned:
            st = res.precompute
            stats = (st.cache_hits, st.cache_misses, st.nodes_executed,
                     sorted(os.listdir(plan_dir)))
        rows.append((res, {"bm25_queries": seen[0],
                           "mono_pairs": mono.invocations,
                           "duo_pairs": duo.invocations,
                           "cache": stats}))
        if not bridged:
            params = (jax.tree.map(np.asarray, mono.params),
                      jax.tree.map(np.asarray, duo.params))
    return rows, params


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        pin_round_trip(mp)
        return _both(tmp_path_factory)


def _both(tmp_path_factory):
    jc, tc = jir.msmarco_like(2, 0.02), tir.msmarco_like(2, 0.02)
    rd, pd = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    ref, params = _table2((jcore, jcache, jir, jce), jc, str(rd / "mono"),
                          str(rd / "plan"))
    before = cachekey_hash.launches
    got, _ = _table2((tcore, tcache, tir, tce), tc, str(pd / "mono"),
                     str(pd / "plan"), params)
    # on the CPU the digest runs the kernel's plain version, never the
    # kernel: the launch counter does not move
    assert cachekey_hash.launches == before
    return ref, got


@pytest.mark.parametrize("setting", [1, 2, 3, 4, 5, 6])
def test_means_and_per_query_equal_reference(both, setting):
    ref, got = both
    (rres, _), (tres, _) = ref[setting - 1], got[setting - 1]
    for n in NAMES:
        for m in MEASURES:
            assert tres.means[n][m] == pytest.approx(rres.means[n][m],
                                                     abs=1e-6)
            assert tres.per_query[n][m].keys() == \
                rres.per_query[n][m].keys()
            for qid, v in rres.per_query[n][m].items():
                assert tres.per_query[n][m][qid] == pytest.approx(v,
                                                                  abs=1e-6)


@pytest.mark.parametrize("setting", [1, 2, 3, 4, 5, 6])
def test_work_counts_equal_reference(both, setting):
    ref, got = both
    (rres, rc), (tres, tc) = ref[setting - 1], got[setting - 1]
    assert tc == rc
    if setting > 1:
        assert tres.precompute.nodes_executed == \
            rres.precompute.nodes_executed
        assert tres.precompute.prefix_len == rres.precompute.prefix_len == 1


def test_the_papers_claims_hold_in_the_port(both):
    _, got = both
    counts = [c for _, c in got]
    assert all(c["bm25_queries"] < counts[0]["bm25_queries"]
               for c in counts[1:])
    assert counts[3]["mono_pairs"] == 0
    assert counts[3]["cache"][1] == 0
    assert counts[2]["mono_pairs"] <= counts[1]["mono_pairs"]
    # through cache_dir the hot run skips BM25 and Mono entirely; Duo is
    # cacheable=False (paper §5), so it scores as many pairs as cold
    cold, hot = counts[4], counts[5]
    assert hot["bm25_queries"] == hot["mono_pairs"] == 0
    assert cold["mono_pairs"] == counts[1]["mono_pairs"]
    assert hot["duo_pairs"] == cold["duo_pairs"] > 0
    assert hot["cache"][1] == 0 and hot["cache"][0] == cold["cache"][1]
    assert hot["cache"][3] == cold["cache"][3]     # the same directories
    base = got[0][0].means
    for res, _ in got[1:]:
        for n in NAMES:
            for m in MEASURES:
                assert abs(res.means[n][m] - base[n][m]) <= 1e-6
