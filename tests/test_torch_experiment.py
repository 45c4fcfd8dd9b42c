"""The slice as a whole: the Table 2 retrieve-and-rerank Experiment with
BM25 and dense retrieval, run by repro_torch on the CPU from bridged
weights, against ``repro.core.Experiment(precompute_prefix=False)``.
Means and per-query values agree within 1e-6."""
import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.ir as jir
import repro.models.cross_encoder as jce
import repro_torch.core as tcore
import repro_torch.ir as tir
import repro_torch.models.cross_encoder as tce
from repro_torch.caching.provenance import set_digest_device
from _torch_parity import pin_round_trip

torch.set_num_threads(1)
set_digest_device("cpu")

# A config name of its own: the reference's process-wide compile cache
# keys executables by (name, input shapes), not by weights, so another
# test's scorer of the same name and shapes would lend it its weights.
SMALL = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab_size=2048,
             max_len=16)
CUTS = (20, 50, 100, 200)
MEASURES = ["nDCG@10", "MAP"]
NAMES = [f"bm25%{k}" for k in CUTS] + ["dense%200", "bm25|dense"]


def _systems(ir, ce, corpus, params=None):
    """The slice's systems; ``params`` (the reference's numpy weights)
    makes the port's models compute from the reference's weights."""
    def kw(name):
        return {} if params is None else {"params": params[name],
                                          "device": "cpu"}

    index = ir.InvertedIndex.build(corpus.get_corpus_iter())
    tl = ir.TextLoader(corpus.text_map())
    enc = ir.DenseEncoder(
        ce.EncoderConfig(name="torch-parity-exp-dense", **SMALL), seed=7,
        **kw("dense"))
    dense_index = ir.DenseIndex(enc).index(corpus.get_corpus_iter())
    cfg = ce.EncoderConfig(name="torch-parity-exp", **SMALL)
    mono = ce.MonoScorer(cfg, **kw("mono"))
    duo = ce.DuoScorer(cfg, max_docs=10, **kw("duo"))
    bm25 = index.bm25(num_results=200)
    # the reference's kernel backend, counterpart of the port's default
    dense = dense_index.retriever(
        200, **({"backend": "pallas"} if params is None else {}))
    systems = ([bm25 % k >> tl >> mono % 10 >> duo for k in CUTS]
               + [dense % 200 >> tl >> mono % 10 >> duo,
                  (bm25 % 100 | dense % 100) >> tl >> mono % 10 >> duo])
    return systems, (enc, mono, duo)


@pytest.fixture(scope="module")
def both():
    jc, tc = jir.msmarco_like(2, 0.02), tir.msmarco_like(2, 0.02)
    jsys, (jenc, jmono, jduo) = _systems(jir, jce, jc)
    ref = jcore.Experiment(jsys, jc.get_topics(), jc.get_qrels(), MEASURES,
                           names=NAMES, precompute_prefix=False, baseline=0)
    params = {name: jax.tree.map(np.asarray, m.params)
              for name, m in (("dense", jenc), ("mono", jmono),
                              ("duo", jduo))}
    tsys, (_, tmono, tduo) = _systems(tir, tce, tc, params)
    got = tcore.Experiment(tsys, tc.get_topics(), tc.get_qrels(), MEASURES,
                           names=NAMES, baseline=0)
    counts = ((jmono.invocations, jduo.invocations),
              (tmono.invocations, tduo.invocations))
    return ref, got, counts, tsys, tc, jsys, jc


@pytest.mark.parametrize("name", NAMES)
def test_means_and_per_query_equal_reference(both, name):
    ref, got, _, _, _, _, _ = both
    for m in MEASURES:
        assert got.means[name][m] == pytest.approx(ref.means[name][m],
                                                   abs=1e-6)
        assert got.per_query[name][m].keys() == ref.per_query[name][m].keys()
        for qid, v in ref.per_query[name][m].items():
            assert got.per_query[name][m][qid] == pytest.approx(v, abs=1e-6)


def test_pair_counts_and_significance_equal_reference(both):
    ref, got, (jcounts, tcounts), _, _, _, _ = both
    assert jcounts == tcounts
    for n in NAMES[1:]:
        for m in MEASURES:
            assert got.pvalues[n][m] == pytest.approx(ref.pvalues[n][m],
                                                      abs=1e-9)
            assert got.corrected_pvalues[n][m] == pytest.approx(
                ref.corrected_pvalues[n][m], abs=1e-9)


def test_precompute_prefix_raises_for_several_systems(both, tmp_path,
                                                     monkeypatch):
    """Prefix precomputation over several systems runs through the plan
    compiler with the unshared results, and with planner-inserted caches
    (``cache_dir=``, once a refusal: the name is kept) cold then hot it
    gives the reference's means and cache counts; the hot run misses
    nothing."""
    _, got, _, tsys, tc, jsys, jc = both
    res = tcore.Experiment(tsys[:2], tc.get_topics(), tc.get_qrels(),
                           MEASURES, names=NAMES[:2], precompute_prefix=True)
    assert res.precompute.nodes_executed < res.precompute.nodes_total
    for n in NAMES[:2]:
        assert res.means[n] == pytest.approx(got.means[n], abs=1e-12)
    pin_round_trip(monkeypatch)
    runs = {}
    for name, core, systems, corpus in (("port", tcore, tsys, tc),
                                        ("ref", jcore, jsys, jc)):
        runs[name] = []
        for _ in ("cold", "hot"):
            r = core.Experiment(systems[:2], corpus.get_topics(),
                                corpus.get_qrels(), MEASURES,
                                names=NAMES[:2], precompute_prefix=True,
                                precompute_mode="plan",
                                cache_dir=str(tmp_path / name))
            runs[name].append((r.means, r.precompute.cache_hits,
                               r.precompute.cache_misses,
                               r.precompute.nodes_executed))
    for (tm, *tcounts), (jm, *jcounts) in zip(runs["port"], runs["ref"]):
        assert tcounts == jcounts
        for n in NAMES[:2]:
            for m in MEASURES:
                assert tm[n][m] == pytest.approx(jm[n][m], abs=1e-6)
                assert tm[n][m] == pytest.approx(got.means[n][m], abs=1e-12)
    (_, cold_hits, cold_misses, _), (_, hot_hits, hot_misses, _) = \
        runs["port"]
    assert cold_hits == 0 and hot_misses == 0 and hot_hits == cold_misses


def test_batch_size_and_single_system_precompute(both):
    _, got, _, tsys, tc, _, _ = both
    res = tcore.Experiment(tsys[:1], tc.get_topics(), tc.get_qrels(),
                           MEASURES, names=NAMES[:1], precompute_prefix=True,
                           batch_size=16)
    assert res.means[NAMES[0]] == pytest.approx(got.means[NAMES[0]], abs=1e-12)
