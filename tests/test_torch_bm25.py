"""BM25 stage of repro_torch against the reference: identical rankings
per qid, including the boundary-tie rule ``with_cutoff`` relies on."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.ir as jir
import repro_torch.core as tcore
import repro_torch.ir as tir

torch.set_num_threads(1)


def _rows(frame):
    return frame.to_dicts()


@pytest.fixture(scope="module")
def corpus():
    return jir.msmarco_like(1, 0.05), tir.msmarco_like(1, 0.05)


@pytest.mark.parametrize("num_results", [5, 50, 1000])
def test_bm25_rankings_identical(corpus, num_results):
    jc, tc = corpus
    a = jir.InvertedIndex.build(jc.get_corpus_iter()).bm25(
        num_results=num_results)(jc.get_topics())
    b = tir.InvertedIndex.build(tc.get_corpus_iter()).bm25(
        num_results=num_results)(tc.get_topics())
    assert _rows(a) == _rows(b)


def _tied_corpus():
    # ten identical documents tie on every query term: any cutoff inside
    # the block falls on a tie
    docs = [{"docno": f"d{i}", "text": "alpha beta gamma"} for i in range(10)]
    docs += [{"docno": f"x{i}", "text": f"alpha filler{i} words here"}
             for i in range(6)]
    return docs, {"qid": ["q0", "q1"], "query": ["alpha beta", "gamma"]}


@pytest.mark.parametrize("k", [1, 3, 7, 12])
def test_bm25_with_cutoff_tied_boundary(k):
    docs, topics = _tied_corpus()
    out = []
    for ir, core in ((jir, jcore), (tir, tcore)):
        bm25 = ir.InvertedIndex.build(iter(docs)).bm25(num_results=16)
        fused = bm25.with_cutoff(k)(core.ColFrame(topics))
        cut = (bm25 % k)(core.ColFrame(topics))
        assert _rows(fused) == _rows(cut)       # top-k is a prefix of top-n
        out.append(_rows(fused))
    assert out[0] == out[1]


def test_text_loader_and_query_expander_identical(corpus):
    jc, tc = corpus
    j_ret = jir.InvertedIndex.build(jc.get_corpus_iter()).bm25(
        num_results=5)(jc.get_topics())
    t_ret = tir.InvertedIndex.build(tc.get_corpus_iter()).bm25(
        num_results=5)(tc.get_topics())
    assert _rows(jir.TextLoader(jc.text_map())(j_ret)) == \
        _rows(tir.TextLoader(tc.text_map())(t_ret))
    assert _rows(jir.QueryExpander(3)(jc.get_topics())) == \
        _rows(tir.QueryExpander(3)(tc.get_topics()))


def test_bm25_scores_float64_and_ranked(corpus):
    _, tc = corpus
    res = tir.InvertedIndex.build(tc.get_corpus_iter()).bm25(
        num_results=20)(tc.get_topics())
    assert res["score"].dtype == np.float64
    for _, idx in res.group_indices(["qid"]).items():
        assert np.all(np.diff(res["score"][idx]) <= 0)
        assert res["rank"][idx].tolist() == list(range(len(idx)))
