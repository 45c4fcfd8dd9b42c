"""bm25_block of repro_torch: the port's op on the CPU (its plain
version) against the reference's op (the Pallas kernel in interpret
mode) on the same numpy-seeded inputs — the reference's sweep,
unaligned T and D, repeated terms, degenerate k1 and b — the cross-check
against the port's ``BM25Retriever.score_query`` and the reference's,
and dispatch by device.  The CUDA kernel itself is tested on the card
by ``test_torch_bm25_block_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ir as jir
import repro_torch.ir as tir
from repro.kernels.bm25_block import bm25_block_op as j_op
from repro_torch.kernels.bm25_block import (bm25_block, bm25_block_op,
                                            bm25_block_ref)

torch.set_num_threads(1)

SWEEP = [(8, 128), (20, 150), (64, 512), (5, 40),   # the reference's sweep
         (1, 1), (3, 1000), (9, 129)]


def _inputs(T, D, seed, rate=0.3):
    rng = np.random.default_rng(seed)
    return (rng.poisson(rate, (T, D)).astype(np.float32),
            (rng.random(T) * 5).astype(np.float32),
            rng.integers(20, 100, D).astype(np.float32))


def _both(tf, idf, dl, **kw):
    want = np.asarray(j_op(jnp.asarray(tf), jnp.asarray(idf),
                           jnp.asarray(dl), interpret=True, **kw))
    got = bm25_block_op(torch.from_numpy(tf), torch.from_numpy(idf),
                        torch.from_numpy(dl), **kw)
    assert got.dtype == torch.float32 and got.shape == (tf.shape[1],)
    return got.numpy(), want


@pytest.mark.parametrize("T,D", SWEEP)
def test_op_matches_reference_op(T, D):
    got, want = _both(*_inputs(T, D, T * 31 + D), avg_dl=55.0)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("k1,b", [(0.0, 0.75), (1.2, 1.0), (2.0, 0.0)])
def test_degenerate_parameters_give_no_nan(k1, b):
    tf, idf, dl = _inputs(6, 50, 8)
    dl[:10] = 0.0                       # with b = 1: dl_norm = 0
    got, want = _both(tf, idf, dl, k1=k1, b=b, avg_dl=40.0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _tile(index, query):
    """One row per query term found in the index, repeated terms kept
    (the host loop adds them twice); columns are all docs."""
    terms = [t for t in index.tokenizer.tokenize(query) if t in index.postings]
    tf = np.zeros((len(terms), index.n_docs), np.float32)
    for ti, t in enumerate(terms):
        ids, tfs = index.postings[t]
        tf[ti, ids] = tfs
    return tf, np.array([index.idf(t) for t in terms], np.float32)


@pytest.fixture(scope="module")
def indexes():
    jc, tc = jir.msmarco_like(1, scale=0.02), tir.msmarco_like(1, scale=0.02)
    return (jir.InvertedIndex.build(jc.get_corpus_iter()),
            tir.InvertedIndex.build(tc.get_corpus_iter()),
            list(tc.get_topics()["query"]))


def test_matches_score_query_of_both_packages(indexes):
    """Every query of msmarco_like(1, 0.02), plus one that repeats a
    term: the port's op on the port's index equals its BM25Retriever's
    scores at the returned ids, the reference's op and the reference's
    retriever."""
    j_index, t_index, queries = indexes
    jb, tb = j_index.bm25(num_results=30), t_index.bm25(num_results=30)
    term = next(iter(t_index.postings))
    for query in queries + [f"{queries[0]} {term} {term}"]:
        tf, idf = _tile(t_index, query)
        j_tf, j_idf = _tile(j_index, query)
        np.testing.assert_array_equal(tf, j_tf)
        np.testing.assert_array_equal(idf, j_idf)
        got, want = _both(tf, idf, t_index.doc_len, k1=tb.k1, b=tb.b,
                          avg_dl=t_index.avg_dl)
        np.testing.assert_allclose(got, want, atol=1e-4)
        ids, scores = tb.score_query(query)
        j_ids, j_scores = jb.score_query(query)
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_allclose(got[ids], scores, rtol=1e-4)
        np.testing.assert_allclose(want[j_ids], j_scores, rtol=1e-4)


def test_no_terms_scores_zero():
    got = bm25_block_op(torch.zeros(0, 7), torch.zeros(0), torch.ones(7))
    assert torch.equal(got, torch.zeros(7))


def test_cpu_tensors_take_the_plain_version():
    tf, idf, dl = (torch.from_numpy(a) for a in _inputs(8, 64, 1))
    got = bm25_block_op(tf, idf, dl, avg_dl=50.0)
    assert torch.equal(got, bm25_block_ref(tf, idf, dl, avg_dl=50.0))
    assert bm25_block.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        bm25_block(torch.zeros(2, 4), torch.zeros(2), torch.ones(4))
    assert bm25_block.launches == 0
