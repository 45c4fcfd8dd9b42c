"""Dense retrieval of repro_torch against the reference: embeddings from
bridged weights within 1e-5, and DenseRetriever rankings on the same
embedding matrix equal to the reference's ``backend="pallas"``."""
import jax
import numpy as np
import pytest
import torch

import repro.ir as jir
import repro.models.cross_encoder as jce
import repro_torch.core as tcore
import repro_torch.ir as tir
import repro_torch.models.cross_encoder as tce
from repro_torch.caching.provenance import set_digest_device

torch.set_num_threads(1)
set_digest_device("cpu")

# A config name of its own: the reference's process-wide compile cache
# keys executables by (name, input shapes), not by weights, so another
# test's scorer of the same name and shapes would lend it its weights.
SMALL = dict(name="torch-parity-dense", n_layers=2, d_model=32,
             n_heads=2, d_ff=64, vocab_size=2048, max_len=16)


def _port_frame(frame):
    return tcore.ColFrame({c: frame[c] for c in frame.columns})


@pytest.fixture(scope="module")
def pair():
    corpus = jir.msmarco_like(1, 0.05)
    jenc = jir.DenseEncoder(jce.EncoderConfig(**SMALL), seed=7)
    tenc = tir.DenseEncoder(tce.EncoderConfig(**SMALL), seed=7,
                            params=jax.tree.map(np.asarray, jenc.params),
                            device="cpu")
    jidx = jir.DenseIndex(jenc).index(corpus.get_corpus_iter())
    tidx = tir.DenseIndex(tenc)
    tidx.docnos = list(jidx.docnos)
    tidx.matrix = torch.from_numpy(np.asarray(jidx.matrix))  # same matrix
    return corpus, jidx, tidx


def test_embeddings_match_reference(pair):
    corpus, jidx, tidx = pair
    texts = corpus.docs["text"].tolist()[:300]
    got = tidx.encoder.encode(texts).numpy()
    np.testing.assert_allclose(got, np.asarray(jidx.matrix)[:300],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_query_memo_encodes_each_text_once(pair):
    _, _, tidx = pair
    enc = tidx.encoder
    before = enc.encoded_texts
    a = enc.encode_queries(["alpha w1", "beta w2", "alpha w1"])
    b = enc.encode_queries(["beta w2"])
    assert enc.encoded_texts - before == 2
    assert torch.equal(a[1], b[0]) and torch.equal(a[0], a[2])


@pytest.mark.parametrize("num_results", [10, 100])
def test_rankings_equal_reference_pallas(pair, num_results):
    corpus, jidx, tidx = pair
    topics = corpus.get_topics()
    q_emb = jidx.encoder.encode_queries(topics["query"].tolist())
    tidx.encoder._query_memo.update(
        (t, torch.from_numpy(e)) for t, e in
        zip(topics["query"].tolist(), q_emb))            # same queries
    a = jir.DenseRetriever(jidx, num_results, backend="pallas")(topics)
    b = tir.DenseRetriever(tidx, num_results)(_port_frame(topics))
    assert a["qid"].tolist() == b["qid"].tolist()
    assert a["docno"].tolist() == b["docno"].tolist()
    assert a["rank"].tolist() == b["rank"].tolist()
    np.testing.assert_allclose(b["score"], a["score"], atol=2e-5)


def test_num_results_2000_equals_reference(pair):
    """k above the CUDA kernel's filter path (1,024): 2,000 rows per
    query over a 3,000-doc matrix held by both indexes.  The reference
    runs its plain ``lax.top_k`` backend, as its tests run it on the
    CPU; the port runs on the CPU as well."""
    corpus, jidx, tidx = pair
    rng = np.random.default_rng(20)
    m = rng.normal(size=(3000, 32)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    docnos = [f"x{i}" for i in range(len(m))]
    jbig, tbig = jir.DenseIndex(jidx.encoder), tir.DenseIndex(tidx.encoder)
    jbig.docnos, tbig.docnos = list(docnos), list(docnos)
    jbig.matrix, tbig.matrix = m, torch.from_numpy(m)
    topics = type(corpus.get_topics()).from_dicts(
        {"qid": f"b{i}", "query": f"num results 2000 query {i}"}
        for i in range(4))
    q_emb = rng.normal(size=(len(topics), 32)).astype(np.float32)
    jbig.encoder._query_memo.update(zip(topics["query"].tolist(), q_emb))
    tbig.encoder._query_memo.update(
        (t, torch.from_numpy(e)) for t, e in
        zip(topics["query"].tolist(), q_emb))
    a = jir.DenseRetriever(jbig, 2000, backend="xla")(topics)
    b = tir.DenseRetriever(tbig, 2000)(_port_frame(topics))
    assert len(b) == 2000 * len(topics)
    assert a["qid"].tolist() == b["qid"].tolist()
    assert a["docno"].tolist() == b["docno"].tolist()
    assert a["rank"].tolist() == b["rank"].tolist()
    np.testing.assert_allclose(b["score"], a["score"], atol=2e-5)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_topk_on_same_inputs_equals_reference(pair, backend):
    _, jidx, tidx = pair
    rng = np.random.default_rng(4)
    q = rng.normal(size=(9, 32)).astype(np.float32)
    rv, ri = jidx.topk(q, 25, backend="pallas")
    vals, idxs = tidx.topk(torch.from_numpy(q), 25, backend=backend)
    np.testing.assert_array_equal(idxs, ri)
    np.testing.assert_allclose(vals, rv, atol=2e-5)


def test_with_cutoff_is_prefix_and_fingerprint_extras(pair):
    corpus, _, tidx = pair
    topics = _port_frame(corpus.get_topics().head(5))
    full = tir.DenseRetriever(tidx, 50)
    fused = full.with_cutoff(7)
    assert fused.num_results == 7 and full.with_cutoff(80) is full
    assert fused(topics).to_dicts() == (full % 7)(topics).to_dicts()
    extras = full.fingerprint_extras()
    assert extras[0] == "corpus" and extras[2:4] == ("backend", "cuda")
    assert extras[1] == tidx.content_digest()
    # bridged weights: the weight source is the arrays' digest
    assert extras[4:6] == ("weights", "numpy-sha256")
    fp = full.fingerprint()
    assert len(fp) == 16 and fp == tir.DenseRetriever(tidx, 50).fingerprint()
    assert tir.DenseRetriever(tidx, 50, backend="torch").fingerprint() != fp
    with pytest.raises(ValueError, match="backend"):
        tir.DenseRetriever(tidx, 5, backend="pallas")
