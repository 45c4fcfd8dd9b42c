"""The plain reference against the port on the CPU, at a tiny size: the
encoder, the token layout, BM25 and the measures agree.  The port is
what the benchmark measures; these tests show that the reference the
judge holds it to computes the same thing."""
import numpy as np
import pytest
import torch

from perfbench.conftest import TINY_MODEL
from perfbench.reference.bm25 import BM25
from perfbench.reference.encoder import score_pairs
from perfbench.reference.measures import average_precision, ndcg
from perfbench.reference.tokens import pair_ids
from perfbench.traffic.corpus import make_corpus
from perfbench.weights import draw, to_numpy

from repro_torch.core.frame import ColFrame
from repro_torch.core.measures import evaluate
from repro_torch.ir import InvertedIndex
from repro_torch.ir.tokenizer import HashTokenizer
from repro_torch.models.cross_encoder import (EncoderConfig, MonoScorer,
                                              encoder_score)

CFG = dict(TINY_MODEL, torch_dtype="float32", max_position_embeddings=96)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus("t", n_docs=1500, n_topics=12, seed=2**31 + 3)


def _enc_cfg():
    return EncoderConfig(n_layers=CFG["num_hidden_layers"],
                         d_model=CFG["hidden_size"],
                         n_heads=CFG["num_attention_heads"],
                         d_ff=CFG["intermediate_size"],
                         vocab_size=CFG["vocab_size"],
                         max_len=CFG["max_position_embeddings"])


def test_token_layout_matches_the_port(corpus):
    tok = HashTokenizer(CFG["vocab_size"])
    memo = {}
    for q, t in zip(corpus.queries[:6], corpus.texts[:6]):
        for text in (t, t + " [VS] " + corpus.texts[7]):
            port = tok.encode_pair(q, text, CFG["max_position_embeddings"])
            ref = pair_ids(q, text, CFG["vocab_size"],
                           CFG["max_position_embeddings"], memo)
            assert port[:len(ref)].tolist() == ref
            assert not port[len(ref):].any()


@pytest.mark.parametrize("layers", [1, 2])
def test_encoder_matches_the_port(corpus, layers):
    cfg = dict(CFG, num_hidden_layers=layers)
    w = draw(cfg, torch.Generator().manual_seed(7))
    ecfg = EncoderConfig(**{**_enc_cfg().__dict__, "n_layers": layers})
    mono = MonoScorer(ecfg, params=to_numpy(w), device="cpu")
    qs = [corpus.queries[i % 12] for i in range(20)]
    ts = corpus.texts[:20]
    port = mono._score_pairs(qs, ts)
    memo = {}
    ids = [pair_ids(q, t, cfg["vocab_size"], cfg["max_position_embeddings"],
                    memo) for q, t in zip(qs, ts)]
    ref = score_pairs(w, ids, tokens_per_block=300)
    assert np.abs(port - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    # padding the reference to the port's length changes nothing
    toks = torch.tensor([i + [0] * (96 - len(i)) for i in ids])
    padded = encoder_score(mono.encoder.tree, toks, ecfg).double().numpy()
    assert np.allclose(padded, port, atol=1e-6)


def test_bm25_matches_the_port(corpus):
    index = InvertedIndex.build({"docno": d, "text": t}
                                for d, t in zip(corpus.docnos, corpus.texts))
    port = index.bm25(num_results=50)
    ref = BM25(corpus.terms, corpus.offsets, corpus.vocab)
    for q in corpus.queries:
        ids, scores = port.score_query(q)
        top, acc = ref.top(q, 50)
        assert ids.tolist() == top.tolist()
        assert np.allclose(scores, acc[top], rtol=1e-6)


def test_measures_match_the_port(corpus):
    rng = np.random.default_rng(0)
    qid = corpus.qids[0]
    labels = corpus.qrels[qid]
    ranked = list(labels)[:5] + [corpus.docnos[i] for i in
                                 rng.choice(1500, 10, replace=False)]
    rng.shuffle(ranked)
    res = ColFrame({"qid": [qid] * len(ranked), "docno": ranked,
                    "score": np.arange(len(ranked), 0, -1, dtype=float),
                    "rank": np.arange(len(ranked))})
    qrels = ColFrame({"qid": [qid] * len(labels), "docno": list(labels),
                      "label": list(labels.values())})
    pq = evaluate(res, qrels, ["nDCG@10", "MAP"])
    assert pq["nDCG@10"][qid] == pytest.approx(ndcg(ranked, labels, 10),
                                               abs=1e-12)
    assert pq["MAP"][qid] == pytest.approx(
        average_precision(ranked, labels), abs=1e-12)
