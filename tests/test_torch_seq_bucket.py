"""The rerankers' sequence buckets: ``seq_bucket``'s bounds, scores of
calls cut to their bucket against ``encoder_score`` on the untrimmed
``max_len`` block (the reference's shape) for Mono and Duo, the
CUDA-graph memo's entries keyed by (row bucket, sequence bucket), and
the ``encoder.call`` span and token counters of a cut call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.models.cross_encoder as jce
import repro_torch.caching.compile_cache as tcc
import repro_torch.core as tcore
import repro_torch.models.cross_encoder as tce
from repro_torch.caching import CompileCache, bucket_size
from repro_torch.caching.bucketing import SEQ_STEP, seq_bucket
from repro_torch.core import trace

torch.set_num_threads(1)

WIDE = dict(name="torch-seq-bucket", n_layers=1, d_model=32, n_heads=2,
            d_ff=64, vocab_size=2048, max_len=256)
CFG = tce.EncoderConfig(**WIDE)

_WORDS = [f"w{i}" for i in range(400)]


def _text(rng, n):
    return " ".join(rng.choice(_WORDS, n))


def _pairs(n, seed, *, long=False):
    """n pairs of 3-word queries and 5-90 word passages; with ``long``
    the last passage runs past ``max_len`` and ``encode_pair`` cuts it."""
    rng = np.random.default_rng(seed)
    qs = [_text(rng, 3) for _ in range(n)]
    ts = [_text(rng, int(k)) for k in rng.integers(5, 91, n)]
    if long:
        ts[-1] = _text(rng, 400)
    return qs, ts


@pytest.fixture
def memo(monkeypatch):
    cc = CompileCache()
    monkeypatch.setattr(tcc, "default_compile_cache", cc)
    return cc


def _untrimmed(scorer, qs, ts):
    """``encoder_score`` on the pairs' untrimmed ``max_len`` block, in
    one call: the reference's shape."""
    toks = np.stack([scorer.tokenizer.encode_pair(q, t, scorer.cfg.max_len)
                     for q, t in zip(qs, ts)])
    assert toks.shape[1] == scorer.cfg.max_len
    with torch.inference_mode():
        return tce.encoder_score(scorer.encoder.tree, torch.from_numpy(toks),
                                 scorer.cfg).double().numpy()


def _seqs(memo):
    return sorted(k[1][0][0][1] for k, _ in memo.entries())


@given(st.integers(1, 1024), st.integers(1, 1024))
@settings(max_examples=200, deadline=None)
def test_property_seq_bucket_bounds(longest, max_len):
    longest = min(longest, max_len)        # encode_pair cuts at max_len
    b = seq_bucket(longest, max_len)
    assert longest <= b <= max_len
    assert b % SEQ_STEP == 0 or b == max_len
    assert b < longest + SEQ_STEP


@pytest.mark.parametrize("longest,max_len,want", [
    (1, 256, 32), (32, 256, 32), (33, 256, 64), (65, 256, 96),
    (95, 256, 96), (150, 256, 160), (185, 256, 192), (240, 256, 256),
    (256, 256, 256), (10, 16, 16), (16, 16, 16), (30, 64, 32),
    (40, 48, 48)])
def test_seq_bucket_values(longest, max_len, want):
    assert seq_bucket(longest, max_len) == want


@pytest.mark.parametrize("long", [False, True])
def test_mono_cut_to_its_bucket_matches_the_max_len_block(memo, long):
    scorer = tce.MonoScorer(CFG, seed=2, device="cpu")
    qs, ts = _pairs(20, seed=3, long=long)
    got = scorer._score_pairs(qs, ts)
    np.testing.assert_allclose(got, _untrimmed(scorer, qs, ts),
                               rtol=1e-5, atol=1e-5)
    longest = max(np.count_nonzero(scorer.tokenizer.encode_pair(
        q, t, CFG.max_len)) for q, t in zip(qs, ts))
    assert _seqs(memo) == [(32, seq_bucket(longest, CFG.max_len))]
    assert (_seqs(memo)[0][1] == CFG.max_len) == long


def test_mono_cut_matches_the_reference_at_max_len(memo):
    """The reference computes every pair at ``max_len``; the port's cut
    call gives the same scores from bridged weights."""
    jm = jce.MonoScorer(jce.EncoderConfig(**WIDE), seed=5)
    tm = tce.MonoScorer(CFG, seed=5, device="cpu",
                        params=jax.tree.map(np.asarray, jm.params))
    qs, ts = _pairs(12, seed=4)
    toks = np.stack([jm.tokenizer.encode_pair(q, t, CFG.max_len)
                     for q, t in zip(qs, ts)])
    want = np.asarray(jce.encoder_score(jm.params, jnp.asarray(toks),
                                        jm.cfg))
    np.testing.assert_allclose(tm._score_pairs(qs, ts), want,
                               rtol=1e-5, atol=1e-5)
    assert _seqs(memo)[0][1] < CFG.max_len


def _duo_frame(n_q, n_docs, seed, long):
    rng = np.random.default_rng(seed)
    data = {"qid": [], "query": [], "docno": [], "text": [], "rank": []}
    for q in range(n_q):
        query = _text(rng, 3)
        for r in range(n_docs):
            data["qid"].append(f"q{q}")
            data["query"].append(query)
            data["docno"].append(f"d{q}-{r}")
            data["text"].append(_text(rng, int(rng.integers(5, 91))))
            data["rank"].append(r)
    if long:
        data["text"][0] = _text(rng, 300)
    return data


@pytest.mark.parametrize("long", [False, True])
def test_duo_cut_to_its_bucket_matches_the_max_len_block(memo, long):
    duo = tce.DuoScorer(CFG, seed=6, max_docs=4, device="cpu")
    data = _duo_frame(3, 5, seed=7, long=long)
    out = duo(tcore.ColFrame(data))
    want = {}
    for q in sorted(set(data["qid"])):
        idx = [i for i, x in enumerate(data["qid"]) if x == q][:4]
        texts = [data["text"][i] for i in idx]
        pairs = [(i, j) for i in range(4) for j in range(4) if i != j]
        s = _untrimmed(duo, [data["query"][idx[0]]] * len(pairs),
                       [texts[i] + " [VS] " + texts[j] for i, j in pairs])
        agg = np.zeros(4)
        for (i, j), v in zip(pairs, s):
            agg[i] += v
            agg[j] -= v
        want.update({data["docno"][k]: a for k, a in zip(idx, agg)})
    got = dict(zip(out["docno"].tolist(), out["score"].tolist()))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[d] for d in sorted(want)],
                               [want[d] for d in sorted(want)],
                               rtol=1e-5, atol=1e-5)
    seqs = {s for _, s in _seqs(memo)}
    assert (CFG.max_len in seqs) == long


def test_entries_are_row_and_sequence_buckets(memo):
    """Calls of mixed sizes and lengths: one entry per (row bucket,
    sequence bucket) the calls make, at most 8 sequence buckets a row
    bucket, and a repeated shape replays."""
    scorer = tce.MonoScorer(CFG, seed=1, device="cpu")
    rng = np.random.default_rng(8)
    want = set()
    for call in range(14):
        n = int(rng.integers(1, 40))
        lo, hi = sorted(rng.integers(1, 260, 2))
        qs = ["q"] * n
        ts = [_text(rng, int(k)) for k in rng.integers(lo, hi + 1, n)]
        scorer._score_pairs(qs, ts)
        longest = max(np.count_nonzero(scorer.tokenizer.encode_pair(
            q, t, CFG.max_len)) for q, t in zip(qs, ts))
        want.add((bucket_size(n, floor=8, ceiling=1024),
                  seq_bucket(longest, CFG.max_len)))
    assert set(_seqs(memo)) == want
    assert len(_seqs(memo)) == memo.stats.compile_misses
    rows = {r for r, _ in want}
    assert len(memo.entries()) <= len(rows) * (CFG.max_len // SEQ_STEP)
    assert memo.stats.compile_hits == 14 - len(want)


def test_the_call_span_and_counters_see_the_cut_block(memo):
    scorer = tce.MonoScorer(CFG, seed=0, device="cpu")
    qs, ts = _pairs(10, seed=9)
    assert trace.active() is None
    rec = trace.enable()
    try:
        scorer._score_pairs(qs, ts)
    finally:
        trace.disable()
    call, = rec.named("encoder.call")
    toks = np.stack([scorer.tokenizer.encode_pair(q, t, CFG.max_len)
                     for q, t in zip(qs, ts)])
    seq = seq_bucket(np.count_nonzero(toks, axis=1).max(), CFG.max_len)
    assert call.attrs == {"rows": 16, "seq": seq} and seq < CFG.max_len
    assert rec.counters["encoder.tokens_computed"] == 16 * seq
    assert rec.counters["encoder.tokens_useful"] == np.count_nonzero(toks)
