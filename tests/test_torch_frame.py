"""repro_torch's copied numpy modules against the reference: ColFrame,
the operator algebra, add_ranks, measures, corpora and tokenizers are
exactly equal."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.ir as jir
import repro_torch.core as tcore
import repro_torch.ir as tir

torch.set_num_threads(1)


def _rows(frame):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in r.items()} for r in frame.to_dicts()]


def _results(seed, n_q=5, depth=12, ties=False, interleave=False):
    rng = np.random.default_rng(seed)
    qids = np.repeat([f"q{i}" for i in range(n_q)], depth)
    docnos = np.array([f"d{j}" for j in rng.integers(0, 40, n_q * depth)],
                      dtype=object)
    scores = rng.normal(size=n_q * depth)
    if ties:
        scores = np.round(scores, 0)
    order = rng.permutation(len(qids)) if interleave else np.arange(len(qids))
    return {"qid": qids[order].tolist(), "docno": docnos[order].tolist(),
            "score": scores[order]}


@pytest.mark.parametrize("seed,ties,interleave", [
    (0, False, False), (1, True, False), (2, False, True), (3, True, True)])
def test_add_ranks_equal(seed, ties, interleave):
    data = _results(seed, ties=ties, interleave=interleave)
    a = jcore.add_ranks(jcore.ColFrame(data))
    b = tcore.add_ranks(tcore.ColFrame(data))
    assert _rows(a) == _rows(b)


@pytest.mark.parametrize("op", ["sort", "group", "dedup", "merge", "concat",
                                "mask"])
def test_colframe_ops_equal(op):
    data = _results(7, ties=True, interleave=True)
    other = {"docno": [f"d{j}" for j in range(0, 40, 3)],
             "text": [f"text {j}" for j in range(0, 40, 3)]}
    outs = []
    for core in (jcore, tcore):
        f = core.ColFrame(data)
        if op == "sort":
            out = f.sort_values(["qid", "score"], ascending=[True, False])
        elif op == "group":
            out = {k: v.tolist() for k, v in f.group_indices(["qid"]).items()}
        elif op == "dedup":
            out = f.dedup(["qid", "docno"])
        elif op == "merge":
            out = f.merge(core.ColFrame(other), on=["docno"], how="left")
        elif op == "concat":
            out = core.ColFrame.concat([f, f.head(7)])
        else:
            out = f.mask(f["score"] > 0)
        outs.append(out if isinstance(out, dict) else _rows(out))
    assert outs[0] == outs[1]


def _pair(core, seed):
    a = core.SourceResults(core.add_ranks(core.ColFrame(_results(seed))), "a")
    b = core.SourceResults(core.add_ranks(core.ColFrame(_results(seed + 1))),
                           "b")
    return a, b


@pytest.mark.parametrize("expr", ["a+b", "a*2", "a**b", "a|b", "a&b", "a^b",
                                  "a%3", "(a+b)%4>>b"])
def test_operator_algebra_equal(expr):
    topics = {"qid": [f"q{i}" for i in range(5)],
              "query": [f"query {i}" for i in range(5)]}
    outs = []
    for core in (jcore, tcore):
        a, b = _pair(core, 11)
        pipe = eval(expr, {"a": a, "b": b})
        outs.append(_rows(pipe(core.ColFrame(topics))))
    assert outs[0] == outs[1]


def test_measures_equal():
    data = _results(5, ties=True)
    qrels = {"qid": [f"q{i % 5}" for i in range(30)],
             "docno": [f"d{i}" for i in range(30)],
             "label": [i % 4 for i in range(30)]}
    ms = ["nDCG@10", "MAP", "RR", "P@5", "R@10", "Judged@10", "nDCG"]
    ref = jcore.evaluate(jcore.add_ranks(jcore.ColFrame(data)),
                         jcore.ColFrame(qrels), ms)
    got = tcore.evaluate(tcore.add_ranks(tcore.ColFrame(data)),
                         tcore.ColFrame(qrels), ms)
    assert got == ref


@pytest.mark.parametrize("version", [1, 2])
def test_msmarco_like_identical(version):
    a = jir.msmarco_like(version, 0.02)
    b = tir.msmarco_like(version, 0.02)
    for part in ("docs", "topics", "qrels"):
        assert _rows(getattr(a, part)) == _rows(getattr(b, part))


def test_hash_tokenizer_identical():
    corpus = tir.msmarco_like(1, 0.02)
    texts = corpus.docs["text"].tolist()[:50]
    queries = corpus.topics["query"].tolist()
    ja, ta = jir.HashTokenizer(2048), tir.HashTokenizer(2048)
    np.testing.assert_array_equal(ja.encode_batch(texts, 32),
                                  ta.encode_batch(texts, 32))
    for q, t in zip(queries, texts):
        np.testing.assert_array_equal(ja.encode_pair(q, t, 64),
                                      ta.encode_pair(q, t, 64))
    assert jir.fnv1a32(b"hopper") == tir.fnv1a32(b"hopper")
