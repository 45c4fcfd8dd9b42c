"""The traffic and the data the harness finds by name: the open-loop
schedule comes from the seed and latencies run from the due time; every
cell's configuration, traffic mix, limits and metric readers load; the
set-ups capture every shape the window can issue before it starts."""
import json
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, program
from perfbench.conftest import TINY_MODEL, run_tiny, tiny_cell
from perfbench.traffic import open_loop
from perfbench.traffic.corpus import make_corpus
from perfbench.weights import draw, to_numpy
from repro_torch.caching.bucketing import seq_bucket

SPEC = json.loads((Path(harness.ROOT) / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
MIX = {"rate_per_s": 20.0, "arrival_seed": 5, "drain_s": 5}


def test_schedule_is_the_mixs():
    a = open_loop.schedule(MIX, 10.0)
    assert np.array_equal(a, open_loop.schedule(MIX, 10.0))
    assert not np.array_equal(
        a, open_loop.schedule(dict(MIX, arrival_seed=6), 10.0)[:len(a)])
    assert a[0] == 0.0 and (np.diff(a) > 0).all() and a[-1] < 10.0
    assert 120 < len(a) < 280                  # Poisson at 20/s over 10 s
    assert np.array_equal(open_loop.schedule(MIX, 5.0), a[a < 5.0])


class _Service:
    """Answers after ``delay``; the first call blocks the sender."""

    class stats:
        requests = 0
        batches = 0

    def __init__(self, delay):
        self.delay = delay
        self.calls = 0

    def submit(self, qid, query):
        self.calls += 1
        if self.calls == 1:
            time.sleep(0.3)
        fut = Future()
        threading.Timer(self.delay, fut.set_result, args=[_Frame(qid)]).start()
        return fut

    def plan_stats(self):
        class S:
            cache_hits = 0
        return S()


class _Frame(dict):
    def __init__(self, qid):
        super().__init__(qid=np.array([qid]), docno=np.array(["d"]),
                         score=np.array([1.0]), rank=np.array([0]))

    def __len__(self):
        return 1


def test_latency_runs_from_the_due_time():
    corpus = make_corpus("s", n_docs=200, n_topics=50, seed=1)
    run = harness.Run(None, seed=3, seconds=1.0, trace=False, device="cpu")
    run.cell = harness.Cell("x", {}, dict(MIX, rate_per_s=20.0), {}, [], [])
    st = {"corpus": corpus, "service": _Service(0.05),
          "order": np.arange(50), "mono": type("M", (), {"invocations": 0})}
    rec = open_loop.window(run, st, 1.0)
    lat = rec["latencies_ms"]
    due = open_loop.schedule(run.traffic, 1.0)
    assert rec["attempted"] == len(due) and rec["failed"] == 0
    assert (lat >= 50.0 - 1.0).all()
    # the requests due while the first submit blocked the sender waited
    blocked = due < 0.3
    assert lat[blocked][-1] > 50.0 + (0.3 - due[blocked][-1]) * 1e3 - 5.0
    assert np.median(lat[~blocked]) < 150.0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic["driver"] in ("table2", "open_loop")
    assert {"hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "vocab_size", "max_position_embeddings",
            "torch_dtype", "corpus_passages"} <= set(c.config)
    assert [m["name"] for m in c.end_to_end][-1] == "setup_s"
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_config_a_file():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert {"captures_in_window.serve", "captures_in_window.exp"} <= names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (Path(harness.PACKAGE) / "metrics"
                / f"{m['name']}.py").is_file()
    for c in SPEC["configs"]:
        cfg = json.loads((Path(harness.ROOT) / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) <= set(cfg["reduced"])


#: pairs long enough to land in several sequence buckets
WIDE = dict(TINY_MODEL, max_position_embeddings=256)


@pytest.fixture
def graphs(monkeypatch):
    """A CompileCache of the test's own: no earlier test's entry hides a
    capture."""
    import repro_torch.caching.compile_cache as cc
    fresh = cc.CompileCache()
    monkeypatch.setattr(cc, "default_compile_cache", fresh)
    return fresh


@pytest.fixture(scope="module")
def small():
    corpus = make_corpus("s", n_docs=600, n_topics=30, seed=7)
    gen = torch.Generator("cpu").manual_seed(7)
    cfg = dict(WIDE, torch_dtype="float32")
    scorers = {"mono": program.mono(cfg, to_numpy(draw(cfg, gen)), "cpu"),
               "duo": program.duo(cfg, to_numpy(draw(cfg, gen)), "cpu", 10)}
    return corpus, scorers


def _count(scorer, query, text):
    return int(np.count_nonzero(scorer.tokenizer.encode_pair(
        query, text, scorer.cfg.max_len)))


@pytest.mark.parametrize("kind", ["mono", "duo"])
def test_pair_length_bounds_are_the_corpus_extremes(small, kind):
    corpus, scorers = small
    scorer = scorers[kind]
    q = corpus.queries[0]      # every query has the mix's three words
    alone = sorted(corpus.texts, key=lambda t: _count(scorer, q, t))
    k = 2 if kind == "duo" else 1
    lo = _count(scorer, q, " [VS] ".join(alone[:k]))
    hi = _count(scorer, q, " [VS] ".join(alone[-k:]))
    assert program.pair_length_bounds(scorer, corpus.queries,
                                      corpus.texts) == (lo, hi)
    assert lo < hi <= scorer.cfg.max_len


def _text_in_bucket(scorer, query, texts, seq):
    """A text of the corpus, Duo's two passages for Duo, whose pair with
    ``query`` lands in sequence bucket ``seq``."""
    duo = isinstance(scorer, program.DuoScorer)
    cands = (a + " [VS] " + b for a in texts for b in texts[:50]) if duo \
        else iter(texts)
    return next(t for t in cands if seq_bucket(
        _count(scorer, query, t), scorer.cfg.max_len) == seq)


@pytest.mark.parametrize("kind", ["mono", "duo"])
def test_warm_shapes_leaves_no_capture_to_the_window(small, graphs, kind):
    corpus, scorers = small
    scorer = scorers[kind]
    lo, hi = program.pair_length_bounds(scorer, corpus.queries,
                                        corpus.texts)
    seqs = {seq_bucket(n, scorer.cfg.max_len) for n in range(lo, hi + 1)}
    assert len(seqs) >= 2
    rows = [8, 32]
    shapes = program.warm_shapes(scorer, rows, corpus.queries, corpus.texts)
    want = {(r, s) for r in rows for s in seqs}
    assert set(shapes) == want
    # an entry's key: (name, (abstract leaves, structure), device,
    # weights); its first leaf is the tokens, ("arr", shape, dtype)
    assert {key[1][0][0][1] for key, _ in graphs.entries()} == want
    misses = program.compile_misses()
    q = corpus.queries[3]
    for r, s in sorted(want):
        text = _text_in_bucket(scorer, q, corpus.texts, s)
        scorer._score_pairs([q] * (r - 3), [text] * (r - 3))
        assert program.compile_misses() == misses, (r, s)


def test_warm_shapes_leaves_out_what_a_mono_call_cannot_reach(small,
                                                              graphs):
    """A Mono call padded to 128 rows holds 65 pairs or more, so its
    longest pair does not land in the shortest pair's bucket: there
    ``warm_shapes`` leaves that bucket out, and keeps it at the runner's
    floor, where a call may hold one pair.  Calls of 65 passages drawn
    from the corpus all land in a bucket warmed at 128."""
    corpus, scorers = small
    mono = scorers["mono"]
    lo, hi = program.pair_length_bounds(mono, corpus.queries, corpus.texts)
    seqs = sorted({seq_bucket(n, mono.cfg.max_len)
                   for n in range(lo, hi + 1)})
    shapes = program.warm_shapes(mono, [8, 128], corpus.queries,
                                 corpus.texts)
    assert {s for r, s in shapes if r == 8} == set(seqs)
    at128 = {s for r, s in shapes if r == 128}
    assert seqs[0] not in at128 and seqs[-1] in at128
    q = min(corpus.queries, key=lambda x: len(x.split()))
    tokens = np.array([_count(mono, q, t) for t in corpus.texts])
    draws = np.random.default_rng(5).integers(0, len(tokens), (2000, 65))
    assert {seq_bucket(n, mono.cfg.max_len)
            for n in tokens[draws].max(axis=1)} <= at128


@pytest.mark.parametrize("cell, traffic", [
    ("table2-cold.msv1-minilm-l6", {"cuts": [3, 6]}),
    ("serve-rerank100.msv1-electra-base", {"depth": 3})])
def test_no_capture_lands_in_the_window(graphs, cell, traffic):
    """A tiny cell whose lists all fill their cut, as the full cells' do,
    and whose calls hold a few pairs of passages of 10 to 120 words, so
    that the window reaches sequence buckets the warm traffic did not
    (without ``warm_shapes`` this seed's runs capture 4 and 2 graphs
    there): its run captures none in the window, and its per-layer
    reader says so."""
    shape = dict(harness.load_cell(cell).config["corpus_shape"],
                 doc_len=[10, 120])
    c = tiny_cell(cell, model=dict(WIDE, corpus_shape=shape))
    c.traffic.update(traffic)
    out = run_tiny(c, trace=True)
    assert out["correct"], out["checks"]
    n = out["counters"]
    if "topics" in n:
        assert n["mono_pairs"] == n["topics"] * max(traffic["cuts"])
    else:
        assert n["pairs_encoded"] == n["requests"] * traffic["depth"]
    assert n["compiles_in_window"] == 0
    name = "captures_in_window." + ("exp" if "topics" in n else "serve")
    assert out["metrics"][name]["value"] == 0
