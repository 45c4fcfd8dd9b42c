"""Whole runs of each cell through the harness on the CPU at a tiny size,
without the look for a card: a sound run comes out correct, and a run
with the timed path broken underneath comes out not correct, once for
each fault the cell can have."""
from concurrent.futures import Future

import numpy as np
import pytest

from perfbench.conftest import run_tiny, tiny_cell

import repro_torch.core.experiment as experiment
from repro_torch.caching import ScorerCache
from repro_torch.ir.index import BM25Retriever
from repro_torch.models.cross_encoder import DuoScorer, _EncoderBase
from repro_torch.serve import PipelineService

TABLE2 = "table2-cold.msv1-minilm-l6"
SERVE = "serve-rerank100.msv1-electra-base"


def _alter_first_score(mp):
    orig = _EncoderBase._score_tokens

    def altered(self, tokens):
        out = orig(self, tokens).copy()
        out[0] += 0.05
        return out
    mp.setattr(_EncoderBase, "_score_tokens", altered)


def _drop_half_the_batch(mp):
    orig = _EncoderBase._score_pairs

    def half(self, queries, texts):
        n = (len(queries) + 1) // 2
        out = np.zeros(len(queries))
        out[:n] = orig(self, queries[:n], texts[:n])
        return out
    mp.setattr(_EncoderBase, "_score_pairs", half)


def _swap_bm25_doc(mp):
    orig = BM25Retriever.transform

    def swapped(self, inp):
        out = orig(self, inp)
        doc = out["docno"].copy()
        doc[0], doc[-1] = doc[-1], doc[0]
        return out.assign(docno=doc)
    mp.setattr(BM25Retriever, "transform", swapped)


def _stale_cache_hits(mp):
    orig = ScorerCache.transform

    def stale(self, inp):
        out = orig(self, inp)
        if self.stats.hits:                   # hits return an old score
            return out.assign(score=out["score"] * 0.5)
        return out
    mp.setattr(ScorerCache, "transform", stale)


def _duo_order_flipped(mp):
    orig = DuoScorer.transform

    def flipped(self, inp):
        out = orig(self, inp)
        return out.assign(rank=out["rank"][::-1].copy())
    mp.setattr(DuoScorer, "transform", flipped)


def _measure_altered(mp):
    orig = experiment.evaluate

    def off(res, qrels, measures):
        pq = orig(res, qrels, measures)
        for q in pq["nDCG@10"]:
            pq["nDCG@10"][q] += 1e-3
        return pq
    mp.setattr(experiment, "evaluate", off)


def _request_lost(mp):
    orig = PipelineService.submit
    seen = []

    def lose(self, qid, query, **extra):
        seen.append(qid)
        if len(seen) == 3:
            return Future()                    # never answered
        return orig(self, qid, query, **extra)
    mp.setattr(PipelineService, "submit", lose)


def test_table2_sound_run_is_correct():
    out = run_tiny(tiny_cell(TABLE2))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"exp_topics_per_s", "setup_s"}


def test_table2_traced_run_reads_its_host_metrics():
    out = run_tiny(tiny_cell(TABLE2), trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["pairs_encoded_per_topic.exp"]["value"] > 0
    assert 0 < m["useful_token_share.exp"]["value"] <= 100
    assert 0 < m["scorer_cache_hit_share.exp"]["value"] < 100
    assert "mfu.exp" not in m          # no device trace on the CPU


@pytest.mark.parametrize("fault", [
    _alter_first_score, _drop_half_the_batch, _swap_bm25_doc,
    _stale_cache_hits, _duo_order_flipped, _measure_altered])
def test_table2_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_cell(TABLE2))
    assert not out["correct"], out["checks"]


def test_serve_sound_run_is_correct():
    out = run_tiny(tiny_cell(SERVE))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"serve_p50_ms", "serve_p95_ms",
                                   "setup_s"}


@pytest.mark.parametrize("fault", [_alter_first_score,
                                   _drop_half_the_batch, _swap_bm25_doc])
def test_serve_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_cell(SERVE))
    assert not out["correct"], out["checks"]


def test_serve_lost_request_is_not_correct(monkeypatch):
    _request_lost(monkeypatch)
    cell = tiny_cell(SERVE)
    cell.traffic["drain_s"] = 1.0
    out = run_tiny(cell)
    assert not out["correct"] and out["failed"] == 1
    assert out["checks"]["missing"]["value"] == 1
