"""Each cell's limits file names every number its judge compares, and
BM25 summed in bfloat16, the lower-precision control of the host's
float32 BM25, reads above the BM25 limit while the float32 sum the
port computes reads below it."""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.judge import Judge
from perfbench.reference.bm25 import BM25
from perfbench.traffic.corpus import make_corpus

from repro_torch.ir import InvertedIndex

SPEC = json.loads((Path(harness.ROOT) / "BENCHMARK.json").read_text())
NUMBERS = {
    "table2": {"bm25_score_gap", "bm25_rank_faults", "mono_gap",
               "mono_cut_faults", "duo_gap", "final_rank_faults",
               "measure_gap"},
    "open_loop": {"bm25_score_gap", "bm25_rank_faults", "mono_gap",
                  "final_rank_faults", "missing"},
}
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_limits_name_every_number(cell):
    c = harness.load_cell(cell)
    assert set(c.limits) == NUMBERS[c.traffic["driver"]]
    for k in ("bm25_rank_faults", "final_rank_faults"):
        assert c.limits[k] == 0
    assert 0 < c.limits["bm25_score_gap"] < 1e-3
    assert 0 < c.limits["mono_gap"] < 1e-3


@pytest.fixture(scope="module")
def corpus():
    return make_corpus("b", n_docs=20000, n_topics=20, seed=2**31 + 77)


def _bf16_rows(ref: BM25, query: str, k: int):
    acc = torch.zeros(ref.n_docs, dtype=torch.bfloat16)
    for word in re.findall(r"[a-z0-9]+", query):
        ids, tf = ref._postings(word)
        df = len(ids)
        idf = np.log(1.0 + (ref.n_docs - df + 0.5) / (df + 0.5))
        w = idf * tf * (ref.k1 + 1.0) / (tf + ref.norm[ids])
        acc[torch.from_numpy(ids)] += torch.from_numpy(w).to(torch.bfloat16)
    top, _ = ref.top(query, k)
    a = acc.double().numpy()
    return [(f"b_d{i}", float(a[i]), r) for r, i in enumerate(top)]


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_bm25_fails_and_float32_passes(corpus, cell):
    c = harness.load_cell(cell)
    judge = Judge(corpus, {"vocab_size": 30522,
                           "max_position_embeddings": 256}, {}, c.limits)
    index = InvertedIndex.build({"docno": d, "text": t} for d, t in
                                zip(corpus.docnos, corpus.texts))
    port = index.bm25(num_results=100)
    low = high = 0.0
    for q in corpus.queries:
        ids, scores = port.score_query(q)
        rows = [(corpus.docnos[i], float(s), r)
                for r, (i, s) in enumerate(zip(ids, scores))]
        low = max(low, judge.bm25_numbers(q, 100, rows)[0])
        high = max(high, judge.bm25_numbers(
            q, 100, _bf16_rows(judge.bm25, q, 100))[0])
    assert low <= c.limits["bm25_score_gap"] < high
