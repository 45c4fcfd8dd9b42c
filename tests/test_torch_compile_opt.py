"""``compile_pipeline`` parity: the reference's five cases
(tests/test_compile_opt.py) run through ``repro.core.compile_opt`` and
the port's ``repro_torch.core.compile_pipeline`` give the same stages,
the same retrieval depths and exactly equal results."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.ir as jir
from repro.core.compile_opt import compile_pipeline as j_compile
import repro_torch.core as tcore
import repro_torch.ir as tir
from repro_torch.caching.provenance import set_digest_device
from _torch_parity import frames_equal

torch.set_num_threads(1)
set_digest_device("cpu")


def _negate(core):
    return core.GenericTransformer(
        lambda r: core.add_ranks(r.assign(score=-r["score"])), "negate")


# (name, build(core, index) -> pipeline, expected stage count after
# compiling, expected num_results of the first stage or None)
CASES = [
    ("pushdown into the retriever",
     lambda core, ix: ix.bm25(num_results=1000) % 10, 1, 10),
    ("fusion and identity elision",
     lambda core, ix: ix.bm25(num_results=100) >> core.Identity() % 20 % 5,
     1, 5),
    ("no pushdown across a score change",
     lambda core, ix: ix.bm25(num_results=50) >> _negate(core) % 5, 3, 50),
    ("a larger cutoff stays",
     lambda core, ix: ix.bm25(num_results=10) % 100, 2, 10),
]


@pytest.fixture(scope="module")
def both():
    out = {}
    for name, core, ir, comp in (("ref", jcore, jir, j_compile),
                                 ("port", tcore, tir,
                                  tcore.compile_pipeline)):
        corpus = ir.msmarco_like(1, scale=0.04)
        index = ir.InvertedIndex.build(corpus.get_corpus_iter())
        out[name] = (core, index, corpus.get_topics(), comp)
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compiled_pipeline_equals_reference(both, case):
    _, build, n_stages, depth = case
    runs = {}
    for name, (core, index, topics, comp) in both.items():
        pipe = build(core, index)
        compiled = comp(pipe)
        stages = core.stages_of(compiled)
        assert len(stages) == n_stages, name
        assert stages[0].num_results == depth, name
        got = compiled(topics)
        # semantics preserved, and the original object is untouched
        assert frames_equal(got, pipe(topics))
        assert core.stages_of(pipe)[0].num_results >= depth
        runs[name] = got
    assert frames_equal(runs["port"], runs["ref"])
    assert np.array_equal(np.asarray(runs["port"]["score"]),
                          np.asarray(runs["ref"]["score"]))


def test_compile_composes_with_precompute(both):
    lcps = []
    for name, (core, index, _, comp) in both.items():
        bm25 = index.bm25(num_results=100)
        pipes = [comp(bm25 % 20 >> core.Identity()), comp(bm25 % 20)]
        lcps.append(len(core.longest_common_prefix(pipes)))
    assert lcps == [1, 1]
