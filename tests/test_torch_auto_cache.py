"""``auto_cache`` parity: the cache family the port's
``repro_torch.caching.auto_cache`` picks for each stage of the toy
pipeline sets and of Table 2 (and the stages it refuses) is the
reference's, and ``typecheck_pipeline`` reports the same column errors
(mirrors tests/test_auto_cache.py)."""
import pytest
import torch

import repro.caching as jcache
import repro.core as jcore
import repro.ir as jir
import repro.models.cross_encoder as jce
import repro_torch.caching as tcache
import repro_torch.core as tcore
import repro_torch.ir as tir
import repro_torch.models.cross_encoder as tce
from repro_torch.caching.provenance import set_digest_device
from _torch_parity import pipeline_sets, toy

torch.set_num_threads(1)
set_digest_device("cpu")

SETS = ["ablation", "commutative", "cutoffs", "mixed"]
CE = dict(n_layers=1, d_model=16, n_heads=2, d_ff=32, vocab_size=256,
          max_len=16)
PKGS = {"ref": (jcore, jcache, jir, jce, {}),
        "port": (tcore, tcache, tir, tce, {"device": "cpu"})}


def _family(caching, stage):
    """The family ``auto_cache`` picks (in memory) with its key and
    value columns and codec, or the refusal's reason."""
    try:
        cache = caching.auto_cache(stage, None, backend="memory")
    except caching.UncacheableError as e:
        return ("refused", str(e).replace(repr(stage), "<stage>"))
    try:
        return (type(cache).__name__, tuple(cache.key_cols),
                tuple(getattr(cache, "value_cols", ())), cache.codec)
    finally:
        cache.close()


def _plan_stages(core, name):
    pipes = pipeline_sets(toy(core))[name]
    return [n.stage for n in core.lower(pipes).nodes if n.kind == "stage"]


@pytest.mark.parametrize("name", SETS)
def test_family_per_toy_stage_equals_reference(name):
    got = [_family(tcache, s) for s in _plan_stages(tcore, name)]
    want = [_family(jcache, s) for s in _plan_stages(jcore, name)]
    assert got == want
    assert any(f[0] == "RetrieverCache" for f in got)
    # the planner's policy: None exactly where auto_cache refuses
    for stage, fam in zip(_plan_stages(tcore, name), got):
        c = tcache.auto_cache_or_none(stage, None, backend="memory")
        assert (c is None) == (fam[0] == "refused")
        if c is not None:
            c.close()


def _table2_stages(pkg):
    core, _, ir, ce, kw = PKGS[pkg]
    corpus = ir.msmarco_like(1, 0.02)
    index = ir.InvertedIndex.build(corpus.get_corpus_iter())
    cfg = ce.EncoderConfig(name=f"torch-parity-auto-{pkg}", **CE)
    enc = ir.DenseEncoder(cfg, seed=3, **kw)
    dense = ir.DenseIndex(enc).index(corpus.get_corpus_iter())
    return corpus, {
        "bm25": index.bm25(num_results=50),
        "cutoff": core.RankCutoff(10),
        "text": ir.TextLoader(corpus.text_map()),
        "mono": ce.MonoScorer(cfg, **kw),
        "duo": ce.DuoScorer(cfg, max_docs=10, **kw),
        "dense": dense.retriever(20),
        "expander": ir.QueryExpander(2),
        "nondeterministic": core.GenericTransformer(
            lambda x: x, "rng", deterministic=False, key_columns=("qid",),
            value_columns=("query",)),
        "opaque": core.GenericTransformer(lambda x: x, "opaque"),
        "compose": ir.QueryExpander(2) >> ir.QueryExpander(3),
    }


@pytest.fixture(scope="module")
def table2():
    return {pkg: _table2_stages(pkg) for pkg in PKGS}


def test_family_per_table2_stage_equals_reference(table2):
    _, tstages = table2["port"]
    _, jstages = table2["ref"]
    got = {k: _family(tcache, s) for k, s in tstages.items()}
    want = {k: _family(jcache, s) for k, s in jstages.items()}
    assert got == want
    assert got["bm25"][0] == got["dense"][0] == "RetrieverCache"
    assert got["mono"][0] == "ScorerCache"
    assert got["text"][0] == got["expander"][0] == "KeyValueCache"
    for k in ("duo", "nondeterministic", "opaque", "compose"):
        assert got[k][0] == "refused", k
    with pytest.raises(tcache.UncacheableError, match="cacheable=False"):
        tcache.auto_cache(tstages["duo"])
    with pytest.raises(tcache.UncacheableError, match="deterministic"):
        tcache.auto_cache(tstages["nondeterministic"])
    with pytest.raises(tcache.UncacheableError, match="key/value"):
        tcache.auto_cache(tstages["opaque"])
    assert tcache.auto_cache_or_none(tstages["duo"]) is None
    # an already-cached stage is left as it is
    with tcache.ScorerCache(None, tstages["mono"], backend="memory") as c:
        assert tcache.auto_cache_or_none(c) is None


def test_default_backends_equal_reference(table2, tmp_path):
    for pkg, caching in (("port", tcache), ("ref", jcache)):
        _, stages = table2[pkg]
        for k in ("bm25", "mono", "text"):
            with caching.auto_cache(stages[k],
                                    str(tmp_path / pkg / k)) as c:
                assert c.manifest.backend == {"bm25": "dbm", "mono": "sqlite",
                                              "text": "sqlite"}[k]


def test_typecheck_pipeline_equals_reference(table2):
    errs = {}
    for pkg, caching in (("port", tcache), ("ref", jcache)):
        corpus, s = table2[pkg]
        bad = caching.typecheck_pipeline(s["bm25"] >> s["mono"])
        good = caching.typecheck_pipeline(
            s["bm25"] >> s["text"] >> s["mono"] % 10 >> s["duo"])
        assert bad and "text" in bad[0][1] and good == []
        errs[pkg] = [e for _, e in bad]
    assert errs["port"] == errs["ref"]
