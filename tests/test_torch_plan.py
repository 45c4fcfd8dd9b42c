"""Plan-compiler parity: the port's lowering, optimizer passes, cost
layer, executors, prefix precomputation and ``ExecutionPlan`` give the
reference's (``repro.core``) outputs and accounting on the same toy
pipelines (mirrors tests/test_plan.py, test_rewrite.py,
test_precompute.py and test_cost.py)."""
import re

import pytest
import torch

import repro.caching.provenance as jprov
import repro.core as jcore
import repro.core.cost as jcost
import repro_torch.caching.provenance as tprov
import repro_torch.core as tcore
import repro_torch.ir as tir
import repro_torch.models.cross_encoder as tce
from repro_torch.caching.provenance import set_digest_device
from repro_torch.core.rewrite import OPTIMIZER_PASSES, resolve_passes
from _torch_parity import frames_equal, pipeline_sets, toy

torch.set_num_threads(1)
set_digest_device("cpu")

SETS = ["ablation", "commutative", "cutoffs", "mixed"]
STAT_FIELDS = ("nodes_total", "nodes_planned", "nodes_executed",
               "nodes_eliminated", "cutoffs_pushed",
               "stage_invocations_saved", "prefix_len", "n_pipelines",
               "optimizer_passes")


def _run(core, name, optimize, **run_kw):
    t = toy(core)
    pipes = pipeline_sets(t)[name]
    with core.ExecutionPlan(pipes, optimize=optimize) as plan:
        outs, stats = plan.run(t.queries(), **run_kw)
    return plan, outs, stats, pipes


@pytest.mark.parametrize("optimize", ["none", "all"])
@pytest.mark.parametrize("name", SETS)
def test_outputs_and_stats_equal_reference(name, optimize):
    _, jouts, jstats, _ = _run(jcore, name, optimize)
    _, touts, tstats, tpipes = _run(tcore, name, optimize)
    assert len(touts) == len(jouts)
    for got, want in zip(touts, jouts):
        assert frames_equal(got, want)
    for f in STAT_FIELDS:
        assert getattr(tstats, f) == getattr(jstats, f), f
    # and each equals the pipeline run on its own
    t = toy(tcore)
    for got, p in zip(touts, pipeline_sets(t)[name]):
        assert frames_equal(got, p(t.queries()))


@pytest.mark.parametrize("name", SETS)
def test_sharded_executor_equals_sequential_and_reference(name):
    _, seq, _, _ = _run(tcore, name, "all")
    _, sh, stats, _ = _run(tcore, name, "all", n_shards=3, max_workers=2)
    _, jsh, jstats, _ = _run(jcore, name, "all", n_shards=3, max_workers=2)
    assert stats.n_shards == jstats.n_shards == 3
    assert stats.n_workers == 2
    assert len(stats.shard_times_s) == 3
    for a, b, c in zip(sh, seq, jsh):
        assert frames_equal(a, b) and frames_equal(a, c)


def test_resolved_pass_list_equals_reference():
    from repro.core.rewrite import resolve_passes as j_resolve
    assert OPTIMIZER_PASSES == jcore.OPTIMIZER_PASSES
    for opt in ("all", "none", ["cse"], ["normalize", "cse", "pushdown"]):
        assert resolve_passes(opt) == j_resolve(opt)
    with pytest.raises(ValueError):
        resolve_passes(["nope"])
    with pytest.raises(ValueError):
        resolve_passes("some")


def test_ablation_executes_B_once():
    t = toy(tcore)
    A, B, C = t.retriever("A"), t.boost("B"), t.docno_scorer("C")
    outs, stats = tcore.ExecutionPlan([A, A >> B, A >> B >> C]).run(
        t.queries())
    assert (A.calls, B.calls, C.calls) == (1, 1, 1)
    assert stats.nodes_executed == 3 and stats.nodes_total == 6
    trie = tcore.PrefixTrie([A, A >> B, A >> B >> C])
    jt = toy(jcore)
    jA, jB, jC = jt.retriever("A"), jt.boost("B"), jt.docno_scorer("C")
    jtrie = jcore.PrefixTrie([jA, jA >> jB, jA >> jB >> jC])
    assert trie.n_nodes() == jtrie.n_nodes() == 3
    assert trie.n_stage_invocations_naive() == \
        jtrie.n_stage_invocations_naive() == 6
    (_, tstats), (_, jstats) = trie.run(t.queries()), jtrie.run(jt.queries())
    assert tstats == jstats or vars(tstats) == vars(jstats)


@pytest.mark.parametrize("name", SETS)
def test_lcp_and_trie_counts_equal_reference(name):
    tp, jp = pipeline_sets(toy(tcore))[name], pipeline_sets(toy(jcore))[name]
    assert len(tcore.longest_common_prefix(tp)) == \
        len(jcore.longest_common_prefix(jp))
    assert tcore.PrefixTrie(tp).n_nodes() == jcore.PrefixTrie(jp).n_nodes()
    t, jt = toy(tcore), toy(jcore)
    tp, jp = pipeline_sets(t)[name], pipeline_sets(jt)[name]
    for mode in (tcore.run_with_precompute, tcore.run_with_trie):
        outs, stats = mode(tp, t.queries())
        jouts, jstats = getattr(jcore, mode.__name__)(jp, jt.queries())
        assert stats.nodes_executed == jstats.nodes_executed
        assert stats.stage_invocations_saved == \
            jstats.stage_invocations_saved
        for a, b in zip(outs, jouts):
            assert frames_equal(a, b)


def _commuted(core):
    """A commutative combine whose cheaper operand comes first, so the
    operand-order pass swaps it."""
    t = toy(core)
    r1, r2 = t.retriever("r1"), t.retriever("r2", base=7.0)
    deep = r2 >> t.boost("b1") >> t.boost("b2", 3.0) >> t.boost("b3")
    return t, [r1 + deep, (r1 + deep) % 2]


def test_operand_order_swaps_like_reference():
    t, tp = _commuted(tcore)
    jt, jp = _commuted(jcore)
    tplan, jplan = tcore.ExecutionPlan(tp), jcore.ExecutionPlan(jp)
    tsw = [p.inputs_reordered for p in tplan.pass_stats]
    assert sum(tsw) >= 1
    assert tsw == [p.inputs_reordered for p in jplan.pass_stats]
    touts, _ = tplan.run(t.queries())
    jouts, _ = jplan.run(jt.queries())
    nouts, _ = tcore.ExecutionPlan(tp, optimize="none").run(t.queries())
    for a, b, c in zip(touts, jouts, nouts):
        assert frames_equal(a, b) and frames_equal(a, c)
    # fingerprints do not move with the swap: a + b and b + a share one
    assert tplan.node_fingerprints()[tplan.graph.terminals[0].id] == \
        tcore.ExecutionPlan(tp, optimize="none").node_fingerprints()[
            tcore.ExecutionPlan(tp, optimize="none").graph.terminals[0].id]


def _masked(text):
    return re.sub(r"(fp=|plan )[0-9a-f]{12,16}", r"\1<fp>", text)


@pytest.mark.parametrize("optimize", ["none", "all"])
@pytest.mark.parametrize("name", SETS)
def test_explain_tree_equals_reference(name, optimize):
    tplan, _, _, _ = _run(tcore, name, optimize)
    jplan, _, _, _ = _run(jcore, name, optimize)
    strip = lambda s: re.sub(r" act=[0-9.]+ms", "", _masked(s))  # noqa
    assert strip(tplan.explain()) == strip(jplan.explain())
    assert "fp=" in tplan.explain()


def test_experiment_modes_equal_reference():
    t, jt = toy(tcore), toy(jcore)
    qrels = {"qid": ["q1", "q1", "q2", "q3"],
             "docno": ["A_d0", "r1_d1", "r2_d0", "A_d3"],
             "label": [1, 2, 1, 1]}
    for mode in ("lcp", "trie", "plan"):
        tp, jp = pipeline_sets(t)["mixed"], pipeline_sets(jt)["mixed"]
        got = tcore.Experiment(tp, t.queries(), tcore.ColFrame(dict(qrels)),
                               ["nDCG@10", "MAP"], precompute_prefix=True,
                               precompute_mode=mode, n_shards=2)
        want = jcore.Experiment(jp, jt.queries(),
                                jcore.ColFrame(dict(qrels)),
                                ["nDCG@10", "MAP"], precompute_prefix=True,
                                precompute_mode=mode, n_shards=2)
        assert got.means == want.means
        assert got.precompute.nodes_executed == \
            want.precompute.nodes_executed
    with pytest.raises(ValueError, match="precompute_mode"):
        tcore.Experiment(tp, t.queries(), tcore.ColFrame(dict(qrels)),
                         ["MAP"], precompute_prefix=True,
                         precompute_mode="bogus")


def test_planner_inserted_caches_refuse_with_a_reason(tmp_path):
    t = toy(tcore)
    pipes = pipeline_sets(t)["ablation"]
    for kw in ({"cache_dir": str(tmp_path)}, {"cache_backend": "memory"},
               {"memo_factory": lambda stage, path: None}):
        with pytest.raises(NotImplementedError, match="plan-inserted"):
            tcore.ExecutionPlan(pipes, **kw)
    from repro_torch.core.rewrite import run_pass
    graph = tcore.lower(pipes)
    for name in ("cache-place", "cache-prune", "autotune"):
        with pytest.raises(NotImplementedError, match="plan-inserted"):
            run_pass(graph, name)
        # without planner-inserted caches the plan skips them, as the
        # reference does
        assert tcore.ExecutionPlan(pipes, optimize=[name]).pass_stats == []
    with pytest.raises(NotImplementedError, match="plan-inserted"):
        tcore.Experiment(pipes, t.queries(), tcore.ColFrame(
            {"qid": ["q1"], "docno": ["A_d0"], "label": [1]}), ["MAP"],
            precompute_prefix=True, cache_dir=str(tmp_path))


def test_cost_model_and_analytic_priors_equal_reference():
    from repro.core import cost as jcost
    from repro.launch import roofline
    from repro_torch.core import cost as tcost
    assert (tcost.HOST_PEAK_FLOPS, tcost.HOST_MEM_BW,
            tcost.HOST_DISPATCH_OVERHEAD_S) == (
        roofline.HOST_PEAK_FLOPS, roofline.HOST_MEM_BW,
        roofline.HOST_DISPATCH_OVERHEAD_S)
    import repro.ir as jir
    import repro_torch.ir as tir
    jc, tc = jir.msmarco_like(1, 0.01), tir.msmarco_like(1, 0.01)
    jb = jir.InvertedIndex.build(jc.get_corpus_iter()).bm25(num_results=50)
    tb = tir.InvertedIndex.build(tc.get_corpus_iter()).bm25(num_results=50)
    assert tcost.analytic_stage_cost(tb) == jcost.analytic_stage_cost(jb)
    assert tcost.analytic_stage_cost(object()) is None
    tm, jm = tcost.CostModel(), jcost.CostModel()
    for x in (1.0, 0.5, 2.0):
        tm.observe("fp", x)
        jm.observe("fp", x)
        tm.observe_cache("fp", x / 4)
        jm.observe_cache("fp", x / 4)
    strip = lambda d: {k: {f: v for f, v in e.items()   # noqa: E731
                           if f != "updated_at"} for k, e in d.items()}
    assert strip(tm.to_manifest()) == strip(jm.to_manifest())
    assert tcost.should_prefetch(None) == jcost.should_prefetch(None)
    assert tcost.should_prefetch(1e-7) == jcost.should_prefetch(1e-7)


# -- a Table 2 plan's provenance, digested level by level -----------------

def _table2_plan():
    """Setting (2)'s plan of the paper's Table 2 in the port, on the CPU:
    ``bm25 % k >> text >> mono % 10 >> duo`` for k in 20, 50, 100, 200."""
    corpus = tir.msmarco_like(1, 0.05)
    index = tir.InvertedIndex.build(corpus.get_corpus_iter())
    tl = tir.TextLoader(corpus.text_map())
    cfg = tce.EncoderConfig(name="torch-parity-plan-fps", n_layers=1,
                            d_model=16, n_heads=2, d_ff=32, vocab_size=256,
                            max_len=16)
    mono = tce.MonoScorer(cfg, device="cpu")
    duo = tce.DuoScorer(cfg, max_docs=10, device="cpu")
    bm25 = index.bm25(num_results=200)
    return tcore.ExecutionPlan([bm25 % k >> tl >> mono % 10 >> duo
                                for k in (20, 50, 100, 200)])


def test_table2_plan_fingerprints_equal_reference_digest_for_digest():
    """The reference's row-by-row fold, run over the port's plan graph
    (its stages' fingerprints from the port's row-by-row digest), gives
    every node fingerprint and the plan id the batches give."""
    plan = _table2_plan()
    fps = plan.node_fingerprints()
    want = jcost.compute_node_fingerprints(plan.graph)
    assert fps == want
    assert plan.to_record()["plan_id"] == jprov.combine_fingerprints(
        "plan", *[want[t.id] for t in plan.graph.terminals])
    for node in plan.graph.nodes:                  # the stages, one by one
        if node.kind == "stage":
            assert tprov.digest_bytes(tprov.fingerprint_payload(
                node.stage)) == node.stage.fingerprint()


def test_table2_plan_launches_one_digest_per_level_and_length(monkeypatch):
    import repro_torch.kernels.cachekey_hash.ops as hops
    calls, launches = [], [0]
    orig_many, orig_op = tprov.digest_many, hops.cachekey_hash_op

    def many(payloads):
        calls.append([len(tprov._bucket_words(p)) for p in payloads])
        return orig_many(payloads)

    def op(tokens, out=None):
        launches[0] += 1
        return orig_op(tokens, out)
    monkeypatch.setattr(tprov, "digest_many", many)
    monkeypatch.setattr(hops, "cachekey_hash_op", op)
    plan = _table2_plan()
    plan.node_fingerprints()
    nodes = [n for n in plan.graph.nodes if n.kind != "source"]
    depth = {plan.graph.source.id: 0}
    for n in nodes:
        depth[n.id] = 1 + max(depth[i.id] for i in n.inputs)
    # the stages, one batch per depth, then the plan id
    assert len(calls) == 1 + max(depth.values()) + 1
    assert [len(c) for c in calls[1:-1]] == [
        sum(depth[n.id] == d for n in nodes)
        for d in range(1, max(depth.values()) + 1)]
    groups = sum(len(set(c)) for c in calls)
    assert launches[0] == groups
    # row by row it was one launch per digest: the source, each node's
    # stage and its fold, and the plan id
    assert groups < 2 + 2 * len(nodes) == sum(len(c) for c in calls)
