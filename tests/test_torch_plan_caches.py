"""Planner-inserted caches: ``ExecutionPlan(cache_dir=...)`` of the port
against the reference's (``repro.core.ExecutionPlan``) on the same toy
pipelines — cold then warm, sequential and sharded, in-memory, with a
custom memo factory and under each ``on_stale`` policy — and the cache
passes (``cache-prune``, ``cache-place``, ``autotune``) on equal inputs
(mirrors the cache cases of tests/test_plan.py, test_rewrite.py and
test_cost.py).  Outputs, hits, misses, nodes executed and pruned, node
directory names and the manifests' family, codec, columns and entry
counts are exact; timings are never compared."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.caching as jcache
import repro.core as jcore
import repro.ir as jir
import repro_torch.caching as tcache
import repro_torch.core as tcore
import repro_torch.ir as tir
from repro_torch.caching.provenance import set_digest_device
from repro_torch.core.rewrite import run_pass
from _torch_parity import frames_equal, pin_round_trip, pipeline_sets, toy

torch.set_num_threads(1)
set_digest_device("cpu")

PKGS = {"ref": (jcore, jcache), "port": (tcore, tcache)}


@pytest.fixture(autouse=True)
def pinned_round_trip(monkeypatch):
    pin_round_trip(monkeypatch)
STAT_FIELDS = ("cache_hits", "cache_misses", "nodes_executed",
               "stage_invocations_saved", "nodes_pruned", "nodes_planned")
MANIFEST_FIELDS = ("family", "codec", "backend", "key_columns",
                   "value_columns", "entry_count")


def cached_set(core):
    """Toy pipelines whose stages take all three auto_cache families: a
    retriever (RetrieverCache), a pointwise scorer (ScorerCache) and a
    query rewriter (KeyValueCache), behind an augment-only annotator
    that cache-prune may defer."""
    t = toy(core)

    def annotate(inp):
        return inp.assign(prio=np.ones(len(inp)))

    def score(inp):
        return core.add_ranks(inp.assign(score=np.array(
            [float(len(q) + int(d[-1])) for q, d in
             zip(inp["query"].tolist(), inp["docno"].tolist())])))

    def rewrite(inp):
        return inp.assign(query=np.array(
            [q + " x" for q in inp["query"].tolist()], dtype=object))

    ann = t.Counting("annotate", annotate, augment_only=True)
    r1 = t.retriever("r1", n=5)
    sc = t.Counting("sc", score, key_columns=("query", "docno"),
                    value_columns=("score",))
    qe = t.Counting("qe", rewrite, key_columns=("qid", "query"),
                    value_columns=("query",))
    return t, [ann >> r1 % 3 >> sc, r1 >> sc % 2, qe >> r1 % 4], \
        (ann, r1, sc, qe)


SETS = {name: (lambda core, _n=name: (
    toy(core), pipeline_sets(toy(core))[_n], ()))
    for name in ("ablation", "commutative", "cutoffs", "mixed")}
SETS["cached"] = cached_set


def _node_dirs(d):
    return sorted(x for x in os.listdir(d) if x != "plans")


def _manifests(d):
    out = {}
    for x in _node_dirs(d):
        m = jcache.CacheManifest.load(os.path.join(d, x))
        out[x] = tuple(getattr(m, f) for f in MANIFEST_FIELDS)
    return out


#: the passes whose marks depend on no measured time; ``operand-order``
#: and ``cache-place`` decide from the prior run's timings, and an
#: operand swap relabels the combine that ``normalize`` marked
STRUCTURAL_PASSES = ("cse", "pushdown", "cache-prune")


def _plan_record(d):
    """The plan manifest's nodes, optimizer counts and runs, without
    what the cost-driven passes decide from measured times."""
    (name,) = os.listdir(os.path.join(d, "plans"))
    rec = json.load(open(os.path.join(d, "plans", name)))
    nodes = sorted(((n["kind"], n["dir"], n["family"], n["inlined"],
                     n["probe_input"],
                     tuple(p for p in n["touched_by"]
                           if p in STRUCTURAL_PASSES))
                    for n in rec["nodes"]), key=repr)
    opt = {k: v for k, v in rec["optimizer"].items()
           if k in ("passes", "nodes_eliminated", "cutoffs_pushed",
                    "nodes_marked_prunable")}
    runs = [{k: r[k] for k in ("nodes_executed", "nodes_pruned",
                               "cache_hits", "cache_misses", "n_shards",
                               "n_queries")} for r in rec["runs"]]
    return nodes, opt, runs, len(rec["costs"])


def _cold_then_warm(core, name, d, plan_kw=None, **run_kw):
    """Two runs of a fresh plan each against ``d``; returns the outputs,
    stats fields, per-pass prune marks and stage call counts."""
    rows = []
    for _ in range(2):
        t, pipes, stages = SETS[name](core)
        with core.ExecutionPlan(pipes, cache_dir=d,
                                **(plan_kw or {})) as plan:
            outs, st = plan.run(t.queries(), **run_kw)
            marks = {n.label for n in plan.graph.nodes if n.inlined}
            rows.append((outs, tuple(getattr(st, f) for f in STAT_FIELDS),
                         marks, [s.calls for s in stages]))
    return rows


@pytest.mark.parametrize("name", list(SETS))
def test_cold_then_warm_equals_reference(tmp_path, name):
    """Against the reference at ``prefetch=False`` (the port has no data
    plane yet), and hits and misses against its default run too."""
    d = {k: str(tmp_path / k) for k in PKGS}
    got = {"port": _cold_then_warm(tcore, name, d["port"]),
           "ref": _cold_then_warm(jcore, name, d["ref"],
                                  {"prefetch": False}),
           "default": _cold_then_warm(jcore, name, str(tmp_path / "dflt"))}
    for (touts, tstats, tmarks, tcalls), (jouts, jstats, jmarks, jcalls), \
            (_, dstats, _, _) in zip(got["port"], got["ref"], got["default"]):
        assert tstats == jstats == dstats
        assert tmarks == jmarks and tcalls == jcalls
        for a, b in zip(touts, jouts):
            assert frames_equal(a, b)
    cold, warm = got["port"][0][1], got["port"][1][1]
    assert cold[0] == 0 and cold[1] > 0          # cold: misses only
    assert warm[0] == cold[1] and warm[1] == 0   # warm: hits only
    assert _node_dirs(d["port"]) == _node_dirs(d["ref"])
    assert _manifests(d["port"]) == _manifests(d["ref"])
    assert _plan_record(d["port"]) == _plan_record(d["ref"])
    # and each output equals the pipeline run on its own
    t, pipes, _ = SETS[name](tcore)
    for out, p in zip(got["port"][1][0], pipes):
        assert frames_equal(out, p(t.queries()))


def test_cache_prune_defers_the_annotator_like_reference(tmp_path):
    got = {k: _cold_then_warm(core, "cached", str(tmp_path / k))
           for k, (core, _) in PKGS.items()}
    (_, _, marks, calls), = got["port"][1:]
    assert any("annotate" in m for m in marks)
    assert calls[0] == 0                 # the annotator never ran warm
    assert got["port"][1][1][4] == got["ref"][1][1][4] == 1   # pruned
    # unseen queries miss the probe: the deferred chain runs
    for k, (core, _) in PKGS.items():
        t, pipes, (ann, *_rest) = cached_set(core)
        with core.ExecutionPlan(pipes, cache_dir=str(tmp_path / k)) as plan:
            _, st = plan.run(core.ColFrame({"qid": ["q9"],
                                            "query": ["omega"]}))
        got[k] = (st.nodes_pruned, ann.calls, st.cache_misses)
    assert got["port"] == got["ref"] == (0, 1, got["ref"][2])


def _prune_case(core, case):
    """The reference's two cache-prune guards (test_rewrite.py): a
    query-rewriting stage that is not augment-only, and an augment-only
    stage that produces a key column of the cache."""
    t = toy(core)
    if case == "not-augment-only":
        first = t.Counting("rewrite", lambda inp: inp.assign(query=np.array(
            [q + "!" for q in inp["query"].tolist()], dtype=object)))
        topics = t.queries()
    else:
        first = t.Counting("attach", lambda inp: inp.assign(query=np.array(
            ["terms " + q for q in inp["qid"].tolist()], dtype=object)),
            augment_only=True, value_columns=("query",))
        topics = core.ColFrame({"qid": ["q1", "q2"]})
    return [first >> t.retriever("R", n=2)], topics, first


@pytest.mark.parametrize("case", ["not-augment-only", "key-producer"])
def test_cache_prune_guards_equal_reference(tmp_path, case):
    got = {}
    for k, (core, caching) in PKGS.items():
        d = str(tmp_path / k)
        pipes, topics, first = _prune_case(core, case)
        with core.ExecutionPlan(pipes, cache_dir=d) as cold:
            outs1, _ = cold.run(topics)
        pipes, topics, first = _prune_case(core, case)
        with core.ExecutionPlan(pipes, cache_dir=d) as warm:
            marked = sum(p.nodes_marked_prunable for p in warm.pass_stats)
            outs2, s2 = warm.run(topics)
        assert frames_equal(outs1[0], outs2[0])
        got[k] = (marked, s2.nodes_pruned, s2.cache_hits, first.calls,
                  outs2[0])
    assert got["port"][:4] == got["ref"][:4] == (0, 0, 2 if case ==
                                                 "key-producer" else 3, 1)
    assert frames_equal(got["port"][4], got["ref"][4])
    # the dynamic guard alone: probing with a key-less frame is a miss
    r = toy(tcore).retriever("R", n=2)
    with tcache.RetrieverCache(None, r) as cache:
        assert cache.serve_from_store(tcore.ColFrame({"qid": ["q1"]})) \
            is None


@pytest.mark.parametrize("backend", ["pickle", "sqlite"])
def test_sharded_warm_run_equals_reference(tmp_path, backend):
    got = {}
    for k, (core, _) in PKGS.items():
        t = toy(core)
        retr = t.retriever("R", n=4)
        pipes = [retr % 3, retr % 2]
        with core.ExecutionPlan(pipes, cache_dir=str(tmp_path / k),
                                cache_backend=backend) as plan:
            _, s1 = plan.run(t.queries(), n_shards=3, max_workers=3)
            outs, s2 = plan.run(t.queries(), n_shards=3, max_workers=3)
        got[k] = ((s1.cache_hits, s1.cache_misses, s2.cache_hits,
                   s2.cache_misses, s2.n_shards, retr.calls), outs)
        for a, p in zip(outs, pipes):
            assert frames_equal(a, p(t.queries()))
    assert got["port"][0] == got["ref"][0]
    assert got["port"][0][:5] == (0, 3, 3, 0, 3)
    # a sharded warm run with a probing node: the deferred chain waits
    # on its input and runs at most once per shard
    rows = {k: _cold_then_warm(core, "cached", str(tmp_path / f"c{k}"),
                               n_shards=3, max_workers=2)
            for k, (core, _) in PKGS.items()}
    for (ta, tb, tc, td), (ja, jb, jc, jd) in zip(rows["port"], rows["ref"]):
        assert (tb, tc, td) == (jb, jc, jd)
        assert all(frames_equal(a, b) for a, b in zip(ta, ja))
    assert rows["port"][1][1][4] == 1 and rows["port"][1][3][0] == 0


def test_unported_parts_refuse_with_their_queue_item(tmp_path):
    t = toy(tcore)
    pipes = pipeline_sets(t)["ablation"]
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        tcore.ExecutionPlan(pipes, cache_dir=str(tmp_path / "a"),
                            prefetch=True)
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        tcore.ExecutionPlan(pipes, cache_dir=str(tmp_path / "b"),
                            cache_backend="mmap:sqlite")
    with tcore.ExecutionPlan(pipes, cache_dir=str(tmp_path / "c"),
                             prefetch=False) as plan:
        _, st = plan.run(t.queries())
    assert (st.cache_misses, st.cache_prefetched) == (3, 0)


def test_memory_backend_and_memo_factory_equal_reference():
    got = {}
    for k, (core, _) in PKGS.items():
        t = toy(core)
        retr = t.retriever("R", n=1)
        with core.ExecutionPlan([retr % 1], cache_backend="memory") as plan:
            cached = [n for n in plan.nodes.values() if n.cache is not None]
            plan.run(t.queries())
            _, st = plan.run(t.queries())
        seen = []

        def factory(stage, path):
            seen.append((repr(stage), path))
            return None

        core.ExecutionPlan([t.retriever("A") % 3], memo_factory=factory)
        kwargs = []

        def rich(stage, path, *, fingerprint=None, on_stale=None,
                 backend=None):
            kwargs.append((path is None, len(fingerprint), on_stale,
                           backend))
            return None

        core.ExecutionPlan([t.retriever("A") % 3], memo_factory=rich,
                           cache_backend="memory", on_stale="readonly")
        got[k] = ([type(n.cache).__name__ for n in cached],
                  cached[0].cache.backend.name, retr.calls,
                  (st.cache_hits, st.cache_misses), seen, kwargs)
    assert got["port"] == got["ref"]
    assert got["port"][:4] == (["RetrieverCache"], "memory", 1, (3, 0))
    assert len(got["port"][4]) == 2


def _versioned(core, version):
    """A toy retriever whose provenance carries a version the structural
    signature does not: bumping it makes its directory stale."""
    t = toy(core)
    retr = t.retriever("V", n=3)
    retr.fingerprint_extras = lambda: ("version", version)
    return t, [retr % 2], retr


@pytest.mark.parametrize("on_stale", ["error", "recompute", "readonly"])
def test_on_stale_policies_equal_reference(tmp_path, on_stale):
    got = {}
    for k, (core, caching) in PKGS.items():
        d = str(tmp_path / k)
        t, pipes, _ = _versioned(core, 1)
        with core.ExecutionPlan(pipes, cache_dir=d) as plan:
            plan.run(t.queries())
        t, pipes, retr = _versioned(core, 2)
        if on_stale == "error":
            with pytest.raises(caching.StaleCacheError):
                core.ExecutionPlan(pipes, cache_dir=d, on_stale=on_stale)
            got[k] = _manifests(d)
            continue
        rows = []
        for _ in range(2):
            with core.ExecutionPlan(pipes, cache_dir=d,
                                    on_stale=on_stale) as plan:
                _, st = plan.run(t.queries())
                rows.append((st.cache_hits, st.cache_misses))
        got[k] = (rows, retr.calls, _manifests(d))
    assert got["port"] == got["ref"]
    if on_stale == "recompute":          # wiped, refilled, then warm
        assert got["port"][:2] == ([(0, 3), (3, 0)], 1)
    if on_stale == "readonly":           # served stale, never written
        assert got["port"][:2] == ([(3, 0), (3, 0)], 0)


def _bm25_pipes(core, ir):
    corpus = ir.msmarco_like(1, 0.02)
    index = ir.InvertedIndex.build(corpus.get_corpus_iter())
    return corpus.get_topics().head(5), \
        [index.bm25(num_results=20) % 5 >> ir.TextLoader(corpus.text_map())]


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_cross_package_directories(tmp_path, direction):
    """A planner-inserted directory of the package's own stages (BM25,
    TextLoader) is stale to the other package — node fingerprints fold
    the class's module and source — so ``on_stale="error"`` refuses it;
    the directory names agree.  Toy stages, defined outside both
    packages, have equal fingerprints, so their directories serve
    across packages."""
    fill, serve = ("ref", "port") if direction == "reference->port" \
        else ("port", "ref")
    irs = {"ref": jir, "port": tir}
    d = str(tmp_path / "bm25")
    core, _ = PKGS[fill]
    topics, pipes = _bm25_pipes(core, irs[fill])
    with core.ExecutionPlan(pipes, cache_dir=d) as plan:
        plan.run(topics)
    names = _node_dirs(d)
    core, caching = PKGS[serve]
    topics, pipes = _bm25_pipes(core, irs[serve])
    with pytest.raises(caching.StaleCacheError):
        core.ExecutionPlan(pipes, cache_dir=d)
    with core.ExecutionPlan(pipes, cache_dir=str(tmp_path / "own")) as plan:
        plan.run(topics)
    assert _node_dirs(str(tmp_path / "own")) == names
    # toy stages serve across packages, warm from the first run
    d = str(tmp_path / "toy")
    _cold_then_warm(PKGS[fill][0], "ablation", d)
    rows = _cold_then_warm(PKGS[serve][0], "ablation", d)
    assert rows[0][1][1] == 0 and rows[0][1][0] > 0


def _costed_plan(core, d, costs=None, runs=None, round_trip=1e-5):
    """A plan over ``d`` whose prior manifest carries ``costs`` (per-query
    seconds by stage name, keyed here by each package's own node
    fingerprints) and ``runs``; the backend round trip is pinned."""
    t = toy(core)
    pipes = [t.retriever("A") >> t.docno_scorer("S"), t.retriever("B")]
    if costs is not None or runs is not None:
        with core.ExecutionPlan(pipes, cache_dir=d,
                                cache_backend="sqlite") as plan:
            plan.run(t.queries())
            fps = plan.node_fingerprints()
            (name,) = os.listdir(os.path.join(d, "plans"))
            path = os.path.join(d, "plans", name)
            rec = json.load(open(path))
            rec["costs"] = {fps[n.id]: {"s_per_query": costs[n.stage.name],
                                        "n": 3, "updated_at": 0.0}
                            for n in plan.graph.nodes
                            if getattr(n.stage, "name", None) in
                            (costs or {})}
            rec["runs"] = list(runs or [])
            with open(path, "w") as f:
                json.dump(rec, f)
    return t, core.ExecutionPlan(pipes, cache_dir=d, cache_backend="sqlite")


def test_cache_place_and_autotune_decide_like_reference(tmp_path,
                                                        monkeypatch):
    """The same measured costs, run history and store round trip (10
    µs) give both packages the same decisions: skip the cheap node's
    cache, memory-front the expensive one (``tiered:sqlite``), pick the
    measured best shard count; the promoted directory stays warm."""
    pin_round_trip(monkeypatch, 1e-5)
    costs = {"A": 1e-7, "B": 1e-3}
    runs = [{"n_queries": 3, "wall_time_s": 1.0, "n_shards": 1},
            {"n_queries": 3, "wall_time_s": 0.2, "n_shards": 3}]
    got = {}
    for k, (core, _) in PKGS.items():
        d = str(tmp_path / k)
        label = {}
        t, plan = _costed_plan(core, d, costs, runs)
        with plan:
            for n in plan.graph.nodes:
                if n.kind == "stage" and n.stage.name in ("A", "B"):
                    label[n.stage.name] = (n.cache_skip, n.backend_override,
                                      n.cost_src, type(n.cache).__name__,
                                      getattr(getattr(n.cache, "backend",
                                                      None), "name", None))
            outs, st = plan.run(t.queries())
            place = next(p for p in plan.pass_stats
                         if p.name == "cache-place")
            got[k] = (label, (place.caches_skipped, place.caches_promoted),
                      plan.tuning(), (st.cache_hits, st.cache_misses),
                      "cost[est=" in plan.explain())
    assert got["port"] == got["ref"]
    label, counts, tuning, hits, explained = got["port"]
    assert label["A"][:2] == (True, None) and label["A"][3] == "NoneType"
    assert label["B"][1] == "tiered:sqlite"
    assert label["B"][4] == "tiered:sqlite"
    assert counts == (1, 1) and tuning == {"n_shards": 3}
    assert hits == (3, 0) and explained


@pytest.mark.parametrize("case", ["cheap-round-trip", "default-prior",
                                  "no-history", "online"])
def test_cost_pass_edge_cases_equal_reference(tmp_path, case):
    """Injected equal cost contexts through ``run_pass``: a round trip
    cheaper than recompute never skips, a default prior never loses a
    cache, no history tunes nothing, online stats set the batch knobs."""
    got = {}
    for k, (core, _) in PKGS.items():
        import importlib
        cost = importlib.import_module(core.__name__ + ".cost")
        plan = core.ExecutionPlan([toy(core).retriever("A") >>
                                   toy(core).docno_scorer("S")],
                                  optimize=["normalize"])
        graph, fps = plan.graph, plan.node_fingerprints()
        a = next(n for n in graph.nodes if n.kind == "stage"
                 and "A" in (n.label or ""))
        measured = {} if case == "default-prior" else \
            {fps[a.id]: {"s_per_query": 1e-3, "n": 3, "updated_at": 0.0}}
        history = [] if case != "online" else [
            {"n_queries": 8, "wall_time_s": 0.1, "n_shards": 1,
             "online": {"batch_occupancy": 0.95, "max_batch": 16,
                        "max_wait_ms": 2.0, "queue_depth_p99": 4.0}}]
        graph.cost = cost.CostContext(
            model=cost.CostModel(measured), fps=fps, backend="sqlite",
            round_trip_s=1e-6 if case == "cheap-round-trip" else 1e-5,
            history=history)
        runner = run_pass if core is tcore else \
            importlib.import_module("repro.core.rewrite").run_pass
        place, tune = runner(graph, "cache-place"), runner(graph, "autotune")
        got[k] = ([(n.cache_skip, n.backend_override, n.cost_src)
                   for n in graph.nodes if n.kind == "stage"],
                  place.caches_skipped, place.caches_promoted,
                  graph.tuning, tune.knobs_tuned)
    assert got["port"] == got["ref"]
    assert got["port"][1] == 0


def test_explain_reads_actuals_from_the_plan_manifest(tmp_path):
    for k, (core, _) in PKGS.items():
        t = toy(core)
        d = str(tmp_path / k)

        def build():
            return [t.retriever("A", 4) >> t.docno_scorer("S")]
        first = core.ExecutionPlan(build(), cache_dir=d,
                                   cache_backend="sqlite")
        assert "cost[est=" in first.explain()
        first.run(t.queries())
        first.close()
        text = core.ExecutionPlan(build(), cache_dir=d,
                                  cache_backend="sqlite").explain()
        assert "act=" in text and "src=measured" in text


_SUBPROCESS_PLAN = """
import sys
from repro_torch.caching.provenance import set_digest_device
from repro_torch.core import ColFrame, ExecutionPlan, GenericTransformer, \\
    add_ranks
set_digest_device("cpu")

def retr(inp):
    rows = [{"qid": q, "query": t, "docno": f"d{i}", "score": 5.0 - i}
            for q, t in zip(inp["qid"].tolist(), inp["query"].tolist())
            for i in range(3)]
    return add_ranks(ColFrame.from_dicts(rows))

a = GenericTransformer(retr, "A", one_to_many=True,
                       key_columns=("qid", "query"))
Q = ColFrame({"qid": ["q1"], "query": ["x"]})
with ExecutionPlan([a % 2], cache_dir=sys.argv[1]) as plan:
    _, stats = plan.run(Q)
    print(stats.cache_hits, stats.cache_misses)
"""


def test_cache_paths_stable_across_processes(tmp_path):
    """Node directories do not depend on the per-process hash salt: a
    fresh interpreter pointed at the same ``cache_dir`` hits."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    outs = []
    for _ in range(2):
        p = subprocess.run([sys.executable, "-c", _SUBPROCESS_PLAN,
                            str(tmp_path)], capture_output=True, text=True,
                           env=env, timeout=300)
        assert p.returncode == 0, p.stderr[-2000:]
        outs.append(p.stdout.split()[-2:])
    assert outs == [["0", "1"], ["1", "0"]]
