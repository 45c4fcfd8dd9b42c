"""``repro_torch.cli cache`` (``cli/cache.py``): the reference's
``tests/test_cache_cli.py`` cases against the port's CLI, then the two
CLIs on one tree at the manifest level — ``ls --json`` records,
``verify`` exit codes and failure lists on hand-corrupted trees, ``gc
--orphaned``, ``entries``-mode artifacts exported by each package and
imported by the other — and the real ``python -m repro_torch.cli``
entry point.  (A planner directory is stale to the other package's
plans, since fingerprints fold each class's module and source, so no
test shares one between the packages' plans.)"""
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

import repro.caching as jcache
import repro.cli as jcli
import repro.core as jcore
import repro.ir as jir
from repro_torch.caching import CacheManifest, RetrieverCache
from repro_torch.caching.provenance import set_digest_device
from repro_torch.cli import main
from repro_torch.core import (ColFrame, ExecutionPlan, GenericTransformer,
                              add_ranks)
from repro_torch.ir import QueryExpander

torch.set_num_threads(1)
set_digest_device("cpu")

QUERIES = ColFrame({"qid": ["q1", "q2", "q3"],
                    "query": ["alpha beta", "gamma delta", "epsilon zeta"]})


def make_retriever(name, n=4, base=10.0, core=None):
    core = core or sys.modules["repro_torch.core"]

    def fn(inp):
        rows = [{"qid": q, "query": t, "docno": f"{name}_d{i}",
                 "score": base - i}
                for q, t in zip(inp["qid"].tolist(), inp["query"].tolist())
                for i in range(n)]
        return core.add_ranks(core.ColFrame.from_dicts(rows))
    return core.GenericTransformer(fn, name, one_to_many=True,
                                   key_columns=("qid", "query"))


def _populate(root, core=None, ir=None):
    """A planner-populated cache root of either package: a KeyValueCache
    node (sqlite), two RetrieverCache nodes (dbm), and a plan
    manifest."""
    core = core or sys.modules["repro_torch.core"]
    ir = ir or sys.modules["repro_torch.ir"]
    a = make_retriever("A", core=core)
    queries = core.ColFrame({k: QUERIES[k].tolist() for k in QUERIES.columns})
    with core.ExecutionPlan([ir.QueryExpander(2) >> a, a],
                            cache_dir=str(root)) as plan:
        plan.run(queries)
    return root


@pytest.fixture
def cache_root(tmp_path):
    return _populate(tmp_path / "cache")


def _node_dirs(root):
    return sorted(d for d in os.listdir(root) if d != "plans")


# -- ls -----------------------------------------------------------------------

def test_ls_reports_dirs_and_plans(cache_root, capsys):
    assert main(["cache", "ls", str(cache_root), "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert len(info["dirs"]) == 3            # expander + A-under-qe + A
    families = {d["family"] for d in info["dirs"]}
    assert families == {"KeyValueCache", "RetrieverCache"}
    assert all(d["entry_count"] == len(QUERIES) for d in info["dirs"])
    assert all(d["fingerprint"] for d in info["dirs"])
    assert len(info["plans"]) == 1
    assert info["plans"][0]["n_nodes"] == 3
    assert info["plans"][0]["n_runs"] == 1


def test_ls_single_dir(cache_root, capsys):
    node = os.path.join(str(cache_root), _node_dirs(cache_root)[0])
    assert main(["cache", "ls", node, "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert len(info["dirs"]) == 1 and info["dirs"][0]["dir"] == "."


# -- verify -------------------------------------------------------------------

def test_verify_clean_root_exits_zero(cache_root, capsys):
    assert main(["cache", "verify", str(cache_root)]) == 0
    out = capsys.readouterr().out
    assert "0 failure(s)" in out


def test_verify_detects_hand_corrupted_manifest(cache_root, capsys):
    """`cache verify` detects a hand-corrupted manifest (the checksum no
    longer matches the edited body)."""
    node = _node_dirs(cache_root)[0]
    mpath = os.path.join(str(cache_root), node, "manifest.json")
    with open(mpath) as f:
        text = f.read()
    with open(mpath, "w") as f:
        f.write(text.replace('"entry_count": 3', '"entry_count": 999'))
    assert main(["cache", "verify", str(cache_root)]) == 1
    out = capsys.readouterr().out
    assert "checksum mismatch" in out and f"FAIL {node}" in out


def test_verify_detects_missing_store(cache_root, capsys):
    """A manifest whose recorded entries have no backing store fails."""
    info_rc = None
    for node in _node_dirs(cache_root):
        d = os.path.join(str(cache_root), node)
        m = CacheManifest.load(d)
        if m.backend == "sqlite":
            os.remove(os.path.join(d, "cache.sqlite3"))
            info_rc = node
    assert info_rc is not None
    assert main(["cache", "verify", str(cache_root)]) == 1
    assert "entry count mismatch" in capsys.readouterr().out


def test_verify_detects_plan_dir_fingerprint_divergence(cache_root, capsys):
    node = _node_dirs(cache_root)[0]
    d = os.path.join(str(cache_root), node)
    m = CacheManifest.load(d)
    m.fingerprint = "f" * 16
    m.save(d)                                # valid checksum, wrong fp
    assert main(["cache", "verify", str(cache_root)]) == 1
    assert "plan fingerprint" in capsys.readouterr().out


# -- gc -----------------------------------------------------------------------

def test_gc_dry_run_then_delete_old_dirs(cache_root, capsys):
    n_before = len(_node_dirs(cache_root))
    assert main(["cache", "gc", str(cache_root), "--older-than", "0s"]) == 0
    assert "would remove" in capsys.readouterr().out
    assert len(_node_dirs(cache_root)) == n_before       # dry run
    assert main(["cache", "gc", str(cache_root), "--older-than", "0s",
                 "--yes"]) == 0
    assert _node_dirs(cache_root) == []
    # fresh dirs survive a 1-week threshold
    assert main(["cache", "gc", str(cache_root), "--older-than", "7d",
                 "--yes"]) == 0


def test_gc_orphaned_removes_unreferenced_only(cache_root, capsys):
    stray = cache_root / "stray-dir"
    stray.mkdir()
    CacheManifest.new(family="KeyValueCache", backend="sqlite").save(
        str(stray))
    referenced = _node_dirs(cache_root)
    assert main(["cache", "gc", str(cache_root), "--orphaned",
                 "--yes"]) == 0
    left = _node_dirs(cache_root)
    assert "stray-dir" not in left
    assert left == [d for d in referenced if d != "stray-dir"]


def test_gc_requires_a_selector(cache_root):
    with pytest.raises(SystemExit):
        main(["cache", "gc", str(cache_root)])


# -- export / import ----------------------------------------------------------

def _retriever_node(cache_root):
    for node in _node_dirs(cache_root):
        d = os.path.join(str(cache_root), node)
        if CacheManifest.load(d).family == "RetrieverCache":
            return d
    raise AssertionError("no RetrieverCache node found")


def test_export_import_roundtrip_cross_backend(cache_root, tmp_path,
                                               capsys):
    """Entries export backend-agnostically: a dbm RetrieverCache node
    re-imports into a sqlite store and serves the same hits."""
    src = _retriever_node(cache_root)
    art = str(tmp_path / "node.tar")
    dest = str(tmp_path / "imported")
    assert main(["cache", "export", src, art]) == 0
    assert "entries mode" in capsys.readouterr().out
    assert main(["cache", "import", art, dest, "--backend", "sqlite"]) == 0
    m = CacheManifest.load(dest)
    assert m.backend == "sqlite" and m.entry_count == len(QUERIES)
    assert m.fingerprint == CacheManifest.load(src).fingerprint
    # the imported dir serves the cached queries with no transformer
    with RetrieverCache(dest, None, backend="sqlite") as rc:
        out = rc(QUERIES)
        assert rc.stats.hits == len(QUERIES) and rc.stats.misses == 0
        assert len(out) == len(QUERIES) * 4
    assert main(["cache", "verify", dest]) == 0


def test_import_refuses_fingerprint_mismatch(cache_root, tmp_path, capsys):
    dirs = [os.path.join(str(cache_root), d) for d in
            _node_dirs(cache_root)]
    art_a, art_b = str(tmp_path / "a.tar"), str(tmp_path / "b.tar")
    dest = str(tmp_path / "imported")
    assert main(["cache", "export", dirs[0], art_a]) == 0
    assert main(["cache", "export", dirs[1], art_b]) == 0
    assert main(["cache", "import", art_a, dest]) == 0
    with pytest.raises(SystemExit, match="fingerprint mismatch"):
        main(["cache", "import", art_b, dest])
    capsys.readouterr()
    assert main(["cache", "import", art_b, dest, "--force"]) == 0


def test_export_raw_mode_for_pickle_backend(tmp_path, capsys):
    """Backends that cannot enumerate keys export raw store files and
    re-import them verbatim."""
    from repro_torch.caching import KeyValueCache
    src, dest = str(tmp_path / "src"), str(tmp_path / "dest")
    t = QueryExpander(2)
    with KeyValueCache(src, t, key=("qid", "query"), value=("query",),
                       backend="pickle",
                       fingerprint=t.fingerprint()) as kv:
        kv(QUERIES)
    art = str(tmp_path / "raw.tar")
    assert main(["cache", "export", src, art]) == 0
    assert "raw mode" in capsys.readouterr().out
    assert main(["cache", "import", art, dest]) == 0
    with KeyValueCache(dest, t, key=("qid", "query"), value=("query",),
                       backend="pickle",
                       fingerprint=t.fingerprint()) as kv:
        kv(QUERIES)
        assert kv.stats.hits == len(QUERIES)


def test_export_requires_manifest(tmp_path):
    plain = tmp_path / "plain"
    plain.mkdir()
    with pytest.raises(SystemExit, match="manifest"):
        main(["cache", "export", str(plain), str(tmp_path / "x.tar")])


# -- the real entry point -----------------------------------------------------

def test_python_m_repro_torch_cli_verify(cache_root):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    p = subprocess.run([sys.executable, "-m", "repro_torch.cli", "cache",
                        "verify", str(cache_root)],
                       capture_output=True, text=True, env=env, timeout=180)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "0 failure(s)" in p.stdout
    mpath = os.path.join(str(cache_root), _node_dirs(cache_root)[0],
                         "manifest.json")
    with open(mpath) as f:
        text = f.read()
    with open(mpath, "w") as f:
        f.write(text.replace('"entry_count": 3', '"entry_count": 9'))
    p = subprocess.run([sys.executable, "-m", "repro_torch.cli", "cache",
                        "verify", str(cache_root)],
                       capture_output=True, text=True, env=env, timeout=180)
    assert p.returncode == 1 and "1 failure(s)" in p.stdout


# -- --json scripting contract (stable key order, unchanged exit codes) ------

def _assert_stable_json(raw: str):
    """Output must be pure JSON with recursively sorted keys, so shell
    pipelines can diff two invocations without canonicalizing first."""
    doc = json.loads(raw)
    assert raw.strip() == json.dumps(doc, indent=2, sort_keys=True)
    return doc


def test_ls_json_is_stable_and_pure(cache_root, capsys):
    assert main(["cache", "ls", str(cache_root), "--json"]) == 0
    doc = _assert_stable_json(capsys.readouterr().out)
    assert set(doc) == {"root", "dirs", "plans"}
    # repeated invocations are byte-identical (modulo nothing)
    assert main(["cache", "ls", str(cache_root), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["dirs"] == doc["dirs"]


def test_verify_json_keeps_exit_codes(cache_root, capsys):
    assert main(["cache", "verify", str(cache_root), "--json"]) == 0
    doc = _assert_stable_json(capsys.readouterr().out)
    assert doc["failed"] == 0 and doc["checked"] >= 4
    assert all(r["problems"] == [] for r in doc["report"])
    # corrupt one manifest: exit code flips to 1, report names the dir
    node = _node_dirs(cache_root)[0]
    mpath = os.path.join(str(cache_root), node, "manifest.json")
    with open(mpath) as f:
        text = f.read()
    with open(mpath, "w") as f:
        f.write(text.replace('"entry_count": 3', '"entry_count": 999'))
    assert main(["cache", "verify", str(cache_root), "--json"]) == 1
    doc = _assert_stable_json(capsys.readouterr().out)
    assert doc["failed"] == 1
    bad = [r for r in doc["report"] if r["problems"]]
    assert bad[0]["dir"] == node


def test_plan_explain_json_is_stable(cache_root, capsys):
    assert main(["plan", "explain", str(cache_root), "--json"]) == 0
    docs = _assert_stable_json(capsys.readouterr().out)
    assert len(docs) == 1 and docs[0]["nodes"]


# -- the two CLIs on one tree ---------------------------------------------------

def _run(cli_main, argv):
    """(exit code or SystemExit, stdout) of one CLI invocation."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        try:
            rc = cli_main(argv)
        except SystemExit as e:
            rc = ("exit", str(e))
    return rc, buf.getvalue()


@pytest.fixture(params=["port", "ref"])
def either_tree(request, tmp_path):
    """The same plan's cache root written by either package."""
    if request.param == "port":
        return _populate(tmp_path / "cache")
    return _populate(tmp_path / "cache", core=jcore, ir=jir)


def test_ls_json_records_equal_across_packages(either_tree):
    rc_t, out_t = _run(main, ["cache", "ls", str(either_tree), "--json"])
    rc_j, out_j = _run(jcli.main, ["cache", "ls", str(either_tree),
                                   "--json"])
    assert rc_t == rc_j == 0
    assert json.loads(out_t) == json.loads(out_j)
    assert out_t == out_j
    for sort in ("size", "age", "hits"):
        assert _run(main, ["cache", "ls", str(either_tree), "--sort",
                           sort])[1] == \
            _run(jcli.main, ["cache", "ls", str(either_tree), "--sort",
                             sort])[1]


def _corrupt(root, how):
    nodes = _node_dirs(root)
    if how == "checksum":
        mpath = os.path.join(str(root), nodes[0], "manifest.json")
        with open(mpath) as f:
            text = f.read()
        with open(mpath, "w") as f:
            f.write(text.replace('"entry_count": 3', '"entry_count": 999'))
    elif how == "store":
        for node in nodes:
            d = os.path.join(str(root), node)
            if jcache.CacheManifest.load(d).backend == "sqlite":
                os.remove(os.path.join(d, "cache.sqlite3"))
    elif how == "fingerprint":
        d = os.path.join(str(root), nodes[0])
        m = jcache.CacheManifest.load(d)
        m.fingerprint = "f" * 16
        m.save(d)
    elif how == "missing-dir":
        shutil.rmtree(os.path.join(str(root), nodes[-1]))


@pytest.mark.parametrize("how", ["clean", "checksum", "store",
                                 "fingerprint", "missing-dir"])
def test_verify_agrees_across_packages(either_tree, how):
    _corrupt(either_tree, how)
    rc_t, out_t = _run(main, ["cache", "verify", str(either_tree),
                              "--json"])
    rc_j, out_j = _run(jcli.main, ["cache", "verify", str(either_tree),
                                   "--json"])
    assert rc_t == rc_j == (0 if how == "clean" else 1)
    assert json.loads(out_t) == json.loads(out_j)
    assert _run(main, ["cache", "verify", str(either_tree)]) == \
        _run(jcli.main, ["cache", "verify", str(either_tree)])


def test_gc_orphaned_removes_the_same_dirs(tmp_path):
    for owner in ("port", "ref"):
        roots = {}
        for cli in ("port", "ref"):
            root = tmp_path / owner / cli
            if owner == "port":
                _populate(root)
            else:
                _populate(root, core=jcore, ir=jir)
            stray = root / "stray-dir"
            stray.mkdir()
            CacheManifest.new(family="KeyValueCache",
                              backend="sqlite").save(str(stray))
            roots[cli] = root
        before = _node_dirs(roots["port"])
        assert _run(main, ["cache", "gc", str(roots["port"]), "--orphaned",
                           "--yes"])[0] == 0
        assert _run(jcli.main, ["cache", "gc", str(roots["ref"]),
                                "--orphaned", "--yes"])[0] == 0
        assert _node_dirs(roots["port"]) == _node_dirs(roots["ref"]) == \
            [d for d in before if d != "stray-dir"]


def _entries(dirpath, backend):
    from repro_torch.caching import BACKENDS
    b = BACKENDS[backend](dirpath)
    try:
        return sorted(b.items())
    finally:
        b.close()


@pytest.mark.parametrize("exporter", ["port", "ref"])
def test_entries_artifacts_import_across_packages(tmp_path, exporter):
    """An ``entries``-mode artifact exported by either package imports
    through the other with equal (key bytes, value bytes) entries and
    the exported manifest's fingerprint."""
    root = _populate(tmp_path / "cache") if exporter == "port" else \
        _populate(tmp_path / "cache", core=jcore, ir=jir)
    out_cli, in_cli = (main, jcli.main) if exporter == "port" else \
        (jcli.main, main)
    src = _retriever_node(root)
    art = str(tmp_path / "node.tar")
    rc, out = _run(out_cli, ["cache", "export", src, art])
    assert rc == 0 and "entries mode" in out
    for backend in ("dbm", "sqlite"):
        dest = str(tmp_path / f"imported-{backend}")
        assert _run(in_cli, ["cache", "import", art, dest, "--backend",
                             backend])[0] == 0
        assert _entries(dest, backend) == _entries(src, "dbm")
        m = CacheManifest.load(dest)
        assert (m.backend, m.entry_count, m.fingerprint) == \
            (backend, len(QUERIES), CacheManifest.load(src).fingerprint)
        for cli in (main, jcli.main):
            assert _run(cli, ["cache", "verify", dest])[0] == 0


def test_verify_counts_mmap_dirs_where_the_reference_skips(tmp_path):
    """The port counts an ``mmap:<disk>`` directory's entries in its
    disk tier, as both count ``tiered:<disk>``; the reference's
    ``_disk_name`` knows ``tiered`` only, so it cannot see that the
    store behind an mmap manifest is gone."""
    root = tmp_path / "cache"
    a = make_retriever("A")
    with ExecutionPlan([a], cache_dir=str(root),
                       cache_backend="mmap:sqlite") as plan:
        plan.run(QUERIES)
    (node,) = _node_dirs(root)
    d = os.path.join(str(root), node)
    assert CacheManifest.load(d).backend == "mmap:sqlite"
    assert _run(main, ["cache", "verify", str(root)])[0] == 0
    os.remove(os.path.join(d, "cache.sqlite3"))
    rc, out = _run(main, ["cache", "verify", str(root)])
    assert rc == 1 and "entry count mismatch: store holds 0" in out
    assert _run(jcli.main, ["cache", "verify", str(root)])[0] == 0


def test_cache_warm_on_the_cpu_then_serve_misses_nothing(tmp_path):
    """``cache warm --device cpu`` reports what ``warm_scenario`` does
    in the reference, and a service over the directory then misses
    nothing."""
    root = str(tmp_path / "t")
    rc, out = _run(main, ["cache", "warm", "bm25", "--cache-dir", root,
                          "--backend", "sqlite", "--scale", "0.02",
                          "--cutoff", "5", "--device", "cpu", "--json"])
    assert rc == 0
    rep = json.loads(out)
    jrep = jcache.warm_scenario("bm25", str(tmp_path / "j"),
                                backend="sqlite", scale=0.02, cutoff=5)
    for key in ("scenario", "backend", "queries_warmed", "cache_hits",
                "cache_misses", "nodes_executed"):
        assert rep[key] == jrep[key]
    from repro_torch.serve import ServeConfig, drive_closed_loop
    rec = drive_closed_loop(ServeConfig(pipeline="bm25", scale=0.02,
                                        cutoff=5, cache_dir=root,
                                        backend="sqlite", device="cpu"),
                            requests=30, clients=3)
    assert rec["hit_rate"] == 1.0
    assert _run(main, ["cache", "verify", root])[0] == 0
    rc, out = _run(main, ["cache", "evict", root, "--budget", "10",
                          "--record", "--json"])
    assert rc == 0
    doc = json.loads(out)
    assert [r["entries_after"] for r in doc["dirs"]] == [10]
    assert CacheManifest.load(os.path.join(
        root, _node_dirs(root)[0])).max_entries == 10
