"""``repro_torch.cli cache`` — manage provenance-aware cache directories.

Counterpart of ``repro.cli.cache``.  Every cache directory carries a checksummed ``manifest.json``
(``caching/provenance.py``) and planner-managed roots additionally
carry per-plan manifests under ``plans/``; this tool consumes both:

* ``ls ROOT``        — list cache dirs (family, backend, entries,
  budgets + utilization, fingerprint, last use) and the plans that
  reference them; ``--sort size|age|hits`` orders the listing,
  ``--json`` emits the same record machine-readably;
* ``verify ROOT``    — integrity check: manifest checksums, format
  versions, store presence, recorded-vs-actual entry counts, and
  plan-manifest ↔ dir-manifest fingerprint consistency (exit 1 on any
  failure — a hand-edited manifest is detected by its checksum); the
  entries of ``tiered:<disk>`` and ``mmap:<disk>`` directories are
  counted in their disk tier (the reference counts ``tiered`` only);
* ``warm SCENARIO``  — speculative precomputation: compile the named
  serving scenario through the plan stack and precompute its caches
  offline over the expected traffic distribution (``--queries F`` for
  an explicit qid/query log, ``--budget N`` for the N hottest), so a
  later ``serve`` over the same ``--cache-dir`` starts warm; the
  scenario's models run on ``--device`` (CUDA unless ``cpu``);
* ``evict ROOT``     — enforce per-family budgets: TTL-expired entries
  first, then least-recently-used, until every dir is within
  ``--budget`` entries / ``--max-bytes`` / ``--ttl``; ``--record``
  writes the budget into the manifests so ``close()`` re-enforces it
  automatically;
* ``gc ROOT``        — prune dirs unused for ``--older-than`` and/or
  ``--orphaned`` dirs no plan manifest references (dry-run unless
  ``--yes``);
* ``export DIR OUT`` — package one node's entries as a portable
  artifact: backends that can enumerate entries export them
  backend-agnostically (re-importable into *any* registry backend at
  any compatible pipeline position), others export raw store files;
* ``import ART DEST``— materialize an artifact into a cache dir;
  fingerprint mismatches with an existing destination manifest are
  refused without ``--force``.

Artifacts are the reference's: ``entries.pkl`` holds raw ``(key
bytes, value bytes)`` pairs, so an artifact exported by either package
imports into the other.  Import only artifacts you trust — entries are
pickled blobs, the same trust model as the shared result files the
source paper discusses.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import pickle
import shutil
import tarfile
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from ..caching.backends import (BACKENDS, backend_store_exists,
                                split_combinator)
from ..caching.provenance import (MANIFEST_NAME, PLAN_MANIFEST_VERSION,
                                  CacheManifest, ManifestError,
                                  iter_plan_manifests, manifest_path)

__all__ = ["register", "cmd_ls", "cmd_verify", "cmd_warm", "cmd_evict",
           "cmd_gc", "cmd_export", "cmd_import"]

EXPORT_FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def register(subparsers) -> None:
    p = subparsers.add_parser(
        "cache", help="inspect / verify / prune / share cache directories",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cache_command", required=True)

    ls = sub.add_parser("ls", help="list cache dirs and plan manifests")
    ls.add_argument("root", help="cache root (a planner cache_dir) or "
                                 "a single cache directory")
    ls.add_argument("--sort", choices=("name", "size", "age", "hits"),
                    default="name",
                    help="order dirs by store size (desc), last use "
                         "(oldest first) or recorded hits (desc); "
                         "default: name")
    ls.add_argument("--json", action="store_true", dest="as_json")
    ls.set_defaults(func=cmd_ls)

    vf = sub.add_parser("verify", help="integrity-check manifests and stores")
    vf.add_argument("root")
    vf.add_argument("--json", action="store_true", dest="as_json")
    vf.set_defaults(func=cmd_verify)

    wm = sub.add_parser(
        "warm", help="speculatively precompute a serving scenario's caches")
    wm.add_argument("scenario",
                    help="serving scenario name (see "
                         "repro_torch.serve.registry): bm25, bm25-mono, "
                         "mono, dense, hybrid, bm25-sim")
    wm.add_argument("--cache-dir", required=True,
                    help="cache root to precompute into (pass the same "
                         "directory to `serve` later)")
    wm.add_argument("--queries", default=None, metavar="FILE",
                    help="explicit warming log: TSV 'qid<TAB>query' lines "
                         "or a .json list of row objects; default is the "
                         "scenario's expected traffic distribution")
    wm.add_argument("--budget", type=int, default=None, metavar="N",
                    help="warm only the N most-expected queries")
    wm.add_argument("--backend", default=None,
                    help="cache backend selector (e.g. sqlite, "
                         "tiered:sqlite); default: per-family defaults")
    wm.add_argument("--requests", type=int, default=512,
                    help="simulated request count for the traffic "
                         "distribution (default 512)")
    wm.add_argument("--clients", type=int, default=4,
                    help="simulated closed-loop clients (default 4; match "
                         "the serve invocation)")
    wm.add_argument("--scale", type=float, default=0.05)
    wm.add_argument("--cutoff", type=int, default=10)
    wm.add_argument("--num-results", type=int, default=100)
    wm.add_argument("--seed", type=int, default=0)
    wm.add_argument("--batch-size", type=int, default=None)
    wm.add_argument("--chunk-rows", type=int, default=None,
                    help="warm in qid-aligned chunks of at most this many "
                         "rows (bounded memory for large logs)")
    wm.add_argument("--device", default=None,
                    help="where the scenario's encoders and dense index "
                         "run (default: cuda; 'cpu' to run on the CPU)")
    wm.add_argument("--json", action="store_true", dest="as_json")
    wm.set_defaults(func=cmd_warm)

    ev = sub.add_parser(
        "evict", help="enforce entry/size/TTL budgets (LRU eviction)")
    ev.add_argument("root", help="cache root or a single cache directory")
    ev.add_argument("--budget", type=int, default=None, metavar="N",
                    help="max entries per cache dir")
    ev.add_argument("--max-bytes", default=None, metavar="SIZE",
                    help="max store bytes per dir (K/M/G suffixes ok)")
    ev.add_argument("--ttl", default=None, metavar="AGE",
                    help="evict entries unused for AGE (e.g. 30s, 12h, 7d)")
    ev.add_argument("--record", action="store_true",
                    help="also record this budget in each dir's manifest "
                         "so close() re-enforces it automatically")
    ev.add_argument("--json", action="store_true", dest="as_json")
    ev.set_defaults(func=cmd_evict)

    gc = sub.add_parser("gc", help="prune stale / orphaned cache dirs")
    gc.add_argument("root")
    gc.add_argument("--older-than", metavar="AGE", default=None,
                    help="remove dirs last used more than AGE ago "
                         "(e.g. 30s, 12h, 7d; bare numbers are seconds)")
    gc.add_argument("--orphaned", action="store_true",
                    help="remove dirs referenced by no plan manifest")
    gc.add_argument("--yes", action="store_true",
                    help="actually delete (default is a dry run)")
    gc.set_defaults(func=cmd_gc)

    ex = sub.add_parser("export", help="package one cache dir as a "
                                       "portable artifact")
    ex.add_argument("cache_dir")
    ex.add_argument("out", help="output artifact path (.tar)")
    ex.set_defaults(func=cmd_export)

    im = sub.add_parser("import", help="materialize an artifact into a "
                                       "cache dir")
    im.add_argument("artifact")
    im.add_argument("dest", help="destination cache directory (e.g. the "
                                 "planner node dir shown by `cache ls`)")
    im.add_argument("--backend", default=None,
                    help="store entry-mode artifacts in this backend "
                         "instead of the recorded one")
    im.add_argument("--force", action="store_true",
                    help="overwrite despite fingerprint mismatch / "
                         "non-empty destination")
    im.set_defaults(func=cmd_import)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _cache_dirs(root: str) -> List[str]:
    """Directories holding a ``manifest.json``: the root itself, or its
    immediate children (a planner ``cache_dir`` layout)."""
    root = os.path.abspath(root)
    if os.path.exists(manifest_path(root)):
        return [root]
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if os.path.isdir(d) and os.path.exists(manifest_path(d)):
            out.append(d)
    return out


def _disk_name(backend: Optional[str]) -> Optional[str]:
    """Resolve a ``tiered[:<disk>]`` or ``mmap[:<disk>]`` selector to its
    disk tier name; pass plain registry names through; ``None`` for
    anything else."""
    try:
        combo = split_combinator(backend) if isinstance(backend, str) \
            else None
    except ValueError:
        return None
    if combo is not None:
        return combo[1]
    return backend if backend in BACKENDS else None


def _store_exists(dirpath: str, backend: Optional[str]) -> bool:
    if backend == "dense":               # DenseScorerCache layout
        return os.path.exists(os.path.join(dirpath, "scores.npy"))
    if backend == "log":                 # IndexerCache layout
        return os.path.exists(os.path.join(dirpath, "offsets.npy"))
    # registry backends (incl. tiered:<disk>) know their own files
    return backend_store_exists(backend, dirpath)


def _actual_entries(dirpath: str, backend: Optional[str]) -> Optional[int]:
    """Count the entries actually present in a directory's store;
    ``None`` when the backend cannot be counted offline.  Combinator
    selectors count their disk tier (the source of truth)."""
    disk = _disk_name(backend)
    if backend == "memory":
        return None                      # in-process only; nothing on disk
    if disk is None and backend not in ("dense", "log"):
        return None                      # selector unknown to this build
    if not _store_exists(dirpath, backend):
        return 0
    if disk is not None:
        b = BACKENDS[disk](dirpath)
        try:
            return len(b)
        finally:
            b.close()
    if backend == "dense":
        import numpy as np
        qpath = os.path.join(dirpath, "queries.json")
        if not os.path.exists(qpath):
            return 0
        with open(qpath) as f:
            rows = sorted(json.load(f).values())
        if not rows:
            return 0
        mat = np.lib.format.open_memmap(
            os.path.join(dirpath, "scores.npy"), mode="r")
        return int(np.sum(~np.isnan(mat[rows])))
    if backend == "log":
        import numpy as np
        return int(np.load(os.path.join(dirpath, "offsets.npy")).shape[0])
    return None


def _dir_size(dirpath: str) -> int:
    total = 0
    for base, _, files in os.walk(dirpath):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(base, f))
            except OSError:
                pass
    return total


def _fmt_time(ts: float) -> str:
    if not ts:
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


def _parse_age(text: str) -> float:
    text = text.strip().lower()
    units = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0, "w": 604800.0}
    mult = 1.0
    if text and text[-1] in units:
        mult = units[text[-1]]
        text = text[:-1]
    try:
        return float(text) * mult
    except ValueError:
        raise SystemExit(f"repro_torch cache: invalid age {text!r} "
                         f"(expected e.g. 30s, 12h, 7d)")


def _parse_size(text: str) -> int:
    text = text.strip().lower()
    units = {"k": 1024, "m": 1024 ** 2, "g": 1024 ** 3}
    mult = 1
    if text and text[-1] in units:
        mult = units[text[-1]]
        text = text[:-1]
    try:
        return int(float(text) * mult)
    except ValueError:
        raise SystemExit(f"repro_torch cache: invalid size {text!r} "
                         f"(expected e.g. 4096, 64K, 2M, 1G)")


def _load_manifest_doc(dirpath: str) -> Tuple[Optional[CacheManifest],
                                              Optional[str]]:
    try:
        return CacheManifest.load(dirpath), None
    except ManifestError as e:
        return None, str(e)


# ---------------------------------------------------------------------------
# ls
# ---------------------------------------------------------------------------

def _access_hits(dirpath: str) -> int:
    """Total recorded hits from the dir's access-stats sidecar."""
    from ..caching.economics import AccessStats
    return AccessStats.load(dirpath).total_hits()


def _budget_utilization(m: CacheManifest,
                        size_bytes: int) -> Optional[Dict[str, Any]]:
    """Fraction of each recorded budget in use (``None`` when the dir
    has no budget).  ``entries`` is manifest count / ``max_entries``;
    ``bytes`` is on-disk size / ``max_bytes``."""
    if not m.has_budget():
        return None
    out: Dict[str, Any] = {}
    if m.max_entries is not None:
        out["entries"] = round(m.entry_count / m.max_entries, 4) \
            if m.max_entries > 0 else None
    if m.max_bytes is not None:
        out["bytes"] = round(size_bytes / m.max_bytes, 4) \
            if m.max_bytes > 0 else None
    return out


def _sort_dirs(dirs: List[Dict[str, Any]], key: str) -> List[Dict[str, Any]]:
    if key == "size":
        return sorted(dirs, key=lambda r: (-r.get("size_bytes", 0),
                                           r["dir"]))
    if key == "age":                     # oldest last-use first
        return sorted(dirs, key=lambda r: (r.get("last_used_at", 0.0),
                                           r["dir"]))
    if key == "hits":
        return sorted(dirs, key=lambda r: (-r.get("hits", 0), r["dir"]))
    return dirs                          # "name": _cache_dirs order


def _collect(root: str) -> Dict[str, Any]:
    root = os.path.abspath(root)
    dirs = []
    for d in _cache_dirs(root):
        m, err = _load_manifest_doc(d)
        rec: Dict[str, Any] = {"dir": os.path.relpath(d, root) if d != root
                               else ".", "path": d}
        if err is not None:
            rec["error"] = err
        else:
            size = _dir_size(d)
            rec.update(family=m.family, backend=m.backend,
                       fingerprint=m.fingerprint,
                       transformer=m.transformer,
                       key_columns=m.key_columns,
                       value_columns=m.value_columns,
                       entry_count=m.entry_count,
                       created_at=m.created_at,
                       last_used_at=m.last_used_at,
                       size_bytes=size,
                       max_entries=m.max_entries,
                       max_bytes=m.max_bytes,
                       ttl_seconds=m.ttl_seconds,
                       hits=_access_hits(d),
                       budget_utilization=_budget_utilization(m, size))
        dirs.append(rec)
    plans = []
    for path, doc, err in iter_plan_manifests(root):
        rec = {"path": path}
        if err is not None:
            rec["error"] = err
        else:
            rec.update(plan_id=doc.get("plan_id"),
                       created_at=doc.get("created_at"),
                       pipelines=doc.get("pipelines", []),
                       n_nodes=len(doc.get("nodes", [])),
                       n_runs=len(doc.get("runs", [])))
        plans.append(rec)
    return {"root": root, "dirs": dirs, "plans": plans}


def cmd_ls(args) -> int:
    info = _collect(args.root)
    info["dirs"] = _sort_dirs(info["dirs"], getattr(args, "sort", "name"))
    if args.as_json:
        print(json.dumps(info, indent=2, sort_keys=True))
        return 0
    if not info["dirs"]:
        print(f"no cache directories under {info['root']}")
    for rec in info["dirs"]:
        if "error" in rec:
            print(f"{rec['dir']}: UNREADABLE ({rec['error']})")
            continue
        fp = rec["fingerprint"] or "-"
        budget = ""
        util = rec.get("budget_utilization")
        if util:
            parts = [f"{k}={v:.0%}" for k, v in sorted(util.items())
                     if v is not None]
            budget = f" budget[{' '.join(parts)}]" if parts else ""
        print(f"{rec['dir']}: {rec['family']}[{rec['backend']}] "
              f"entries={rec['entry_count']} "
              f"size={rec['size_bytes'] / 1024:.1f}KiB "
              f"hits={rec.get('hits', 0)}{budget} fp={fp} "
              f"last_used={_fmt_time(rec['last_used_at'])}")
        if rec.get("transformer"):
            print(f"    transformer: {rec['transformer']}")
    for rec in info["plans"]:
        if "error" in rec:
            print(f"plan {os.path.basename(rec['path'])}: UNREADABLE "
                  f"({rec['error']})")
            continue
        print(f"plan {rec['plan_id']}: {len(rec['pipelines'])} pipeline(s), "
              f"{rec['n_nodes']} node(s), {rec['n_runs']} recorded run(s), "
              f"created={_fmt_time(rec['created_at'] or 0)}")
    return 0


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------

def cmd_verify(args) -> int:
    root = os.path.abspath(args.root)
    report: List[Dict[str, Any]] = []
    manifests: Dict[str, Optional[CacheManifest]] = {}

    for d in _cache_dirs(root):
        rel = os.path.relpath(d, root) if d != root else "."
        problems: List[str] = []
        m, err = _load_manifest_doc(d)
        manifests[os.path.basename(d)] = m
        if err is not None:
            problems.append(err)
        else:
            actual = _actual_entries(d, m.backend)
            if actual is not None and actual != m.entry_count:
                problems.append(
                    f"entry count mismatch: store holds {actual}, "
                    f"manifest records {m.entry_count}")
        report.append({"dir": rel, "problems": problems})

    for path, doc, err in iter_plan_manifests(root):
        name = f"plan:{os.path.basename(path)}"
        problems = []
        if err is not None:
            problems.append(err)
        else:
            ver = doc.get("format_version")
            if not isinstance(ver, int) or ver > PLAN_MANIFEST_VERSION:
                problems.append(f"unsupported plan format_version {ver!r}")
            for node in doc.get("nodes", []):
                nd = node.get("dir")
                if not nd:
                    continue
                m = manifests.get(nd)
                if m is None:
                    if not os.path.isdir(os.path.join(root, nd)):
                        problems.append(
                            f"node {node.get('label')!r} references missing "
                            f"dir {nd!r} (gc'd or never populated)")
                    continue
                if m.fingerprint and node.get("fingerprint") \
                        and m.fingerprint != node["fingerprint"]:
                    problems.append(
                        f"node {node.get('label')!r}: plan fingerprint "
                        f"{node['fingerprint']} != dir manifest "
                        f"{m.fingerprint}")
        report.append({"dir": name, "problems": problems})

    failed = [r for r in report if r["problems"]]
    if args.as_json:
        print(json.dumps({"root": root, "checked": len(report),
                          "failed": len(failed), "report": report},
                         indent=2, sort_keys=True))
    else:
        for r in report:
            if r["problems"]:
                print(f"FAIL {r['dir']}")
                for p in r["problems"]:
                    print(f"    {p}")
            else:
                print(f"OK   {r['dir']}")
        print(f"verified {len(report)} item(s), {len(failed)} failure(s)")
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# warm (speculative precomputation)
# ---------------------------------------------------------------------------

def _load_queries_file(path: str) -> List[Dict[str, Any]]:
    """Rows for an explicit warming log: a ``.json`` list of row
    objects, or TSV ``qid<TAB>query`` lines."""
    if path.endswith(".json"):
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        rows = doc if isinstance(doc, list) else doc.get("rows")
        if not isinstance(rows, list):
            raise SystemExit(f"repro_torch cache warm: {path!r} must hold a JSON "
                             f"list of row objects (or {{'rows': [...]}})")
        return rows
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            qid, sep, query = line.partition("\t")
            if not sep:
                raise SystemExit(f"repro_torch cache warm: {path!r} line "
                                 f"{line!r} is not 'qid<TAB>query'")
            rows.append({"qid": qid, "query": query})
    return rows


def cmd_warm(args) -> int:
    from ..caching.provenance import set_digest_device
    from ..caching.warming import warm_scenario
    if args.device == "cpu":
        set_digest_device("cpu")         # plan fingerprints on the CPU too
    queries = _load_queries_file(args.queries) if args.queries else None
    rep = warm_scenario(
        args.scenario, os.path.abspath(args.cache_dir),
        queries=queries, budget=args.budget, backend=args.backend,
        requests=args.requests, clients=args.clients, scale=args.scale,
        cutoff=args.cutoff, num_results=args.num_results, seed=args.seed,
        batch_size=args.batch_size, chunk_rows=args.chunk_rows,
        device=args.device)
    if args.as_json:
        print(json.dumps(rep, indent=2, sort_keys=True))
    else:
        print(f"warmed {rep['queries_warmed']} query(s) for scenario "
              f"{rep['scenario']!r} into {rep['cache_dir']} "
              f"(precomputed={rep['cache_misses']} "
              f"already-cached={rep['cache_hits']}, "
              f"{rep['wall_s']:.2f}s)")
    return 0


# ---------------------------------------------------------------------------
# evict (budget enforcement)
# ---------------------------------------------------------------------------

def cmd_evict(args) -> int:
    from ..caching.economics import CacheBudget, enforce_dir
    root = os.path.abspath(args.root)
    budget = CacheBudget(
        max_entries=args.budget,
        max_bytes=_parse_size(args.max_bytes)
        if args.max_bytes is not None else None,
        ttl_seconds=_parse_age(args.ttl)
        if args.ttl is not None else None)
    dirs = _cache_dirs(root)
    if not dirs:
        print(f"no cache directories under {root}")
        return 0
    report = []
    for d in dirs:
        rel = os.path.relpath(d, root) if d != root else "."
        if args.record and not budget.empty():
            m, err = _load_manifest_doc(d)
            if m is not None and budget.record_in(m):
                m.save(d)
        rep = enforce_dir(d, None if budget.empty() else budget)
        report.append({"dir": rel, **rep})
    if args.as_json:
        print(json.dumps({"root": root, "dirs": report},
                         indent=2, sort_keys=True))
        return 0
    for rec in report:
        if "skipped" in rec:
            print(f"{rec['dir']}: skipped ({rec['skipped']})")
            continue
        print(f"{rec['dir']}: evicted {rec['evicted']} "
              f"({rec['expired']} expired), {rec['entries_before']} -> "
              f"{rec['entries_after']} entrie(s), "
              f"{rec['evicted_bytes'] / 1024:.1f}KiB freed"
              + (f", {rec['unevictable']} unevictable"
                 if rec.get("unevictable") else ""))
    return 0


# ---------------------------------------------------------------------------
# gc
# ---------------------------------------------------------------------------

def cmd_gc(args) -> int:
    root = os.path.abspath(args.root)
    if args.older_than is None and not args.orphaned:
        raise SystemExit("repro_torch cache gc: nothing selected — pass "
                         "--older-than and/or --orphaned")
    dirs = [d for d in _cache_dirs(root) if d != root]
    victims: Dict[str, str] = {}

    if args.older_than is not None:
        cutoff = time.time() - _parse_age(args.older_than)
        for d in dirs:
            m, err = _load_manifest_doc(d)
            if m is None:
                continue                 # unreadable: verify's business
            last = m.last_used_at or m.created_at
            if last <= cutoff:
                victims[d] = (f"last used {_fmt_time(last)}, older than "
                              f"{args.older_than}")

    if args.orphaned:
        referenced = set()
        for _, doc, _err in iter_plan_manifests(root):
            if doc:
                referenced.update(n.get("dir") for n in doc.get("nodes", [])
                                  if n.get("dir"))
        for d in dirs:
            if os.path.basename(d) not in referenced:
                victims.setdefault(d, "referenced by no plan manifest")

    if not victims:
        print("nothing to collect")
        return 0
    freed = 0
    for d in sorted(victims):
        size = _dir_size(d)
        freed += size
        verb = "removing" if args.yes else "would remove"
        print(f"{verb} {d} ({victims[d]}; {size / 1024:.1f}KiB)")
        if args.yes:
            shutil.rmtree(d, ignore_errors=True)
    action = "freed" if args.yes else "would free"
    print(f"{action} {freed / 1024:.1f}KiB across {len(victims)} dir(s)"
          + ("" if args.yes else " — re-run with --yes to delete"))
    return 0


# ---------------------------------------------------------------------------
# export / import
# ---------------------------------------------------------------------------

def _add_bytes(tar: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    info.mtime = int(time.time())
    tar.addfile(info, io.BytesIO(data))


def _safe_extractall(tar: tarfile.TarFile, dest: str, members=None) -> None:
    # the extraction ``filter=`` kwarg is absent on 3.10.<12 / 3.11.<4
    if hasattr(tarfile, "data_filter"):
        tar.extractall(dest, members=members, filter="data")
    else:                                # pragma: no cover - old stdlib
        tar.extractall(dest, members=members)


def cmd_export(args) -> int:
    src = os.path.abspath(args.cache_dir)
    m, err = _load_manifest_doc(src)
    if err is not None:
        raise SystemExit(f"repro_torch cache export: {err}")
    if m is None:
        raise SystemExit(f"repro_torch cache export: {src!r} has no "
                         f"{MANIFEST_NAME} — not a provenance-aware cache "
                         f"directory")
    entries: Optional[List[Tuple[bytes, bytes]]] = None
    if m.backend in BACKENDS and m.backend != "memory" \
            and _store_exists(src, m.backend):
        backend = BACKENDS[m.backend](src)
        try:
            entries = backend.items()
        except NotImplementedError:
            entries = None               # e.g. pickle: raw-file export
        finally:
            backend.close()
    mode = "entries" if entries is not None else "raw"
    meta = {"format_version": EXPORT_FORMAT_VERSION, "mode": mode,
            "exported_at": time.time(),
            "n_entries": len(entries) if entries is not None
            else m.entry_count}
    with tarfile.open(args.out, "w") as tar:
        _add_bytes(tar, "export.json",
                   json.dumps(meta, indent=2, sort_keys=True).encode())
        with open(manifest_path(src), "rb") as f:
            _add_bytes(tar, MANIFEST_NAME, f.read())
        if mode == "entries":
            _add_bytes(tar, "entries.pkl", pickle.dumps(
                entries, protocol=pickle.HIGHEST_PROTOCOL))
        else:
            for base, _, files in os.walk(src):
                for fname in files:
                    full = os.path.join(base, fname)
                    rel = os.path.relpath(full, src)
                    if rel == MANIFEST_NAME:
                        continue
                    tar.add(full, arcname=os.path.join("raw", rel))
    print(f"exported {meta['n_entries']} entrie(s) from {src} "
          f"({mode} mode, fp={m.fingerprint or '-'}) -> {args.out}")
    return 0


def _read_member(tar: tarfile.TarFile, name: str) -> bytes:
    f = tar.extractfile(name)
    if f is None:
        raise SystemExit(f"repro_torch cache import: artifact is missing {name!r}")
    return f.read()


def cmd_import(args) -> int:
    dest = os.path.abspath(args.dest)
    with tarfile.open(args.artifact) as tar:
        meta = json.loads(_read_member(tar, "export.json"))
        if meta.get("format_version", 0) > EXPORT_FORMAT_VERSION:
            raise SystemExit("repro_torch cache import: artifact written by a "
                             "newer exporter")
        man_bytes = _read_member(tar, MANIFEST_NAME)
        with tempfile.TemporaryDirectory() as td:
            with open(manifest_path(td), "wb") as f:
                f.write(man_bytes)
            try:
                imported = CacheManifest.load(td)
            except ManifestError as e:
                raise SystemExit(f"repro_torch cache import: {e}")

        existing, err = (None, None)
        if os.path.isdir(dest):
            existing, err = _load_manifest_doc(dest)
            if err is not None and not args.force:
                raise SystemExit(f"repro_torch cache import: destination has a "
                                 f"corrupted manifest ({err}); pass --force "
                                 f"to overwrite")
        if existing is not None and existing.fingerprint \
                and imported.fingerprint \
                and existing.fingerprint != imported.fingerprint \
                and not args.force:
            raise SystemExit(
                f"repro_torch cache import: fingerprint mismatch — destination "
                f"records {existing.fingerprint}, artifact carries "
                f"{imported.fingerprint}; this is not the same pipeline "
                f"position (pass --force to import anyway)")

        if meta["mode"] == "entries":
            backend_name = args.backend or imported.backend
            if backend_name not in BACKENDS:
                raise SystemExit(f"repro_torch cache import: unknown backend "
                                 f"{backend_name!r}; registered: "
                                 f"{', '.join(sorted(BACKENDS))}")
            entries = pickle.loads(_read_member(tar, "entries.pkl"))
            os.makedirs(dest, exist_ok=True)
            backend = BACKENDS[backend_name](dest)
            try:
                backend.put_many(entries)
                n = len(backend)
            finally:
                backend.close()
            imported.backend = backend_name
            imported.entry_count = int(n)
            imported.last_used_at = time.time()
            imported.save(dest)
        else:
            if os.path.isdir(dest) and os.listdir(dest) and not args.force:
                raise SystemExit(f"repro_torch cache import: destination {dest!r} "
                                 f"is not empty (pass --force)")
            os.makedirs(dest, exist_ok=True)
            members = [m_ for m_ in tar.getmembers()
                       if m_.name.startswith("raw/")]
            for m_ in members:
                m_.name = os.path.relpath(m_.name, "raw")
            _safe_extractall(tar, dest, members=members)
            imported.last_used_at = time.time()
            imported.save(dest)

    print(f"imported {meta['n_entries']} entrie(s) into {dest} "
          f"({meta['mode']} mode, fp={imported.fingerprint or '-'})")
    return 0
