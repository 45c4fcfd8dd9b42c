#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one output line or more each, the JSON result last:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: every kernel under ``src/repro_torch/kernels/*/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card —
   ``dense_topk`` at the reference's test shapes, a duplicated-rows tie
   case and the main path's shape; ``cachekey_hash`` on the
   reference's sweep, provenance rows and a wide batch, bit for bit,
   and ``digest_bytes`` through it against the host FNV loop — with
   timings;
4. main path: the retrieve-and-rerank Experiment with BM25 and dense
   retrieval over ``msmarco_like(2, scale=1.0)`` at the cross-encoder's
   full width, once on the kernel path and once on the plain
   ``"torch"`` backend, whose means must agree;
5. Table 2: ``bm25 % k >> text >> mono % 10 >> duo`` for k in 20, 50,
   100, 200 in the paper's four settings (no sharing; prefix
   precomputation through the plan compiler, whose node fingerprints
   the ``cachekey_hash`` kernel digests; plus a cold, then a hot
   ``ScorerCache`` around Mono), with the work each setting saves and
   means equal to setting (1);
6. the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

Any failure raises and the script exits non-zero.  Without a CUDA
device, or outside a checkout, it exits 1 and prints no result.
"""
from __future__ import annotations

import collections
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

CUTS = (20, 50, 100, 200)
MEASURES = ["nDCG@10", "MAP"]
NAMES = [f"bm25%{k}" for k in CUTS] + ["dense%200", "bm25|dense"]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
# 32-bit integer xor/multiply: 64 per SM and clock, 132 SMs, 1.98 GHz
INT32_OP_PER_S = 64 * 132 * 1.98e9
NEAR_TIE = 1e-5
# (Q, N, d, k, dtype) of the reference's dense_topk sweep
# (tests/test_kernels.py DENSE_SWEEP)
SWEEP = [(8, 256, 32, 10, "float32"), (5, 300, 33, 7, "float32"),
         (16, 1024, 64, 100, "float32"), (3, 130, 128, 130, "float32"),
         (8, 512, 64, 16, "bfloat16"), (1, 8, 16, 3, "float32")]
# (N, L) of the reference's cachekey_hash sweep (tests/test_kernels.py),
# then provenance rows (N = 1) and a wide batch
HASH_SWEEP = [(1, 1), (10, 7), (256, 16), (300, 64), (1, 64), (1, 4096),
              (65536, 64)]
TABLE2_SETTINGS = [(False, None), (True, None), (True, "cold"),
                   (True, "hot")]


def log(msg: str) -> None:
    print(msg, flush=True)


def check_topk(torch, dense_topk, dense_topk_ref, q, c, k, tol):
    """Kernel against plain version on the same inputs.  Returns
    (max_abs_err, near-tie ranks where the indices differ); raises on a
    value beyond ``tol`` or an index mismatch that is not a near tie."""
    kv, ki = dense_topk(q, c, k=k)
    rv, ri = dense_topk_ref(q, c, k=k)
    torch.cuda.synchronize()
    err = float((kv - rv).abs().max())
    if not err <= tol:
        raise AssertionError(f"dense_topk values differ by {err} > {tol}")
    rv, ri, ki = rv.cpu(), ri.cpu(), ki.cpu()
    near = 0
    for r, j in (ki != ri).nonzero().tolist():
        nbrs = [rv[r, jj] for jj in (j - 1, j + 1) if 0 <= jj < k]
        if not any(abs(float(rv[r, j] - x)) < NEAR_TIE for x in nbrs):
            raise AssertionError(f"dense_topk index differs at row {r} "
                                 f"rank {j}: {int(ki[r, j])} vs "
                                 f"{int(ri[r, j])}, not a near tie")
        near += 1
    return err, near


def time_ms(torch, fn, reps: int = 20, warmup: int = 3,
            flush_l2: bool = True) -> float:
    """Median ms of ``fn`` on the card (CUDA events), with the 50 MB L2
    flushed before each timed call, as a retrieval call finds it
    (``flush_l2=False``: the inputs stay in L2 from the last call)."""
    flush = torch.empty(64 << 20 if flush_l2 else 0, dtype=torch.uint8,
                        device="cuda")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def setup_main_path(torch) -> SimpleNamespace:
    """Corpus, indexes and models of the main path on the card; ``run(
    backend)`` runs its Experiment with that dense-retrieval backend."""
    from repro_torch.core import Experiment
    from repro_torch.ir import (DenseEncoder, DenseIndex, InvertedIndex,
                                TextLoader, msmarco_like)
    from repro_torch.models.cross_encoder import (DuoScorer, EncoderConfig,
                                                  MonoScorer)
    t = time.perf_counter()
    corpus = msmarco_like(2, scale=1.0)
    topics, qrels = corpus.get_topics(), corpus.get_qrels()
    log(f"setup: corpus {len(corpus.docs)} docs, {len(topics)} queries in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    index = InvertedIndex.build(corpus.get_corpus_iter())
    tl = TextLoader(corpus.text_map())
    log(f"setup: bm25 index in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    dense_enc = DenseEncoder(EncoderConfig(name="dense"), seed=7)
    dense_index = DenseIndex(dense_enc).index(corpus.get_corpus_iter())
    torch.cuda.synchronize()
    log(f"setup: dense index {tuple(dense_index.matrix.shape)} on "
        f"{dense_index.matrix.device} in {time.perf_counter() - t:.1f} s")
    mono = MonoScorer(EncoderConfig())
    duo = DuoScorer(EncoderConfig(), max_docs=10)
    for enc in (dense_enc.encoder, mono.encoder, duo.encoder):
        assert all(p.device.type == "cuda" for p in enc.parameters())
    assert dense_index.matrix.device.type == "cuda"

    def run(backend: str):
        bm25 = index.bm25(num_results=200)
        dense = dense_index.retriever(200, backend=backend)
        systems = ([bm25 % k >> tl >> mono % 10 >> duo for k in CUTS]
                   + [dense % 200 >> tl >> mono % 10 >> duo,
                      (bm25 % 100 | dense % 100) >> tl >> mono % 10 >> duo])
        return Experiment(systems, topics, qrels, MEASURES, names=NAMES)

    return SimpleNamespace(topics=topics, qrels=qrels, index=index, tl=tl,
                           dense_enc=dense_enc, dense_index=dense_index,
                           mono=mono, duo=duo, run=run)


def hash_bound(n: int, L: int):
    """(bound ms, what bounds it) of cachekey_hash on [n, L] tokens:
    each token read once and each [n, 2] lane pair written once, against
    an xor and a multiply per byte and lane (16 per token)."""
    t_bytes = (4 * n * L + 8 * n) / HBM_BYTES_PER_S
    t_ops = 16 * n * L / INT32_OP_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def check_cachekey_hash(torch, card: str) -> dict:
    """The cachekey_hash kernel against its plain version on the card,
    bit for bit, and digest_bytes through it against the host FNV loop.
    Returns the timings at the shapes timed."""
    import numpy as np

    import repro_torch.caching.provenance as prov
    from repro_torch.kernels.cachekey_hash import (cachekey_hash,
                                                   cachekey_hash_op,
                                                   cachekey_hash_ref)
    gen = torch.Generator().manual_seed(1)
    timed = {}
    for n, L in HASH_SWEEP:
        t = torch.randint(-2**31, 2**31, (n, L), generator=gen,
                          dtype=torch.int64).to(torch.int32).to("cuda")
        got = cachekey_hash_op(t)
        want = cachekey_hash_ref(t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            raise AssertionError(f"cachekey_hash N={n} L={L}: {bad} rows "
                                 f"differ from the plain version")
        line = f"kernels: cachekey_hash N={n} L={L}: bit-identical"
        if (n, L) in ((1, 64), (65536, 64)):
            ms = time_ms(torch, lambda: cachekey_hash(t))
            plain_ms = time_ms(torch, lambda: cachekey_hash_ref(t))
            bound_ms, bound_by = hash_bound(n, L)
            warm_ms = time_ms(torch, lambda: cachekey_hash(t),
                              flush_l2=False)
            timed[(n, L)] = (ms, plain_ms, bound_ms, bound_by)
            line += (f"; kernel {ms:.4f} ms ({warm_ms:.4f} ms with the "
                     f"input in L2), plain {plain_ms:.4f} ms, bound "
                     f"{bound_ms * 1e3:.4f} us ({bound_by}), no library "
                     f"call; {card}")
        log(line)
    rng = np.random.default_rng(2)
    n_payloads = 300
    for _ in range(n_payloads):
        data = rng.bytes(int(rng.integers(0, 20001)))
        buf = len(data).to_bytes(8, "little") + data
        buf += b"\x00" * ((-len(buf)) % 4)
        words = np.frombuffer(buf, dtype="<u4")
        words = np.concatenate([words, np.zeros((-len(words)) % 64,
                                                dtype="<u4")])
        if prov.digest_bytes(data) != prov._host_digest(words).hex():
            raise AssertionError(f"digest_bytes of {len(data)} bytes "
                                 f"differs from the host FNV loop")
    log(f"kernels: digest_bytes through cachekey_hash equals the host "
        f"FNV loop on {n_payloads} payloads of 0-20,000 bytes "
        f"({cachekey_hash.launches} launches so far)")
    # what one provenance digest costs the host end to end (copy in,
    # pad, launch, copy out with its sync), at a fingerprint's size
    payload = rng.bytes(200)
    for _ in range(10):
        prov.digest_bytes(payload)
    t = time.perf_counter()
    for _ in range(200):
        prov.digest_bytes(payload)
    log(f"kernels: digest_bytes of 200 bytes (64 words) on the card: "
        f"{(time.perf_counter() - t) / 200 * 1e6:.1f} us per call, host "
        f"clock, mean of 200; {card}")
    return timed


def run_table2(torch, mp) -> dict:
    """The paper's Table 2 in its four settings through the port's entry
    points; raises unless the claims hold and every setting's means
    equal setting (1)'s.  Returns the counts and the digests' word
    counts seen in setting (2)."""
    import repro_torch.caching.provenance as prov
    from repro_torch.caching import ScorerCache
    from repro_torch.core import Experiment
    from repro_torch.kernels.cachekey_hash import cachekey_hash

    names = [f"k={k}" for k in CUTS]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    cache_root = tempfile.mkdtemp(prefix="table2-scorer-cache-",
                                  dir=str(build))
    rows, words_seen = [], collections.Counter()
    digest = prov._kernel_digest
    try:
        for setting, (pre, cached) in enumerate(TABLE2_SETTINGS, start=1):
            bm25 = mp.index.bm25(num_results=max(CUTS))
            seen = [0]
            orig = bm25.transform

            def counting(inp, _orig=orig, _seen=seen):
                _seen[0] += len(inp)
                return _orig(inp)
            bm25.transform = counting
            cache = None if cached is None else ScorerCache(
                str(Path(cache_root) / "mono"), mp.mono, backend="sqlite")
            stage = mp.mono if cache is None else cache
            systems = [bm25 % k >> mp.tl >> stage % 10 >> mp.duo
                       for k in CUTS]
            mono0 = mp.mono.invocations
            if setting == 2:             # the digests' row widths
                def recording(words):
                    words_seen[len(words)] += 1
                    return digest(words)
                prov._kernel_digest = recording
            cachekey_hash.launches = 0
            t = time.perf_counter()
            res = Experiment(systems, mp.topics, mp.qrels, MEASURES,
                             precompute_prefix=pre,
                             precompute_mode="plan", names=names)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = cachekey_hash.launches
            prov._kernel_digest = digest
            hits, misses = (cache.stats.hits, cache.stats.misses) \
                if cache is not None else (None, None)
            if cache is not None:
                cache.close()
            st = res.precompute
            rows.append({
                "setting": setting, "wall_s": wall,
                "bm25_queries": seen[0],
                "mono_pairs": mp.mono.invocations - mono0,
                "cache_hits": hits, "cache_misses": misses,
                "nodes_executed": st.nodes_executed if st else None,
                "nodes_planned": st.nodes_planned if st else None,
                "cachekey_hash_launches": launches, "res": res})
            log("table2: " + json.dumps(
                {k: v for k, v in rows[-1].items() if k != "res"}))
    finally:
        prov._kernel_digest = digest
        shutil.rmtree(cache_root, ignore_errors=True)

    base = rows[0]["res"]
    worst = 0.0
    for r in rows[1:]:
        for n in names:
            for m in MEASURES:
                if abs(r["res"].means[n][m] - base.means[n][m]) > 1e-6:
                    raise AssertionError(
                        f"table2 setting {r['setting']} {n} {m}: "
                        f"{r['res'].means[n][m]} vs setting 1 "
                        f"{base.means[n][m]}")
                for qid, v in base.per_query[n][m].items():
                    worst = max(worst,
                                abs(r["res"].per_query[n][m][qid] - v))
    log(f"table2: means of settings 2-4 equal setting 1's to 1e-6; "
        f"largest per-query difference {worst:.3g}; setting 1 "
        f"k=200 {json.dumps(base.means['k=200'])}")
    if not all(r["bm25_queries"] < rows[0]["bm25_queries"]
               for r in rows[1:]):
        raise AssertionError("table2: precomputation must invoke BM25 "
                             "fewer times than setting 1")
    if rows[3]["mono_pairs"] != 0 or rows[3]["cache_misses"] != 0:
        raise AssertionError("table2: the hot cache must score 0 pairs")
    if rows[2]["mono_pairs"] > rows[1]["mono_pairs"]:
        raise AssertionError("table2: the cold cache scored more pairs "
                             "than setting 2")
    if rows[1]["cachekey_hash_launches"] < 1:
        raise AssertionError("table2: the plan compiler never launched "
                             "cachekey_hash")
    if rows[0]["cachekey_hash_launches"] != 0:
        raise AssertionError("table2: setting 1 has no plan, yet "
                             "digests ran")
    log(f"table2: digest row widths in setting 2 (words: count) "
        f"{dict(sorted(words_seen.items()))}")
    # compiling setting (2)'s plan: lowering, passes and the node
    # fingerprints, with the digests on the card and on the CPU
    from repro_torch.core import ExecutionPlan
    systems = [mp.index.bm25(num_results=max(CUTS)) % k >> mp.tl
               >> mp.mono % 10 >> mp.duo for k in CUTS]
    for device in ("cuda", "cpu", "cuda"):
        prev = prov.set_digest_device(device)
        try:
            t = time.perf_counter()
            ExecutionPlan(systems)
            torch.cuda.synchronize()
            log(f"table2: compiling setting 2's plan with the digests on "
                f"{device}: {(time.perf_counter() - t) * 1e3:.2f} ms")
        finally:
            prov.set_digest_device(prev)
    return {"rows": rows, "words": words_seen,
            "launches": sum(r["cachekey_hash_launches"] for r in rows)}


def start(torch) -> bool:
    """False, with the reason on stderr, unless a CUDA device and the
    checkout's ``src/repro_torch`` are there; then puts ``src`` on the
    path and sets the reference's numerics (full fp32 products, no
    TF32)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return False
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return False
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return True


def main() -> int:
    import torch
    if not start(torch):
        return 1

    from repro_torch.kernels import _build
    from repro_torch.kernels.cachekey_hash import (cachekey_hash,
                                                   cachekey_hash_ref)
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_ref

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    log(card)

    # -- 2. build ----------------------------------------------------------
    t = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "Used" in line:
                log(f"build: {name}: {line.strip()}")

    mp = setup_main_path(torch)

    # -- 3. kernels against their plain versions ---------------------------
    gen = torch.Generator().manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for Q, N, d, k, dt in SWEEP:
        q = torch.randn(Q, d, generator=gen).to("cuda", dtypes[dt])
        c = torch.randn(N, d, generator=gen).to("cuda", dtypes[dt])
        tol = 2e-5 if dt == "float32" else 2e-2
        err, near = check_topk(torch, dense_topk, dense_topk_ref, q, c, k,
                               tol)
        log(f"kernels: dense_topk Q={Q} N={N} d={d} k={k} {dt}: "
            f"max_abs_err {err:.3g} (tol {tol}), near-tie ranks {near}")
    q = torch.randn(4, 32, generator=gen).to("cuda")
    base = torch.randn(20, 32, generator=gen).to("cuda")
    c = torch.cat([base, base])                   # every doc duplicated
    err, near = check_topk(torch, dense_topk, dense_topk_ref, q, c, 40, 2e-5)
    _, idx = dense_topk(q, c, k=40)
    pos = idx.cpu().argsort(dim=1)                # rank of each doc
    if near or not bool((pos[:, :20] < pos[:, 20:]).all()):
        raise AssertionError("dense_topk tie order: lower index must win")
    log(f"kernels: dense_topk duplicated rows: max_abs_err {err:.3g}, "
        f"near-tie ranks {near}, lower index first")

    q_main = mp.dense_enc.encode(mp.topics["query"].tolist())
    c_main = mp.dense_index.matrix
    k_main = max(CUTS)
    (Q, d), N = q_main.shape, c_main.shape[0]
    err_main, near = check_topk(torch, dense_topk, dense_topk_ref, q_main,
                                c_main, k_main, 2e-5)
    ms = time_ms(torch, lambda: dense_topk(q_main, c_main, k=k_main))
    plain_ms = time_ms(torch, lambda: dense_topk_ref(q_main, c_main,
                                                     k=k_main))
    library_ms = time_ms(torch, lambda: torch.topk(q_main @ c_main.T,
                                                   k_main, dim=1))
    n_bytes = (Q * d + N * d) * 4 + Q * k_main * 8
    n_flop = 2 * Q * N * d
    bound_ms = 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                         n_flop / FP32_FLOP_PER_S)
    bound_by = "bytes" if n_bytes / HBM_BYTES_PER_S >= \
        n_flop / FP32_FLOP_PER_S else "operations"
    log(f"kernels: dense_topk main shape Q={Q} N={N} d={d} k={k_main}: "
        f"max_abs_err {err_main:.3g}, near-tie ranks {near}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.topk(q @ c.T) "
        f"{library_ms:.4f} ms (yardstick only), bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}); {card}")
    hash_timed = check_cachekey_hash(torch, card)

    # -- 4. the main path ---------------------------------------------------
    dense_topk.launches = 0
    t = time.perf_counter()
    res = mp.run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dense_topk.launches
    log(f"main: {json.dumps(res.means)}")
    log(f"main: wall {wall:.1f} s, dense_topk.launches {launches}, "
        f"mono pairs {mp.mono.invocations}, duo pairs {mp.duo.invocations}")
    log("main: seconds per system " + json.dumps(
        {n: round(s, 3) for n, s in res.times_s.items()}))
    if launches < 1:
        raise AssertionError("the main path never launched dense_topk")

    t = time.perf_counter()
    plain = mp.run("torch")
    for n in NAMES:
        for m in MEASURES:
            if abs(res.means[n][m] - plain.means[n][m]) > 1e-6:
                raise AssertionError(
                    f"{n} {m}: kernel path {res.means[n][m]} vs plain "
                    f"path {plain.means[n][m]}")
    log(f"main: backend='torch' means equal to 1e-6 "
        f"({time.perf_counter() - t:.1f} s)")

    # -- 5. Table 2 ---------------------------------------------------------
    t = time.perf_counter()
    t2 = run_table2(torch, mp)
    log(f"table2: four settings in {time.perf_counter() - t:.1f} s, "
        f"cachekey_hash.launches {t2['launches']}")

    # the hash kernel at the main path's most frequent digest width
    L_main = t2["words"].most_common(1)[0][0]
    tok = torch.randint(-2**31, 2**31, (1, L_main),
                        generator=torch.Generator().manual_seed(3),
                        dtype=torch.int64).to(torch.int32).to("cuda")
    if not torch.equal(cachekey_hash(tok), cachekey_hash_ref(tok)):
        raise AssertionError(f"cachekey_hash N=1 L={L_main} differs")
    h_ms = time_ms(torch, lambda: cachekey_hash(tok))
    h_plain = time_ms(torch, lambda: cachekey_hash_ref(tok))
    h_bound, h_by = hash_bound(1, L_main)
    log(f"kernels: cachekey_hash main shape N=1 L={L_main}: kernel "
        f"{h_ms:.4f} ms, plain {h_plain:.4f} ms, bound "
        f"{h_bound * 1e3:.4f} us ({h_by}); timed at (1, 64): "
        f"{hash_timed[(1, 64)][0]:.4f} ms, at (65536, 64): "
        f"{hash_timed[(65536, 64)][0]:.4f} ms; {card}")

    # -- 6. result lines ----------------------------------------------------
    log(json.dumps({"kernels": [{
        "name": "dense_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/dense_topk/csrc/dense_topk.cu",
        "replaces": "src/repro/kernels/dense_topk/kernel.py:96",
        "launches": launches, "max_abs_err": err_main, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}, {
        "name": "cachekey_hash", "route": "cuda",
        "source": "src/repro_torch/kernels/cachekey_hash/csrc/"
                  "cachekey_hash.cu",
        "replaces": "src/repro/kernels/cachekey_hash/kernel.py:54",
        "launches": t2["launches"], "max_abs_err": 0, "ms": h_ms,
        "plain_ms": h_plain, "bound_ms": h_bound, "bound_by": h_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
