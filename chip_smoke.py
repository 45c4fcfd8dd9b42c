#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one output line or more each, the JSON result last:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: every kernel under ``src/repro_torch/kernels/*/csrc`` with nvcc,
   and ptxas's registers, shared memory and spills of each kernel;
3. kernels: each kernel against its plain PyTorch version on the card —
   ``dense_topk`` at the reference's test shapes, a duplicated-rows tie
   case, copies of docs in other corpus splits (exact), exact ties at
   k 2,000 on the select path, the main path's shape at k 200, 100 and
   2,000 and MS MARCO passage's corpus size at k 200 and 2,000;
   ``cachekey_hash`` on the
   reference's sweep, provenance rows and a wide batch, bit for bit,
   ``digest_bytes`` through it against the host FNV loop and
   ``digest_many`` against ``digest_bytes``; then
   ``flash_attention``, ``embedding_bag`` and ``bm25_block`` driven
   through their ``*_op`` entry points at the reference's sweeps,
   ``benchmarks/kernels_bench.py``'s shapes and the repo's model
   shapes (smollm-360m's prefill and its decode step at B 128 and B 1,
   MIND's serving batch), each attention row on the path ``path_for``
   must pick (``"wgmma"``, ``"decode"`` or ``"simt"``),
   and ``bm25_block`` over Table 2's 53 queries against
   ``BM25Retriever.score_query`` — with timings, the plain version's
   and the PyTorch library call's where there is one, and for the small
   kernels (``cachekey_hash``, ``bm25_block``, ``embedding_bag``) the
   device-only time from ``torch.profiler`` beside the CUDA-event time;
   every ``embedding_bag`` row also prints the plan it took and its
   share of the bytes bound, and MIND's rows (f32 and bf16) the host's
   enqueue split into the bare ``ctypes`` call and the rest of the
   wrapper, the kernels the profiler counts in one
   ``embedding_bag_op(..., combiner="mean")`` call, two calls equal bit
   for bit and small-integer inputs equal to the plain version bit for
   bit;
4. main path: the retrieve-and-rerank Experiment with BM25 and dense
   retrieval over ``msmarco_like(2, scale=1.0)`` at the cross-encoder's
   full width, once on the kernel path and once on the plain
   ``"torch"`` backend, whose means must agree;
5. Table 2: ``bm25 % k >> text >> mono % 10 >> duo`` for k in 20, 50,
   100, 200 in the paper's four settings (no sharing; prefix
   precomputation through the plan compiler, whose node fingerprints
   the ``cachekey_hash`` kernel digests; plus a cold, then a hot
   ``ScorerCache`` around Mono), with the work each setting saves and
   means equal to setting (1); ``cachekey_hash`` launches per plan (one
   per (level, length) group of its batched digests) and per run, the
   host ms of a plan's digests batched and row by row, and a check that
   both give the same node fingerprints and plan id;
6. Table 2 through the planner: the four bm25 systems by
   ``Experiment(..., precompute_mode="plan", cache_dir=...)``, cold then
   hot, with the work each run does (BM25 queries, Mono and Duo pairs,
   cache hits and misses, plan nodes executed, node cache directories,
   ``cachekey_hash`` launches) and the hot run's host seconds per plan
   node; then the main path's six systems the same way, whose dense
   retrievers launch ``dense_topk`` cold and are served by their
   ``RetrieverCache`` hot; means equal to the uncached runs';
7. the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

Any failure raises and the script exits non-zero.  Without a CUDA
device, or outside a checkout, it exits 1 and prints no result.
"""
from __future__ import annotations

import collections
import json
import math
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
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
# 32-bit integer xor/multiply: 64 per SM and clock, 132 SMs, 1.98 GHz
CLOCK_HZ = 1.98e9
INT32_OP_PER_S = 64 * 132 * CLOCK_HZ
NEAR_TIE = 1e-5
# MS MARCO passage's corpus (8,841,823 passages); its row is timed over
# fewer repetitions, since the plain version sorts 53 x 8.8M scores
MSMARCO_PASSAGES = 8_841_823
MSMARCO_REPS = 5
# (Q, N, d, k, dtype) of the reference's dense_topk sweep
# (tests/test_kernels.py DENSE_SWEEP)
SWEEP = [(8, 256, 32, 10, "float32"), (5, 300, 33, 7, "float32"),
         (16, 1024, 64, 100, "float32"), (3, 130, 128, 130, "float32"),
         (8, 512, 64, 16, "bfloat16"), (1, 8, 16, 3, "float32")]
# (N, L) of the reference's cachekey_hash sweep (tests/test_kernels.py),
# then provenance rows (N = 1) and a wide batch
HASH_SWEEP = [(1, 1), (10, 7), (256, 16), (300, 64), (1, 64), (1, 4096),
              (65536, 64), (513, 100), (1000, 37)]
# k of the select path's dense_topk rows (above the filter path's 1,024)
BIG_K = 2000
TABLE2_SETTINGS = [(False, None), (True, None), (True, "cold"),
                   (True, "hot")]
# (label, B, H, K, Sq, Sk, hd, causal, dtype, path): the reference's
# flash_attention sweep (tests/test_kernels.py FLASH_SWEEP), the shapes
# of benchmarks/kernels_bench.py, then smollm-360m's heads
# (configs/smollm_360m.py) at train_4k's length and a decode_32k step
# (configs/base.py LM_SHAPES) at the config's batch and at one sequence;
# the prefill is the main shape.  ``path`` is the kernel path_for must
# pick
FLASH_ROWS = [("sweep", 1, 2, 2, 64, 64, 32, True, "float32", "simt"),
              ("sweep", 2, 4, 2, 128, 128, 64, True, "float32", "simt"),
              ("sweep", 1, 8, 1, 128, 128, 64, True, "float32", "simt"),
              ("sweep", 2, 4, 4, 96, 96, 32, True, "float32", "simt"),
              ("sweep", 1, 2, 2, 64, 256, 64, True, "float32", "simt"),
              ("sweep", 1, 4, 2, 128, 128, 64, False, "float32", "simt"),
              ("sweep", 1, 2, 2, 128, 128, 128, True, "bfloat16", "wgmma"),
              ("kernels_bench", 1, 8, 2, 512, 512, 64, True, "float32",
               "simt"),
              ("kernels_bench", 2, 8, 8, 1024, 1024, 64, True, "float32",
               "simt"),
              ("smollm-360m prefill", 1, 15, 5, 4096, 4096, 64, True,
               "bfloat16", "wgmma"),
              ("smollm-360m decode", 128, 15, 5, 1, 32768, 64, True,
               "bfloat16", "decode"),
              ("smollm-360m decode B=1", 1, 15, 5, 1, 32768, 64, True,
               "bfloat16", "decode")]
FLASH_MAIN = "smollm-360m prefill"
# (label, V, d, B, L, weights, combiner, dtype): the reference's
# embedding_bag sweep (EB_SWEEP), kernels_bench.py's shapes, then MIND's
# table (configs/mind.py) at serve_p99's batch with hist_len bags and
# 0/1 history weights, the main shape, and the same in bf16
EB_ROWS = [("sweep", 64, 32, 4, 5, "random", "sum", "float32"),
           ("sweep", 128, 48, 8, 3, None, "sum", "float32"),
           ("sweep", 1000, 64, 16, 10, "random", "mean", "float32"),
           ("sweep", 64, 128, 2, 7, "random", "sum", "bfloat16"),
           ("sweep", 32, 16, 1, 1, None, "mean", "float32"),
           ("kernels_bench", 100_000, 64, 4096, 10, None, "sum", "float32"),
           ("kernels_bench", 1_000_000, 64, 1024, 20, None, "sum",
            "float32"),
           ("MIND serve_p99", 1_000_000, 64, 512, 50, "0/1", "mean",
            "float32"),
           ("MIND serve_p99 bf16", 1_000_000, 64, 512, 50, "0/1", "mean",
            "bfloat16")]
EB_MAIN = "MIND serve_p99"
# (label, T, D, poisson rate of tf): the reference's bm25_block sweep
# and kernels_bench.py's tile; Table 2's queries follow
BM25_ROWS = [("sweep", 8, 128, 0.3), ("sweep", 20, 150, 0.3),
             ("sweep", 64, 512, 0.3), ("sweep", 5, 40, 0.3),
             ("kernels_bench", 64, 8192, 0.2)]
# (rtol, atol) of |kernel - plain| <= atol + rtol * |plain| on the
# fp32-P paths ("decode", "simt"): both compute in fp32, so bf16 outputs
# differ by at most one rounding of the output, 2**-7 of its size.  The
# "wgmma" path rounds P to bf16 for the tensor cores (as the reference's
# oracle does) and is held to ref.bf16p_excess <= 1 instead:
# 2**-7 |plain| + 2**-8 sum_j p_j |v_j| + 1e-4.  The smollm rows also show
# that a kernel skipping one tile of 64 keys would fail its bound
TOL_FLASH = {"float32": (0.0, 2e-5), "bfloat16": (2 ** -7, 1e-4)}
TOL_BAG = {"float32": 1e-5, "bfloat16": 6e-2}
TOL_BM25 = 1e-4
# what the name of the kernel of ``uint8_tensor.bitwise_not_()`` holds
FLUSH_KERNEL = "bitwise_not"


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

    def run(backend: str, **kw):
        bm25 = index.bm25(num_results=200)
        dense = dense_index.retriever(200, backend=backend)
        systems = ([bm25 % k >> tl >> mono % 10 >> duo for k in CUTS]
                   + [dense % 200 >> tl >> mono % 10 >> duo,
                      (bm25 % 100 | dense % 100) >> tl >> mono % 10 >> duo])
        return Experiment(systems, topics, qrels, MEASURES, names=NAMES,
                          **kw)

    return SimpleNamespace(topics=topics, qrels=qrels, index=index, tl=tl,
                           dense_enc=dense_enc, dense_index=dense_index,
                           mono=mono, duo=duo, run=run)


def bound(n_bytes: float, n_ops: float, op_rate: float):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over ``op_rate``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / op_rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def hash_bound(n: int, L: int):
    """(bound ms, what bounds it) of cachekey_hash on [n, L] tokens:
    each token read once and each [n, 2] lane pair written once, against
    an xor and a multiply per byte and lane (16 per token), and against
    one row's chain: FNV-1a cannot be split along a row, so a row is 4*L
    steps, each an xor and then a multiply that waits for it, at best
    one dependent instruction a clock (1.98 GHz) whatever N is."""
    ms, by = bound(4 * n * L + 8 * n, 16 * n * L, INT32_OP_PER_S)
    chain_ms = 1e3 * 2 * 4 * L / CLOCK_HZ
    return (chain_ms, "operations") if chain_ms > ms else (ms, by)


def profile_kernels(torch, fn, reps: int = 20,
                    flush_l2: bool = False) -> dict:
    """{kernel name: (device ms, launches)} per call of ``fn``: the
    device-side events of ``torch.profiler``'s ``key_averages()`` over
    ``reps`` calls.  With ``flush_l2`` the 64 MB L2 flush runs before
    each call, as in ``time_ms``, and its own kernels are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(calls):
        calls()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                calls()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CPU:
                us = float(getattr(e, "self_device_time_total", 0.0))
                out[e.key] = (us / reps / 1e3, e.count / reps)
        return out

    if not flush_l2:
        return run(fn)
    # the flush is a bitwise not, so that its kernel is known by name
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.bitwise_not_()
        fn()
    return {k: v for k, v in run(flushed).items() if FLUSH_KERNEL not in k}


def device_ms(torch, fn, name: str, reps: int = 20, flush_l2: bool = False):
    """Device-only ms per call of ``fn`` spent in kernels whose name
    holds ``name`` (``profile_kernels``; the L2 warm unless
    ``flush_l2``); None where the profiler shows no device time for
    them."""
    total = sum(ms for k, (ms, _) in profile_kernels(
        torch, fn, reps, flush_l2).items() if name in k)
    if total <= 0:
        log(f"profiler: no device time for {name} (the row keeps the "
            f"CUDA-event time alone)")
        return None
    return total


def host_us(torch, fn, reps: int = 200) -> float:
    """Host µs per call of ``fn``: the mean enqueue cost over ``reps``
    calls with no synchronisation between them (host clock)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    per = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return per


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def topk_bound(Q: int, N: int, d: int, k: int, elt: int):
    """q and c read once and vals, idxs written once, against the
    product's 2*Q*N*d fp32 flops (the selection's compares not
    counted)."""
    return bound((Q * d + N * d) * elt + Q * k * 8, 2 * Q * N * d,
                 FP32_FLOP_PER_S)


def time_topk(torch, card: str, label: str, q, c, k: int, tol: float,
              reps: int = 20) -> dict:
    """dense_topk at one shape against its plain version, then timed
    beside it and ``torch.topk(q @ c.T)`` (yardstick only)."""
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_ref
    from repro_torch.kernels.dense_topk.kernel import _sms, plan
    (Q, d), N = q.shape, c.shape[0]
    p = plan(Q, N, d, k, sms=_sms(q.device.index))
    (_, _), n = driven(torch, lambda: dense_topk(q, c, k=k), "dense_topk",
                       p.launches)
    err, near = check_topk(torch, dense_topk, dense_topk_ref, q, c, k, tol)
    ms = time_ms(torch, lambda: dense_topk(q, c, k=k), reps=reps)
    plain_ms = time_ms(torch, lambda: dense_topk_ref(q, c, k=k), reps=reps)
    library_ms = time_ms(torch, lambda: torch.topk(q @ c.T, k, dim=1),
                         reps=reps)
    bound_ms, bound_by = topk_bound(Q, N, d, k, c.element_size())
    log(f"kernels: dense_topk {label} Q={Q} N={N} d={d} k={k}: "
        f"max_abs_err {err:.3g} (tol {tol}), near-tie ranks {near}; "
        f"{p.path} path, {p.splits} splits x {-(-min(Q, p.q_chunk or Q) // p.bq)} "
        f"query tiles"
        f"{f', {-(-Q // p.q_chunk)} query chunks' if p.q_chunk else ''}, "
        f"{n} launches; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.topk(q @ c.T) "
        f"{library_ms:.4f} ms (yardstick only), bound {bound_ms * 1e3:.2f} "
        f"us ({bound_by}, {bound_ms / ms:.1%} of it); median of {reps}; "
        f"{card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_dense_topk(torch, card: str, mp) -> dict:
    """dense_topk against its plain version on the card: the reference's
    sweep; duplicated rows; copies of a doc in other corpus splits, with
    integer entries so both sides are exact and must agree exactly; the
    main path's shape at its two k (the hybrid system's ``dense % 100``
    is the second call); and MS MARCO passage's corpus size, 8,841,823
    random rows of 128 (4.53 GB).  Returns the main shape's entry."""
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_ref
    from repro_torch.kernels.dense_topk.kernel import _sms, plan
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

    # a 5,000-doc base repeated 8 times: each doc's copies in other splits
    q = torch.randint(-3, 4, (4, 64), generator=gen).float().to("cuda")
    base = torch.randint(-3, 4, (5000, 64), generator=gen).float()
    c = base.repeat(8, 1).to("cuda")
    k = 200
    p = plan(4, len(c), 64, k, sms=_sms(0))
    kv, ki = dense_topk(q, c, k=k)
    rv, ri = dense_topk_ref(q, c, k=k)
    torch.cuda.synchronize()
    if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
        raise AssertionError("dense_topk copies across splits: kernel and "
                             "plain version differ on exact integer scores")
    for row in ki.cpu().tolist():
        pos = {g: r for r, g in enumerate(row)}
        if not all(pos.get(e, k) < pos[g] for g in pos
                   for e in range(g % 5000, g, 5000)):
            raise AssertionError("dense_topk copies across splits: a later "
                                 "copy ranks before an earlier one")
    copies = sum(g >= 5000 for g in ki.flatten().tolist())
    log(f"kernels: dense_topk copies across {p.splits} splits (5,000-doc "
        f"base x 8, integer entries): kernel equals the plain version "
        f"exactly, {copies} of {ki.numel()} results are later copies, each "
        f"after every earlier one")

    # the select path (k > 1,024): a 19,800-doc base repeated twice, so
    # each doc's copy lies 19,800 later and k cuts through tied scores
    q = torch.randint(-3, 4, (53, 128), generator=gen).float().to("cuda")
    base = torch.randint(-3, 4, (19_800, 128), generator=gen).float()
    c = base.repeat(2, 1).to("cuda")
    p = plan(53, len(c), 128, BIG_K, sms=_sms(0))
    kv, ki = dense_topk(q, c, k=BIG_K)
    rv, ri = dense_topk_ref(q, c, k=BIG_K)
    torch.cuda.synchronize()
    if p.path != "select" or not (torch.equal(kv, rv) and
                                  torch.equal(ki, ri)):
        raise AssertionError(f"dense_topk k={BIG_K} ({p.path} path): "
                             f"kernel and plain version differ on exact "
                             f"integer scores")
    log(f"kernels: dense_topk ties at k={BIG_K} ({p.path} path, "
        f"{p.launches} launches; 19,800-doc base x 2, Q 53, d 128, integer "
        f"entries): kernel equals the plain version exactly")

    q_main = mp.dense_enc.encode(mp.topics["query"].tolist())
    c_main = mp.dense_index.matrix
    entry = time_topk(torch, card, "main shape", q_main, c_main, max(CUTS),
                      2e-5)
    time_topk(torch, card, "main shape, hybrid's dense % 100", q_main,
              c_main, 100, 2e-5)
    time_topk(torch, card, f"main shape at k {BIG_K:,} (select path)",
              q_main, c_main, BIG_K, 2e-5)
    del q, c, base, kv, ki, rv, ri
    cg = torch.Generator(device="cuda").manual_seed(8)
    scale = 128 ** -0.25                          # scores O(1)
    q = torch.randn(53, 128, generator=cg, device="cuda") * scale
    c = torch.randn(MSMARCO_PASSAGES, 128, generator=cg, device="cuda") \
        * scale
    time_topk(torch, card, "MS MARCO passage size", q, c, 200, 2e-5,
              reps=MSMARCO_REPS)
    time_topk(torch, card, f"MS MARCO passage size at k {BIG_K:,} (select "
              f"path)", q, c, BIG_K, 2e-5, reps=MSMARCO_REPS)
    del q, c
    torch.cuda.empty_cache()
    return entry


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
            dev_ms = device_ms(torch, lambda: cachekey_hash(t),
                               "cachekey_hash_kernel")
            call_us = host_us(torch, lambda: cachekey_hash(t))
            timed[(n, L)] = (ms, plain_ms, bound_ms, bound_by)
            line += (f"; kernel {ms:.4f} ms ({warm_ms:.4f} ms with the "
                     f"input in L2; device-only {fmt_ms(dev_ms)}, "
                     f"profiler; host {call_us:.1f} us a call to enqueue), "
                     f"plain {plain_ms:.4f} ms, bound "
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
    rng = np.random.default_rng(2)
    payloads = [rng.bytes(int(rng.integers(0, 20001)))
                for _ in range(n_payloads)]
    payloads += payloads[:10]
    before = cachekey_hash.launches
    batch = prov.digest_many(payloads)
    groups = len({-(-(len(p) + 8) // 256) for p in payloads})
    if cachekey_hash.launches - before != groups or \
            batch != [prov.digest_bytes(p) for p in payloads]:
        raise AssertionError("digest_many: not one launch per length, or "
                             "not digest_bytes row by row")
    log(f"kernels: digest_many of {len(payloads)} payloads in "
        f"{groups} launches equals digest_bytes row by row")
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


def ptxas_lines(log_text: str) -> list:
    """One line per compiled kernel from nvcc's ``-Xptxas=-v`` output: its
    name, registers and shared memory, and its stack frame and spills;
    and every ptxas warning."""
    out, name, spill = [], "?", ""
    for line in log_text.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            name = line.rsplit("for", 1)[1].strip()
        elif "spill" in line:
            spill = line
        elif "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
            spill = ""
        elif "warning" in line.lower():
            out.append(line)
    return out


def kernel_wrappers() -> dict:
    from repro_torch.kernels.bm25_block import bm25_block
    from repro_torch.kernels.cachekey_hash import cachekey_hash
    from repro_torch.kernels.dense_topk import dense_topk
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import flash_attention
    return {"dense_topk": dense_topk, "cachekey_hash": cachekey_hash,
            "flash_attention": flash_attention,
            "embedding_bag": embedding_bag, "bm25_block": bm25_block}


def driven(torch, fn, name: str, expect: int):
    """(``fn()``, launches of kernel ``name`` in it), with every kernel's
    launch count set to 0 just before and read just after; raises unless
    ``name`` launched ``expect`` times and no other kernel launched."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in wrappers.items()}
    if counts != {n: expect if n == name else 0 for n in wrappers}:
        raise AssertionError(f"{name}: launches {counts}, expected {expect} "
                             f"of {name} and none of the others")
    return out, counts[name]


def flash_bound(B, H, K, Sq, Sk, hd, causal, dtype):
    """q, k, v read once and the output written once, against the two
    products' 4*hd flops for each (query, key) pair the mask keeps."""
    pairs = sum(min(Sk, max(0, i + Sk - Sq + 1)) for i in range(Sq)) \
        if causal else Sq * Sk
    elt = 4 if dtype == "float32" else 2
    n_bytes = elt * (2 * B * H * Sq * hd + 2 * B * K * Sk * hd)
    rate = FP32_FLOP_PER_S if dtype == "float32" else BF16_FLOP_PER_S
    return bound(n_bytes, 4 * B * H * hd * pairs, rate)


def flash_within(got, want, dt, path, q, k, v, causal):
    """(max abs err, largest share of the bound used, elements beyond it)
    of ``got`` against ``want``: TOL_FLASH[dt] on the fp32-P paths,
    ``bf16p_excess`` on "wgmma"."""
    from repro_torch.kernels.flash_attention.ref import bf16p_excess
    diff = (got.float() - want.float()).abs()
    if path == "wgmma":
        share = bf16p_excess(got, q, k, v, causal=causal, plain=want)
    else:
        rtol, atol = TOL_FLASH[dt]
        share = diff / (atol + rtol * want.float().abs())
    return float(diff.max()), float(share.max()), int((share > 1).sum())


def attention_skipping_tile(torch, q, k, v, causal, lo):
    """The plain version with keys [lo, lo + 64) masked for every row:
    what a kernel that skipped that K/V tile would return."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqh,bksh->bkgqs",
                     q.float().reshape(B, K, H // K, Sq, hd), k.float())
    j = torch.arange(Sk, device=q.device)[None, :]
    keep = (j < lo) | (j >= lo + 64)
    if causal:
        keep = keep & (j <= torch.arange(Sq, device=q.device)[:, None]
                       + (Sk - Sq))
    p = torch.softmax((s / math.sqrt(hd)).masked_fill(~keep, float("-inf")),
                      dim=-1)
    return torch.einsum("bkgqs,bksh->bkgqh", p, v.float()) \
        .reshape(B, H, Sq, hd).to(q.dtype)


def check_flash_attention(torch, card: str) -> dict:
    """flash_attention_op at FLASH_ROWS against the plain version, each
    row on the path it names, with the kernel, plain and SDPA times.
    Returns the main row's entry."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     flash_attention_op)
    from repro_torch.kernels.flash_attention.kernel import (decode_splits,
                                                            path_for)
    gen = torch.Generator(device="cuda").manual_seed(4)
    entry = None
    for label, B, H, K, Sq, Sk, hd, causal, dt, path in FLASH_ROWS:
        dtype = getattr(torch, dt)
        if path_for(dtype, B, H, K, Sq, Sk, hd, causal) != path:
            raise AssertionError(f"flash_attention {label}: path_for picks "
                                 f"{path_for(dtype, B, H, K, Sq, Sk, hd, causal)}"
                                 f", not {path}")
        expect = 2 if path == "decode" and decode_splits(B, K, Sk)[0] > 1 \
            else 1
        q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=dtype)
                   for s in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd)))
        flash_attention.paths.clear()
        got, n = driven(torch, lambda: flash_attention_op(q, k, v,
                                                          causal=causal),
                        "flash_attention", expect)
        if dict(flash_attention.paths) != {path: 1}:
            raise AssertionError(f"flash_attention {label}: paths "
                                 f"{dict(flash_attention.paths)}, expected "
                                 f"one call on {path}")
        want = attention_ref(q, k, v, causal=causal)
        err, share, beyond = flash_within(got, want, dt, path, q, k, v,
                                          causal)
        bound_name = "bf16p bound" if path == "wgmma" \
            else f"(rtol, atol) {TOL_FLASH[dt]}"
        if beyond:
            raise AssertionError(f"flash_attention {label} "
                                 f"{(B, H, K, Sq, Sk, hd)} {dt}: {beyond} "
                                 f"elements beyond the {bound_name}, "
                                 f"max_abs_err {err}")
        if label.startswith("smollm"):
            lo = Sk // 2 // 64 * 64
            d_err, d_share, d_beyond = flash_within(
                attention_skipping_tile(torch, q, k, v, causal, lo),
                want, dt, path, q, k, v, causal)
            if not d_beyond:
                raise AssertionError(f"flash_attention {label}: the "
                                     f"{bound_name} passes an output that "
                                     f"skips keys [{lo}, {lo + 64})")
            log(f"kernels: flash_attention {label}: skipping keys [{lo}, "
                f"{lo + 64}) would fail the {bound_name} at {d_beyond} of "
                f"{want.numel()} elements (max_abs_err {d_err:.3g}, "
                f"{d_share:.3g}x the bound); the kernel used {share:.3g}x "
                f"of it")
        del got, want
        # SDPA's causal mask is aligned top-left: is_causal only where
        # Sq = Sk; an explicit mask where Sq < Sk and some key is masked
        keep = (torch.arange(Sk, device="cuda")[None, :]
                <= torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq))
        mask = keep if causal and Sq != Sk and not bool(keep.all()) \
            else None
        is_causal = causal and Sq == Sk
        ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=causal))
        plain_ms = time_ms(torch, lambda: attention_ref(q, k, v,
                                                        causal=causal))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=is_causal, enable_gqa=True))
        bound_ms, bound_by = flash_bound(B, H, K, Sq, Sk, hd, causal, dt)
        log(f"kernels: flash_attention {label} B={B} H={H} K={K} Sq={Sq} "
            f"Sk={Sk} hd={hd} {'causal' if causal else 'full'} {dt}: path "
            f"{path}, max_abs_err {err:.3g} ({bound_name}, {share:.3g}x "
            f"used), {n} launch{'es' if n > 1 else ''}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
            f"ms (yardstick only), bound {bound_ms * 1e3:.4f} us "
            f"({bound_by}); {card}")
        if label == FLASH_MAIN:
            entry = {"path": path, "launches": n, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        del q, k, v
    torch.cuda.empty_cache()
    return entry


def bag_inputs(torch, gen, tab, B: int, L: int, weights):
    """ids [B, L] int32 over ``tab``'s rows and the weights of an
    EB_ROWS row: ``"random"`` uniform in [0, 1), ``"0/1"`` the first n
    of L history slots (n uniform in 1..L), or None."""
    ids = torch.randint(0, tab.shape[0], (B, L), generator=gen,
                        device="cuda", dtype=torch.int32)
    if weights == "random":
        w = torch.rand(B, L, generator=gen, device="cuda", dtype=tab.dtype)
    elif weights == "0/1":
        n = torch.randint(1, L + 1, (B, 1), generator=gen, device="cuda")
        w = (torch.arange(L, device="cuda")[None, :] < n).to(tab.dtype)
    else:
        w = None
    return ids, w


def bag_bound(torch, tab, ids, w):
    """(bound ms, what bounds it, distinct rows) of a bag sum: the rows
    this run's ids touch read once, the ids and weights read once and
    the bags written once, against 2 flops per gathered element."""
    (B, L), d, elt = ids.shape, tab.shape[1], tab.element_size()
    rows = int(torch.unique(ids).numel())
    n_bytes = elt * (rows * d + B * d) + 4 * B * L \
        + (w.element_size() * B * L if w is not None else 0)
    return (*bound(n_bytes, 2 * B * L * d, FP32_FLOP_PER_S), rows)


def plan_text(p) -> str:
    return (f"plan vec {p.vec} B x {p.lanes} lanes, {p.groups} column "
            f"group{'s' if p.groups > 1 else ''}, {p.rows_in_flight} rows in "
            f"flight a warp, {p.warps} warp{'s' if p.warps > 1 else ''} a "
            f"block x {p.grid} blocks, {p.bytes_in_flight / 2**20:.3g} MiB "
            f"in flight ({p.bytes_in_flight_sm / 2**10:.3g} KiB on the "
            f"busiest SM)")


def check_embedding_bag(torch, card: str) -> dict:
    """embedding_bag_op at EB_ROWS against the plain version, with the
    plan each row takes, the kernel's event and device-only times (L2
    flushed) and its share of the bytes bound, and the plain and
    ``F.embedding_bag`` times (the kernel and the library call both
    compute the weighted sum).  At MIND's rows also: two calls equal bit
    for bit; the host's enqueue, split into the bare ``ctypes`` entry
    call and the rest of the wrapper; ``embedding_bag_op`` with the
    row's combiner, its kernels a call as the profiler counts them and
    its times; and small-integer tables and weights, where every
    summation order is exact, equal to the plain version bit for bit.
    Returns the main row's entry."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_op,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag.kernel import alignment, plan
    gen = torch.Generator(device="cuda").manual_seed(5)
    tables, entry = {}, None
    for label, V, d, B, L, weights, combiner, dt in EB_ROWS:
        dtype = getattr(torch, dt)
        if (V, d, dt) not in tables:
            tables = {(V, d, dt): torch.randn(V, d, generator=gen,
                                              device="cuda", dtype=dtype)}
        tab = tables[(V, d, dt)]
        ids, w = bag_inputs(torch, gen, tab, B, L, weights)
        got, n = driven(torch, lambda: embedding_bag_op(tab, ids, w,
                                                        combiner=combiner),
                        "embedding_bag", 1)
        want = embedding_bag_ref(tab, ids, w, combiner)
        err = float((got.float() - want.float()).abs().max())
        if not err <= TOL_BAG[dt]:
            raise AssertionError(f"embedding_bag {label} {(V, d, B, L)} {dt}: "
                                 f"max_abs_err {err} > {TOL_BAG[dt]}")
        p = plan(V, d, B, L, dtype, alignment(tab))
        ids64 = ids.long()

        def kernel():
            return embedding_bag(tab, ids, w)
        ms = time_ms(torch, kernel)
        dev_ms = device_ms(torch, kernel, "embedding_bag_kernel",
                           flush_l2=True)
        plain_ms = time_ms(torch, lambda: embedding_bag_ref(tab, ids, w))
        library_ms = time_ms(torch, lambda: F.embedding_bag(
            ids64, tab, mode="sum", per_sample_weights=w))
        bound_ms, bound_by, rows = bag_bound(torch, tab, ids, w)
        share = f"{bound_ms / dev_ms:.1%}" if dev_ms else "not measured"
        log(f"kernels: embedding_bag {label} V={V} d={d} B={B} L={L} "
            f"weights={weights} {combiner} {dt}: max_abs_err {err:.3g} (tol "
            f"{TOL_BAG[dt]}), {n} launch; {plan_text(p)}; kernel (sum) "
            f"{ms:.4f} ms, device-only {fmt_ms(dev_ms)} (profiler, L2 "
            f"flushed), {share} of the bound; plain {plain_ms:.4f} ms, "
            f"F.embedding_bag(sum) {library_ms:.4f} ms (yardstick only), "
            f"bound {bound_ms * 1e3:.4f} us ({bound_by}, {rows} distinct "
            f"rows); {card}")
        if label.startswith("MIND"):
            check_bag_at_mind(torch, card, label, tab, ids, w, combiner)
        if label == EB_MAIN:
            entry = {"launches": n, "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms}
    del tables
    torch.cuda.empty_cache()
    return entry


def check_bag_at_mind(torch, card, label, tab, ids, w, combiner) -> None:
    """The MIND-row checks of ``check_embedding_bag``."""
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_op,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag.kernel import launch_args
    if not torch.equal(embedding_bag(tab, ids, w), embedding_bag(tab, ids, w)):
        raise AssertionError(f"embedding_bag {label}: two calls differ")
    call = launch_args(tab, ids, w)
    bare_us = host_us(torch, lambda: call.entry(*call.args))
    wrap_us = host_us(torch, lambda: embedding_bag(tab, ids, w))

    def op():
        return embedding_bag_op(tab, ids, w, combiner=combiner)
    ks = profile_kernels(torch, op, flush_l2=True)
    n_kernels = sum(c for _, c in ks.values())
    if combiner == "mean" and n_kernels > 1:
        raise AssertionError(f"embedding_bag_op {label} (mean): "
                             f"{n_kernels:g} kernels a call, {sorted(ks)}")
    op_ms = time_ms(torch, op)
    log(f"kernels: embedding_bag {label}: two calls bit-identical; host "
        f"enqueue {wrap_us:.1f} us a call: the bare ctypes entry call "
        f"{bare_us:.1f} us (arguments prepared), the rest of the wrapper "
        f"{wrap_us - bare_us:.1f} us (host clock, mean of 200); "
        f"embedding_bag_op({combiner}) {op_ms:.4f} ms, {n_kernels:g} "
        f"kernel{'s' if n_kernels != 1 else ''} a call on the device "
        f"({sum(ms for ms, _ in ks.values()):.4f} ms, profiler, L2 flushed); "
        f"{card}")
    # small integers: every product and partial sum is exact, so the
    # kernel equals the plain version bit for bit (a dropped or repeated
    # row would not)
    gen = torch.Generator(device="cuda").manual_seed(9)
    itab = torch.randint(-8, 9, tab.shape, generator=gen, device="cuda") \
        .to(tab.dtype)
    iw = torch.randint(0, 4, ids.shape, generator=gen, device="cuda") \
        .to(tab.dtype)
    for c in ("sum", "mean"):
        for ww in (None, iw):
            got = embedding_bag_op(itab, ids, ww, combiner=c)
            if not torch.equal(got, embedding_bag_ref(itab, ids, ww, c)):
                raise AssertionError(f"embedding_bag {label}: integer "
                                     f"entries, {c}, weights "
                                     f"{'none' if ww is None else 'ints'}: "
                                     f"not bit-identical to the plain "
                                     f"version")
    log(f"kernels: embedding_bag {label}: integer tables and weights, sum "
        f"and mean, with and without weights: bit-identical to the plain "
        f"version")


def bm25_bound(tiles):
    """Each tile read once (tf, idf, doc_len) and its scores written
    once, against 5 flops for each nonzero tf (add, multiply, divide,
    multiply-add) and 4 for each doc's length norm."""
    n_bytes = sum(4 * (tf.numel() + idf.numel() + 2 * dl.numel())
                  for tf, idf, dl in tiles)
    n_ops = sum(5 * int((tf > 0).sum()) + 4 * dl.numel()
                for tf, idf, dl in tiles)
    return bound(n_bytes, n_ops, FP32_FLOP_PER_S)


def check_bm25_block(torch, card: str, mp) -> dict:
    """bm25_block_op at BM25_ROWS against the plain version, then over
    Table 2's queries against ``BM25Retriever.score_query``: one tile
    per query, a row per query term found in the index (repeated terms
    kept, as the host loop adds them twice), every doc a column.
    Returns the Table 2 entry (all queries, one launch each)."""
    import numpy as np

    from repro_torch.kernels.bm25_block import (bm25_block, bm25_block_op,
                                                bm25_block_ref)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for label, T, D, rate in BM25_ROWS:
        tile = (torch.poisson(torch.full((T, D), rate, device="cuda"),
                              generator=gen),
                torch.rand(T, generator=gen, device="cuda") * 5,
                torch.randint(20, 100, (D,), generator=gen,
                              device="cuda").float())
        got, n = driven(torch, lambda: bm25_block_op(*tile, avg_dl=55.0),
                        "bm25_block", 1)
        err = float((got - bm25_block_ref(*tile, avg_dl=55.0)).abs().max())
        if not err <= TOL_BM25:
            raise AssertionError(f"bm25_block {label} {(T, D)}: max_abs_err "
                                 f"{err} > {TOL_BM25}")
        ms = time_ms(torch, lambda: bm25_block(*tile, avg_dl=55.0))
        dev_ms = device_ms(torch, lambda: bm25_block(*tile, avg_dl=55.0),
                           "bm25_block_kernel") \
            if label == "kernels_bench" else None
        plain_ms = time_ms(torch, lambda: bm25_block_ref(*tile, avg_dl=55.0))
        bound_ms, bound_by = bm25_bound([tile])
        log(f"kernels: bm25_block {label} T={T} D={D}: max_abs_err "
            f"{err:.3g} (tol {TOL_BM25}), {n} launch; kernel {ms:.4f} ms"
            f"{f' (device-only {fmt_ms(dev_ms)}, profiler)' if label == 'kernels_bench' else ''}, "
            f"plain {plain_ms:.4f} ms, no library call, bound "
            f"{bound_ms * 1e3:.4f} us ({bound_by}); {card}")

    index, queries = mp.index, mp.topics["query"].tolist()
    bm25 = index.bm25()
    dl = torch.from_numpy(index.doc_len).to("cuda")
    tiles = []
    for query in queries:
        terms = [t for t in index.tokenizer.tokenize(query)
                 if t in index.postings]
        tf = np.zeros((len(terms), index.n_docs), np.float32)
        for ti, t in enumerate(terms):
            ids, tfs = index.postings[t]
            tf[ti, ids] = tfs
        idf = np.array([index.idf(t) for t in terms], np.float32)
        tiles.append((torch.from_numpy(tf).to("cuda"),
                      torch.from_numpy(idf).to("cuda"), dl))
    kw = dict(k1=bm25.k1, b=bm25.b, avg_dl=index.avg_dl)
    outs, n = driven(torch, lambda: [bm25_block_op(*t, **kw)
                                     for t in tiles],
                     "bm25_block", len(queries))
    err, worst_rel = 0.0, 0.0
    for query, tile, got in zip(queries, tiles, outs):
        err = max(err, float((got - bm25_block_ref(*tile, **kw))
                             .abs().max()))
        ids, scores = bm25.score_query(query)
        at = got.cpu().numpy()[ids]
        np.testing.assert_allclose(at, scores, rtol=1e-4)
        if len(ids):
            worst_rel = max(worst_rel, float(np.max(
                np.abs(at - scores) / np.abs(scores))))
    if not err <= TOL_BM25:
        raise AssertionError(f"bm25_block Table 2: max_abs_err {err} > "
                             f"{TOL_BM25}")
    ms = time_ms(torch, lambda: [bm25_block(*t, **kw) for t in tiles])
    dev_ms = device_ms(torch, lambda: [bm25_block(*t, **kw) for t in tiles],
                       "bm25_block_kernel")
    call_us = host_us(torch, lambda: [bm25_block(*t, **kw) for t in tiles],
                      reps=20) / len(tiles)
    plain_ms = time_ms(torch, lambda: [bm25_block_ref(*t, **kw)
                                       for t in tiles])
    bound_ms, bound_by = bm25_bound(tiles)
    rows = [t[0].shape[0] for t in tiles]
    log(f"kernels: bm25_block Table 2: {len(queries)} queries over "
        f"{index.n_docs} docs, {min(rows)}-{max(rows)} terms each, "
        f"{n} launches; score_query reproduced at its ids "
        f"(largest relative difference {worst_rel:.3g}, rtol 1e-4); "
        f"max_abs_err {err:.3g} against the plain version; all queries: "
        f"kernel {ms:.4f} ms (device-only {fmt_ms(dev_ms)}, profiler; "
        f"host {call_us:.1f} us a call to enqueue), "
        f"plain {plain_ms:.4f} ms, no library call, bound "
        f"{bound_ms * 1e3:.4f} us ({bound_by}); {card}")
    return {"launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def counting_bm25(mp):
    """A fresh BM25 retriever of the main path at depth 200, and a
    one-item list that counts the queries it retrieves for."""
    bm25 = mp.index.bm25(num_results=max(CUTS))
    seen = [0]
    orig = bm25.transform

    def counting(inp):
        seen[0] += len(inp)
        return orig(inp)
    bm25.transform = counting
    return bm25, seen


def same_results(label, res, base, names) -> float:
    """Raise unless ``res`` has ``base``'s means and per-query values to
    1e-6; returns the largest per-query difference."""
    worst = 0.0
    for n in names:
        for m in MEASURES:
            if abs(res.means[n][m] - base.means[n][m]) > 1e-6:
                raise AssertionError(f"{label} {n} {m}: {res.means[n][m]} "
                                     f"vs {base.means[n][m]}")
            for qid, v in base.per_query[n][m].items():
                worst = max(worst, abs(res.per_query[n][m][qid] - v))
    if worst > 1e-6:
        raise AssertionError(f"{label}: per-query values differ by {worst}")
    return worst


def run_table2(torch, card: str, mp) -> dict:
    """The paper's Table 2 in its four settings through the port's entry
    points; raises unless the claims hold, every setting's means equal
    setting (1)'s, and setting (2)'s plan launched cachekey_hash once
    per (level, length) group of its digests.  Returns the counts and
    the largest digest batch, (rows, words)."""
    import repro_torch.caching.provenance as prov
    from repro_torch.caching import ScorerCache
    from repro_torch.core import Experiment
    from repro_torch.kernels.cachekey_hash import cachekey_hash

    names = [f"k={k}" for k in CUTS]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    cache_root = tempfile.mkdtemp(prefix="table2-scorer-cache-",
                                  dir=str(build))
    rows, batches = [], []
    digest_many = prov.digest_many
    try:
        for setting, (pre, cached) in enumerate(TABLE2_SETTINGS, start=1):
            bm25, seen = counting_bm25(mp)
            cache = None if cached is None else ScorerCache(
                str(Path(cache_root) / "mono"), mp.mono, backend="sqlite")
            stage = mp.mono if cache is None else cache
            systems = [bm25 % k >> mp.tl >> stage % 10 >> mp.duo
                       for k in CUTS]
            mono0 = mp.mono.invocations
            if setting == 2:             # the digest batches' row widths
                def recording(payloads):
                    batches.append(collections.Counter(
                        len(prov._bucket_words(p)) for p in payloads))
                    return digest_many(payloads)
                prov.digest_many = recording
            cachekey_hash.launches = 0
            t = time.perf_counter()
            res = Experiment(systems, mp.topics, mp.qrels, MEASURES,
                             precompute_prefix=pre,
                             precompute_mode="plan", names=names)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = cachekey_hash.launches
            prov.digest_many = digest_many
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
        prov.digest_many = digest_many
        shutil.rmtree(cache_root, ignore_errors=True)

    base = rows[0]["res"]
    worst = max(same_results(f"table2 setting {r['setting']}", r["res"],
                             base, names) for r in rows[1:])
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
    groups = sum(len(b) for b in batches)
    if rows[1]["cachekey_hash_launches"] != groups:
        raise AssertionError(f"table2: {rows[1]['cachekey_hash_launches']} "
                             f"cachekey_hash launches in setting 2, not its "
                             f"{groups} (level, length) groups")
    log(f"table2: cachekey_hash launches per plan {groups} (setting 2: "
        f"{len(batches)} digest batches, rows by width in words "
        f"{[dict(sorted(b.items())) for b in batches]}; row by row it took "
        f"{sum(sum(b.values()) for b in batches)}); per run "
        f"{sum(r['cachekey_hash_launches'] for r in rows)}")
    # compiling setting (2)'s plan, with the digests on the card and on
    # the CPU; then its digests alone, batched and row by row, which must
    # give the same node fingerprints and plan id
    from repro_torch.core import ExecutionPlan
    from repro_torch.core.cost import plan_fingerprints
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
    graph = ExecutionPlan(systems).graph
    fps, plan_id = plan_fingerprints(graph)
    if (fps, plan_id) != row_by_row_fingerprints(graph):
        raise AssertionError("table2: the batched node fingerprints or plan "
                             "id differ from the row-by-row digests")
    host = {}
    for how, fn in (("batched", plan_fingerprints),
                    ("row by row", row_by_row_fingerprints),
                    ("batched", plan_fingerprints)):
        times = []
        for _ in range(20):
            t = time.perf_counter()
            fn(graph)
            times.append(time.perf_counter() - t)
        host.setdefault(how, []).append(statistics.median(times) * 1e3)
    log(f"table2: a plan's digests ({len(fps)} node fingerprints and the "
        f"plan id) equal the row-by-row digest_bytes results; host ms, "
        f"median of 20: batched {host['batched'][0]:.3f} / "
        f"{host['batched'][1]:.3f}, row by row {host['row by row'][0]:.3f}"
        f"; {card}")
    width, n = max(((L, n) for b in batches for L, n in b.items()),
                   key=lambda x: x[1])
    return {"rows": rows, "batch": (n, width), "groups": groups,
            "launches": sum(r["cachekey_hash_launches"] for r in rows)}


def run_table2_planner(torch, card: str, mp, table2_base, main_res) -> dict:
    """Table 2's four bm25 systems, then the main path's six systems,
    each through ``Experiment(..., precompute_mode="plan",
    cache_dir=...)`` cold then hot.  Raises unless the hot Table 2 run
    invokes BM25 and Mono on nothing, scores as many Duo pairs as the
    cold one (Duo is ``cacheable=False``) and misses nothing; every run
    launches ``cachekey_hash``; the dense retrievers launch
    ``dense_topk`` cold and never hot; and the means and per-query
    values equal the uncached runs' (Table 2's setting (1), the main
    path's kernel run) to 1e-6.  Returns the launches of each kernel."""
    from repro_torch.core import Experiment
    from repro_torch.kernels.cachekey_hash import cachekey_hash
    from repro_torch.kernels.dense_topk import dense_topk

    names = [f"k={k}" for k in CUTS]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="table2-planner-", dir=str(build)))
    rows, dense_rows = [], []
    try:
        for run in ("cold", "hot"):
            bm25, seen = counting_bm25(mp)
            systems = [bm25 % k >> mp.tl >> mp.mono % 10 >> mp.duo
                       for k in CUTS]
            mono0, duo0 = mp.mono.invocations, mp.duo.invocations
            cachekey_hash.launches = 0
            t = time.perf_counter()
            res = Experiment(systems, mp.topics, mp.qrels, MEASURES,
                             precompute_prefix=True, precompute_mode="plan",
                             cache_dir=str(root / "table2"), names=names)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            st = res.precompute
            rows.append({
                "run": run, "wall_s": wall, "bm25_queries": seen[0],
                "mono_pairs": mp.mono.invocations - mono0,
                "duo_pairs": mp.duo.invocations - duo0,
                "cache_hits": st.cache_hits, "cache_misses": st.cache_misses,
                "nodes_executed": st.nodes_executed,
                "nodes_planned": st.nodes_planned,
                "cachekey_hash_launches": cachekey_hash.launches,
                "node_dirs": len([d for d in (root / "table2").iterdir()
                                  if d.name != "plans"])})
            log("table2_planner: " + json.dumps(rows[-1]))
            rows[-1]["worst"] = same_results(
                f"table2_planner {run}", res, table2_base, names)
            rows[-1]["node_times_s"] = st.node_times_s
        hot = rows[1]["node_times_s"]
        log("table2_planner: hot run, host s per plan node (the caches' "
            "reads and Duo): " + json.dumps(
                {k[:48]: round(v, 4) for k, v in
                 sorted(hot.items(), key=lambda kv: -kv[1])}))

        for run in ("cold", "hot"):
            dense_topk.launches = 0
            cachekey_hash.launches = 0
            t = time.perf_counter()
            res = mp.run("cuda", precompute_prefix=True,
                         precompute_mode="plan",
                         cache_dir=str(root / "dense"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            st = res.precompute
            dense_rows.append({
                "run": run, "wall_s": wall,
                "dense_topk_launches": dense_topk.launches,
                "cachekey_hash_launches": cachekey_hash.launches,
                "cache_hits": st.cache_hits, "cache_misses": st.cache_misses,
                "nodes_executed": st.nodes_executed,
                "node_dirs": len([d for d in (root / "dense").iterdir()
                                  if d.name != "plans"])})
            log("table2_planner: dense " + json.dumps(dense_rows[-1]))
            dense_rows[-1]["worst"] = same_results(
                f"table2_planner dense {run}", res, main_res, NAMES)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    cold, hot = rows
    if hot["bm25_queries"] != 0 or hot["mono_pairs"] != 0:
        raise AssertionError("table2_planner: the hot run invoked BM25 or "
                             "Mono")
    if hot["duo_pairs"] != cold["duo_pairs"]:
        raise AssertionError("table2_planner: Duo is not cacheable, yet the "
                             "hot run scored other Duo pairs than the cold")
    if hot["cache_misses"] != 0 or dense_rows[1]["cache_misses"] != 0:
        raise AssertionError("table2_planner: a hot run missed")
    if min(r["cachekey_hash_launches"] for r in rows + dense_rows) < 1:
        raise AssertionError("table2_planner: a plan never launched "
                             "cachekey_hash")
    if dense_rows[0]["dense_topk_launches"] < 1:
        raise AssertionError("table2_planner: the cold dense run never "
                             "launched dense_topk")
    if dense_rows[1]["dense_topk_launches"] != 0:
        raise AssertionError("table2_planner: the hot dense run launched "
                             "dense_topk; its RetrieverCache should serve it")
    log(f"table2_planner: means and per-query values equal setting 1's "
        f"(largest difference {max(r['worst'] for r in rows):.3g}) and the "
        f"uncached dense Experiment's "
        f"({max(r['worst'] for r in dense_rows):.3g}); walls cold / hot: "
        f"Table 2 {cold['wall_s']:.3f} / {hot['wall_s']:.3f} s, dense "
        f"Experiment {dense_rows[0]['wall_s']:.3f} / "
        f"{dense_rows[1]['wall_s']:.3f} s; {card}")
    return {"cachekey_hash": sum(r["cachekey_hash_launches"]
                                 for r in rows + dense_rows),
            "dense_topk": sum(r["dense_topk_launches"] for r in dense_rows)}


def row_by_row_fingerprints(graph):
    """(node fingerprints, plan id) one ``digest_bytes`` at a time, as
    the reference computes them (its ``core/cost.py``
    ``compute_node_fingerprints`` and ``core/plan.py`` plan id)."""
    from repro_torch.caching.auto import derive_fingerprint
    from repro_torch.caching.provenance import combine_fingerprints
    fps = {graph.source.id: combine_fingerprints("plan-source")}
    for node in graph.nodes:
        if node.kind == "source":
            continue
        in_fps = [fps[i.id] for i in node.inputs]
        if node.kind == "combine" and getattr(node.stage, "commutative",
                                              False):
            stage_fp = combine_fingerprints("combine",
                                            type(node.stage).__name__)
            in_fps = sorted(in_fps)
        else:
            stage_fp = derive_fingerprint(node.stage) \
                or combine_fingerprints("sig", repr(node.stage))
        fps[node.id] = combine_fingerprints("node", node.kind, stage_fp,
                                            *in_fps)
    return fps, combine_fingerprints(
        "plan", *[fps[t.id] for t in graph.terminals])


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
    from repro_torch.kernels.dense_topk import dense_topk

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
        for line in ptxas_lines(_build.build_log(name)):
            log(f"build: {name}: {line}")

    mp = setup_main_path(torch)

    # -- 3. kernels against their plain versions ---------------------------
    topk_entry = check_dense_topk(torch, card, mp)
    hash_timed = check_cachekey_hash(torch, card)
    t = time.perf_counter()
    flash_entry = check_flash_attention(torch, card)
    bag_entry = check_embedding_bag(torch, card)
    bm25_entry = check_bm25_block(torch, card, mp)
    log(f"kernels: flash_attention, embedding_bag and bm25_block rows in "
        f"{time.perf_counter() - t:.1f} s")

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
    worst = same_results("main: the kernel path against the plain path",
                         res, plain, NAMES)
    log(f"main: backend='torch' means and per-query values equal to 1e-6 "
        f"(largest per-query difference {worst:.3g}; "
        f"{time.perf_counter() - t:.1f} s)")

    # -- 5. Table 2 ---------------------------------------------------------
    t = time.perf_counter()
    t2 = run_table2(torch, card, mp)
    log(f"table2: four settings in {time.perf_counter() - t:.1f} s, "
        f"cachekey_hash.launches {t2['launches']}")

    # -- 6. Table 2 and the main path through the planner's caches ---------
    t = time.perf_counter()
    planner = run_table2_planner(torch, card, mp, t2["rows"][0]["res"], res)
    log(f"table2_planner: in {time.perf_counter() - t:.1f} s, launches "
        f"{json.dumps(planner)}")

    # the hash kernel at the main path's largest digest batch
    n_main, L_main = t2["batch"]
    tok = torch.randint(-2**31, 2**31, (n_main, L_main),
                        generator=torch.Generator().manual_seed(3),
                        dtype=torch.int64).to(torch.int32).to("cuda")
    if not torch.equal(cachekey_hash(tok), cachekey_hash_ref(tok)):
        raise AssertionError(f"cachekey_hash N={n_main} L={L_main} differs")
    h_ms = time_ms(torch, lambda: cachekey_hash(tok))
    h_dev = device_ms(torch, lambda: cachekey_hash(tok),
                      "cachekey_hash_kernel")
    h_plain = time_ms(torch, lambda: cachekey_hash_ref(tok))
    h_bound, h_by = hash_bound(n_main, L_main)
    log(f"kernels: cachekey_hash main shape, a plan's largest digest batch "
        f"N={n_main} L={L_main}: kernel {h_ms:.4f} ms (device-only "
        f"{fmt_ms(h_dev)}, profiler), plain {h_plain:.4f} ms, bound "
        f"{h_bound * 1e3:.4f} us ({h_by}); timed at (1, 64): "
        f"{hash_timed[(1, 64)][0]:.4f} ms, at (65536, 64): "
        f"{hash_timed[(65536, 64)][0]:.4f} ms; {card}")

    # -- 7. result lines ----------------------------------------------------
    log(json.dumps({"kernels": [{
        "name": "dense_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/dense_topk/csrc/dense_topk.cu",
        "replaces": "src/repro/kernels/dense_topk/kernel.py:96",
        "launches": launches + planner["dense_topk"], **topk_entry}, {
        "name": "cachekey_hash", "route": "cuda",
        "source": "src/repro_torch/kernels/cachekey_hash/csrc/"
                  "cachekey_hash.cu",
        "replaces": "src/repro/kernels/cachekey_hash/kernel.py:54",
        "launches": t2["launches"] + planner["cachekey_hash"],
        "max_abs_err": 0, "ms": h_ms,
        "plain_ms": h_plain, "bound_ms": h_bound, "bound_by": h_by,
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
        **flash_entry}, {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:43",
        **bag_entry}, {
        "name": "bm25_block", "route": "cuda",
        "source": "src/repro_torch/kernels/bm25_block/csrc/bm25_block.cu",
        "replaces": "src/repro/kernels/bm25_block/kernel.py:51",
        **bm25_entry}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
