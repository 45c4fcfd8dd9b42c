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
7. serve: the ``hybrid`` scenario (``(bm25 % 10 | dense % 10) >> text
   >> mono``) over ``msmarco_like(1, scale=1.0)``, each leg one
   ``repro_torch.serve.drive_closed_loop`` of 400 closed-loop requests
   from 4 clients: (a) without a cache, then ``search()`` of every
   topic against an offline ``ExecutionPlan.run``; (b) cold over a fresh
   sqlite directory; (c) warm, a new service over it: no misses, hits
   served by prefetch, no ``dense_topk`` launch; (d) the same directory
   as ``mmap:sqlite``: no misses; (e) ``warm_scenario`` into a fresh
   directory, then a service over it: no misses; then the ``dense``
   scenario without a cache.  Every leg launches ``cachekey_hash`` only
   at service start (as many times as its plan's compile alone) and
   the uncached legs ``dense_topk`` once per micro-batch; then
   ``dense_topk`` at the serving shape against its plain version, timed
   beside ``torch.topk(q @ c.T)``;
8. fleet: the same ``hybrid`` scenario served by spawned worker
   processes on the card, each leg one ``drive_closed_loop`` (400
   closed-loop requests from 4 clients) or one open-loop burst: (f1)
   two workers, no cache, round robin — every worker on ``cuda:0``
   launches ``dense_topk``, and a second fleet's per-qid results equal
   an offline ``ExecutionPlan.run``; (f2) ``python -m repro_torch.cli
   cache warm hybrid`` into a fresh ``mmap:sqlite`` directory in a
   subprocess, then two workers warm-starting from it: no warm or
   online miss, no ``dense_topk`` launch after a worker's start, and
   ``cache verify`` / ``cache ls --json`` on the directory; (f3) three
   workers at ``max_batch`` 1, 60 requests submitted open loop and one
   worker killed: every request resolves to the offline result, the
   slot is respawned and every other worker exits 0.  The workers'
   launches come from their drain reports: the parent's counters cannot
   see another process;
9. compile_cache: the dense Experiment and Table 2's setting (1) with
   the encoders eager, through a fresh CUDA-graph memo cold and warm, and
   eager again (walls; means equal), the captures and replays per
   encoder and bucket, each bucket's replayed scores against eager (max
   difference, bit-identical or not), ``torch.profiler``'s launches of
   one bucket call eager and replayed, the dense Experiment's device
   busy share both ways, and two seeds of one MonoScorer config giving
   two entries and two score vectors;
10. lm: smollm-360m at full width and depth with random bf16 weights:
   a prefill of B 1 x S 4,096 (``"wgmma"``), 32 greedy decode steps into
   a cache of 4,128 keys (``"decode"``, ``sk_valid``), one step at
   32,768 keys and B 16 (decode_32k's batch of 128 cut to fit the card),
   each against the port's plain attention at ``LM_TOL``, the prefill in
   fp32 (``"simt"``), ``flash_attention``'s launches by path, walls and
   the kernel's share from ``torch.profiler``; the tests' tiny MoE
   config on the card against the CPU;
11. recsys: dlrm-rm2, dcn-v2, mind and two-tower-retrieval at their
   published widths (DLRM's tables 8.65 GB), native weights drawn on the
   card: ``recsys_serve`` at B 512 (and two-tower's 1 x 1,000,000
   retrieval) against float64 on the card, MIND's history through
   ``recsys.embedding_bag`` (one ``embedding_bag`` launch, against its
   plain version, timed beside its bound), ten in-place AdamW steps each
   from ``StepKeyedDataset(recsys_synthetic(cfg))`` (losses, median ms a
   step, peak memory), the tests' small configs card against CPU;
12. gcn: synthetic graphs at the reference's GNN shapes, three AdamW
   steps each: full_graph_sm (card against CPU), ogb_products (2.45M
   nodes, 61.9M edges), molecule, and the sampled step at
   minibatch_lg's batch through ``NeighborSampler`` over its 114.6M-edge
   graph;
13. train: ``examples/train_reranker_torch.py`` at ``EncoderConfig()``'s
   width, its first three steps, a step with 4 microbatches and one with
   int8 compression card against CPU (each step from the CPU's state:
   its loss, its gradient, and the step applied to the card's gradient
   on both), 100 steps, the trained scorer in
   the Experiment (nDCG@10, MAP; scores equal ``encoder_score`` of the
   trained weights exactly; its own ``fingerprint_extras``);
14. the ``kernels`` JSON line (``flash_attention``'s launches are the
   lm phase's smollm-360m runs, the tiny MoE's printed apart;
   ``embedding_bag``'s include the recsys phase's; ``cachekey_hash``'s
   the train phase's plan), then ``{"ok": true, "device": ...}``.

Any failure raises and the script exits non-zero.  Without a CUDA
device, or outside a checkout, it exits 1 and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
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
from typing import Optional

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
# (label, B, H, K, Sq, Sk, sk_valid, hd, causal, dtype, path): the
# reference's flash_attention sweep (tests/test_kernels.py FLASH_SWEEP),
# the shapes of benchmarks/kernels_bench.py, then smollm-360m's heads
# (configs/smollm_360m.py) at train_4k's length and a decode_32k step
# (configs/base.py LM_SHAPES) at the config's batch and at one sequence,
# and the lm phase's shapes: its first and last decode step into the
# 4,128-key cache (sk_valid 4,097 and 4,128), the 32k step at B 16, the
# fp32 prefill, and a prefill into a preallocated cache on the "wgmma"
# and "simt" paths with a ragged sk_valid.  sk_valid None is Sk; where
# it is given, keys past it hold NaN (a kernel that read one returns
# NaN) and the last valid key's values are LAST_KEY_V (one that stopped
# a key short moves every row that sees it far past the tolerance).
# The prefill is the main shape.  ``path`` is the kernel path_for must
# pick
FLASH_ROWS = [("sweep", 1, 2, 2, 64, 64, None, 32, True, "float32", "simt"),
              ("sweep", 2, 4, 2, 128, 128, None, 64, True, "float32",
               "simt"),
              ("sweep", 1, 8, 1, 128, 128, None, 64, True, "float32",
               "simt"),
              ("sweep", 2, 4, 4, 96, 96, None, 32, True, "float32", "simt"),
              ("sweep", 1, 2, 2, 64, 256, None, 64, True, "float32", "simt"),
              ("sweep", 1, 4, 2, 128, 128, None, 64, False, "float32",
               "simt"),
              ("sweep", 1, 2, 2, 128, 128, None, 128, True, "bfloat16",
               "wgmma"),
              ("kernels_bench", 1, 8, 2, 512, 512, None, 64, True, "float32",
               "simt"),
              ("kernels_bench", 2, 8, 8, 1024, 1024, None, 64, True,
               "float32", "simt"),
              ("smollm-360m prefill", 1, 15, 5, 4096, 4096, None, 64, True,
               "bfloat16", "wgmma"),
              ("smollm-360m decode", 128, 15, 5, 1, 32768, None, 64, True,
               "bfloat16", "decode"),
              ("smollm-360m decode B=1", 1, 15, 5, 1, 32768, None, 64, True,
               "bfloat16", "decode"),
              ("lm phase first decode step", 1, 15, 5, 1, 4128, 4097, 64,
               True, "bfloat16", "decode"),
              ("lm phase last decode step", 1, 15, 5, 1, 4128, 4128, 64,
               True, "bfloat16", "decode"),
              ("lm phase decode_32k B=16", 16, 15, 5, 1, 32768, 32768, 64,
               True, "bfloat16", "decode"),
              ("lm phase prefill f32", 1, 15, 5, 4096, 4096, None, 64, True,
               "float32", "simt"),
              ("prefill into a cache", 1, 15, 5, 4096, 4128, 4100, 64, True,
               "bfloat16", "wgmma"),
              ("prefill into a cache f32", 1, 15, 5, 4096, 4128, 4100, 64,
               True, "float32", "simt")]
FLASH_MAIN = "smollm-360m prefill"
# the values of the last valid key of a FLASH_ROWS row that gives
# sk_valid: exact in bf16, large enough that a kernel one key short
# fails, small enough that one skipping a tile of 64 keys fails too
LAST_KEY_V = 64.0
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
# the serve phase: the registry's scenario at the generator's full v1
# size (9,000 docs, 43 queries), as ServeConfig takes it, and the closed
# loop each leg runs
SERVE = dict(pipeline="hybrid", scale=1.0, cutoff=10, num_results=100,
             max_batch=16, max_wait_ms=2.0, exec_workers=4)
SERVE_REQUESTS, SERVE_CLIENTS = 400, 4
# served against offline for the encoder scenarios: equal docnos per
# qid and scores within this relative tolerance (fp32, TF32 off); a
# served micro-batch gives the encoders other batch shapes than the
# offline run, so cuBLAS may pick other kernels.  The docnos may differ
# only where a retriever's k-th and (k+1)-th scores lie within it.  The
# bm25 scenario is exact
SERVED_RTOL = 1e-5
# the fleet phase: the serve phase's config with this many worker
# processes a leg, and the chaos leg's open-loop burst
FLEET_WORKERS, CHAOS_WORKERS, CHAOS_REQUESTS = 2, 3, 60


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


def driven(torch, fn, name: str, expect: Optional[int]):
    """(``fn()``, launches of kernel ``name`` in it), with every kernel's
    launch count set to 0 just before and read just after; raises unless
    ``name`` launched ``expect`` times (any number if None) and no other
    kernel launched."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in wrappers.items()}
    if expect is None:
        expect = counts[name]
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
    """(max abs err, largest share of the bound used, elements beyond it
    or not finite) of ``got`` against ``want``: TOL_FLASH[dt] on the
    fp32-P paths, ``bf16p_excess`` on "wgmma"."""
    from repro_torch.kernels.flash_attention.ref import bf16p_excess
    diff = (got.float() - want.float()).abs()
    if path == "wgmma":
        share = bf16p_excess(got, q, k, v, causal=causal, plain=want)
    else:
        rtol, atol = TOL_FLASH[dt]
        share = diff / (atol + rtol * want.float().abs())
    return float(diff.max()), float(share.max()), int((~(share <= 1)).sum())


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
    row on the path it names, with the kernel, plain and SDPA times.  A
    row that gives sk_valid is checked with NaN keys past it and
    LAST_KEY_V at its last valid key, against the plain version of the
    first sk_valid keys, and shows that a kernel one key short fails;
    these rows and smollm-360m's show that one skipping a tile fails.
    Returns the main row's entry (the prefill: its ms, bound and error
    are this row's; its launches are the lm phase's)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     flash_attention_op)
    from repro_torch.kernels.flash_attention.kernel import (decode_splits,
                                                            path_for)
    gen = torch.Generator(device="cuda").manual_seed(4)
    entry = None
    for label, B, H, K, Sq, Sk, sk_valid, hd, causal, dt, path in FLASH_ROWS:
        dtype = getattr(torch, dt)
        sv = Sk if sk_valid is None else sk_valid
        if path_for(dtype, B, H, K, Sq, sv, hd, causal) != path:
            raise AssertionError(f"flash_attention {label}: path_for picks "
                                 f"{path_for(dtype, B, H, K, Sq, sv, hd, causal)}"
                                 f", not {path}")
        expect = 2 if path == "decode" and decode_splits(B, K, sv)[0] > 1 \
            else 1
        q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=dtype)
                   for s in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd)))
        if sk_valid is not None:
            k[:, :, sv:] = float("nan")
            v[:, :, sv:] = float("nan")
            v[:, :, sv - 1] = LAST_KEY_V
        flash_attention.paths.clear()
        got, n = driven(torch, lambda: flash_attention_op(
            q, k, v, causal=causal, sk_valid=sk_valid), "flash_attention",
            expect)
        if dict(flash_attention.paths) != {path: 1}:
            raise AssertionError(f"flash_attention {label}: paths "
                                 f"{dict(flash_attention.paths)}, expected "
                                 f"one call on {path}")
        # the plain version of the first sv keys; its default q_offset
        # (sv - Sq) is the kernel's
        ks, vs = (k, v) if sv == Sk else \
            (k[:, :, :sv].contiguous(), v[:, :, :sv].contiguous())
        want = attention_ref(q, ks, vs, causal=causal)
        err, share, beyond = flash_within(got, want, dt, path, q, ks, vs,
                                          causal)
        bound_name = "bf16p bound" if path == "wgmma" \
            else f"(rtol, atol) {TOL_FLASH[dt]}"
        if beyond:
            raise AssertionError(f"flash_attention {label} "
                                 f"{(B, H, K, Sq, Sk, sk_valid, hd)} {dt}: "
                                 f"{beyond} elements beyond the {bound_name}"
                                 f" or not finite, max_abs_err {err}")
        if sk_valid is not None:
            short = attention_ref(q, ks[:, :, :sv - 1], vs[:, :, :sv - 1],
                                  causal=causal, q_offset=sv - Sq)
            s_err, _, s_beyond = flash_within(short, want, dt, path, q, ks,
                                              vs, causal)
            if not s_beyond:
                raise AssertionError(f"flash_attention {label}: the "
                                     f"{bound_name} passes an output that "
                                     f"stops at key {sv - 2}")
            log(f"kernels: flash_attention {label}: stopping one key short "
                f"of sk_valid {sv} would fail the {bound_name} at "
                f"{s_beyond} of {want.numel()} elements (max_abs_err "
                f"{s_err:.3g}); a key past it is NaN")
            del short
        if label.startswith("smollm") or sk_valid is not None:
            lo = sv // 2 // 64 * 64
            d_err, d_share, d_beyond = flash_within(
                attention_skipping_tile(torch, q, ks, vs, causal, lo),
                want, dt, path, q, ks, vs, causal)
            if not d_beyond:
                raise AssertionError(f"flash_attention {label}: the "
                                     f"{bound_name} passes an output that "
                                     f"skips keys [{lo}, {lo + 64})")
            log(f"kernels: flash_attention {label}: skipping keys [{lo}, "
                f"{lo + 64}) would fail the {bound_name} at {d_beyond} of "
                f"{want.numel()} elements (max_abs_err {d_err:.3g}, "
                f"{d_share:.3g}x the bound); the kernel used {share:.3g}x "
                f"of it")
        del got, want, ks, vs
        if sk_valid is not None:                  # finite again for timing
            k[:, :, sv:].normal_(generator=gen)
            v[:, :, sv:].normal_(generator=gen)
        # SDPA's causal mask is aligned top-left: is_causal only where
        # Sq = Sk = sv; an explicit mask where some key is masked
        j = torch.arange(Sk, device="cuda")[None, :]
        keep = j < sv
        if causal:
            keep = keep & (j <= torch.arange(Sq, device="cuda")[:, None]
                           + (sv - Sq))
        is_causal = causal and Sq == Sk == sv
        mask = None if is_causal or bool(keep.all()) else keep
        ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=causal,
                                                    sk_valid=sk_valid))
        plain_ms = time_ms(torch, lambda: attention_ref(
            q, k, v, causal=causal, sk_valid=sk_valid))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=is_causal, enable_gqa=True))
        bound_ms, bound_by = flash_bound(B, H, K, Sq, sv, hd, causal, dt)
        log(f"kernels: flash_attention {label} B={B} H={H} K={K} Sq={Sq} "
            f"Sk={Sk} sk_valid={sv} hd={hd} "
            f"{'causal' if causal else 'full'} {dt}: path "
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
                "cache_prefetched": st.cache_prefetched,
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
                "cache_prefetched": st.cache_prefetched,
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


def find_stages(pipeline, cls) -> list:
    """The ``cls`` instances inside a pipeline expression."""
    from repro_torch.core import Transformer
    out, stack, seen = [], [pipeline], set()
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, cls):
            out.append(x)
        if isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, Transformer):
            stack.extend(vars(x).values())
    return out


def served_vs_offline(served, offline, retrievers, k: int) -> tuple:
    """(largest relative score difference, qids whose docnos differ at a
    near tie): raises unless every qid has the offline docnos and scores
    within ``SERVED_RTOL``, or its docnos differ only where one of
    ``retrievers`` scores its k-th and (k+1)-th docs within it."""
    def by_qid(frame):
        return {str(key[0]): frame.take(rows)
                for key, rows in frame.group_indices(["qid"]).items()}
    got, want = by_qid(served), by_qid(offline)
    if set(got) != set(want):
        raise AssertionError("serve: served and offline qids differ")
    worst, ties = 0.0, 0
    for qid, w in want.items():
        g = got[qid]
        gs = dict(zip(g["docno"].tolist(), g["score"].tolist()))
        ws = dict(zip(w["docno"].tolist(), w["score"].tolist()))
        if set(gs) != set(ws):
            query = str(w["query"].tolist()[0])
            if not any(near_tie(r, qid, query, k) for r in retrievers):
                raise AssertionError(f"serve: qid {qid} served other docnos "
                                     f"than offline, not at a near tie")
            ties += 1
        for d in set(gs) & set(ws):
            rel = abs(gs[d] - ws[d]) / max(abs(ws[d]), 1e-30)
            if rel > SERVED_RTOL:
                raise AssertionError(f"serve: qid {qid} doc {d} scored "
                                     f"{gs[d]} served, {ws[d]} offline")
            worst = max(worst, rel)
    return worst, ties


def near_tie(retriever, qid: str, query: str, k: int) -> bool:
    """Whether ``retriever`` scores its k-th and (k+1)-th docs for this
    query within ``SERVED_RTOL`` of each other."""
    from repro_torch.core import ColFrame
    out = retriever.transform(ColFrame({"qid": [qid], "query": [query]}))
    s = sorted(out["score"].tolist(), reverse=True)
    return len(s) > k and abs(s[k - 1] - s[k]) <= SERVED_RTOL * abs(s[k - 1])


def serve_leg(torch, card: str, label: str, cfg, scenario) -> dict:
    """One leg of the serve phase: ``drive_closed_loop(cfg,
    scenario=scenario)``, the entry point of ``repro_torch.cli serve``
    and the launcher, with the kernels' counts set to 0 just before and
    read just after.  Then the service's plan is compiled alone, with
    the config's cache knobs, and its ``cachekey_hash`` launches are the
    service start's; the leg must have launched as many, so none while
    serving.  Hits and misses are the record's; prefetched is the run
    that the service recorded in its plan manifest on close (none
    without a ``cache_dir``).  Prints the leg's line."""
    from repro_torch.core import ExecutionPlan
    from repro_torch.kernels.cachekey_hash import cachekey_hash
    from repro_torch.kernels.dense_topk import dense_topk
    from repro_torch.serve import drive_closed_loop
    at = time.time()
    cachekey_hash.launches = dense_topk.launches = 0
    rec = drive_closed_loop(cfg, scenario=scenario,
                            requests=SERVE_REQUESTS, clients=SERVE_CLIENTS)
    torch.cuda.synchronize()
    topk_launches, hash_launches = dense_topk.launches, \
        cachekey_hash.launches
    prefetched = 0
    if cfg.cache_dir is not None:
        runs = [r for f in sorted(Path(cfg.cache_dir, "plans").glob("*.json"))
                for r in json.loads(f.read_text())["runs"] if r["at"] >= at]
        if len(runs) != 1 or runs[0]["cache_hits"] != \
                rec["online"]["cache_hits"]:
            raise AssertionError(f"serve: {label}: the plan manifests hold "
                                 f"{len(runs)} runs of this leg, not one "
                                 f"with the record's hits: {runs}")
        prefetched = runs[0]["cache_prefetched"]
    cachekey_hash.launches = 0
    plan = ExecutionPlan([scenario.pipeline], cache_dir=cfg.cache_dir,
                         cache_backend=cfg.backend, on_stale=cfg.on_stale,
                         optimize=cfg.optimize, prefetch=cfg.prefetch)
    plan.close()
    torch.cuda.synchronize()
    row = {"leg": label, "pipeline": cfg.pipeline, "backend": cfg.backend,
           **{k: rec[k] for k in ("requests", "batches", "wall_s",
                                  "throughput_rps", "p50_ms", "p99_ms")},
           "occupancy": rec["online"]["batch_occupancy"],
           "cache_hits": rec["online"]["cache_hits"],
           "cache_misses": rec["online"]["cache_misses"],
           "cache_prefetched": prefetched,
           "dense_topk_launches": topk_launches,
           "cachekey_hash_launches": hash_launches,
           "cachekey_hash_launches_at_start": cachekey_hash.launches}
    log(f"serve: {json.dumps(row)}; {card}")
    log(f"serve: {label}, per plan node (executions, p50 ms, p99 ms): "
        + json.dumps({node[:40]: (d["executions"], d["p50_ms"], d["p99_ms"])
                      for node, d in rec["online"]["nodes"].items()}))
    return row


def run_serve(torch, card: str) -> dict:
    """The serve phase (module docstring, item 7).  Returns the launches
    of ``dense_topk`` and ``cachekey_hash`` it made."""
    import dataclasses

    from repro_torch.caching import warm_scenario
    from repro_torch.core import ExecutionPlan
    from repro_torch.ir import BM25Retriever, DenseRetriever
    from repro_torch.kernels.dense_topk.kernel import _sms, plan
    from repro_torch.serve import ServeConfig, build_service

    base = ServeConfig(**SERVE)
    t = time.perf_counter()
    scenario = base.build_scenario()
    log(f"serve: {scenario.name} scenario, {len(scenario.topics)} topics, "
        f"built in {time.perf_counter() - t:.1f} s: {scenario.description}")
    retrievers = find_stages(scenario.pipeline, (DenseRetriever,
                                                 BM25Retriever))
    dense = find_stages(scenario.pipeline, DenseRetriever)[0]
    n_docs, width = dense.index.matrix.shape
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="serve-", dir=str(build)))
    legs = []
    try:
        legs.append(serve_leg(torch, card, "a: no cache", base, scenario))
        svc = build_service(base, scenario=scenario)
        try:
            served = svc.search(scenario.topics)
        finally:
            svc.close()
        offline = ExecutionPlan([scenario.pipeline]).run(
            scenario.topics)[0][0]
        worst, ties = served_vs_offline(served, offline, retrievers,
                                        SERVE["cutoff"])
        log(f"serve: search() of all {len(scenario.topics)} topics equals "
            f"one offline ExecutionPlan.run: docnos equal on every qid but "
            f"{ties} near ties, scores within {worst:.3g} relative "
            f"(tolerance {SERVED_RTOL})")
        cold = dataclasses.replace(base, cache_dir=str(root / "b"),
                                   backend="sqlite")
        legs.append(serve_leg(torch, card, "b: cold", cold, scenario))
        legs.append(serve_leg(torch, card, "c: warm", cold, scenario))
        legs.append(serve_leg(
            torch, card, "d: warm, mmap:sqlite",
            dataclasses.replace(cold, backend="mmap:sqlite"), scenario))
        warmed = dataclasses.replace(cold, cache_dir=str(root / "e"))
        t = time.perf_counter()
        report = warm_scenario(scenario, warmed.cache_dir, config=warmed)
        log(f"serve: warm_scenario {json.dumps(report)} in "
            f"{time.perf_counter() - t:.1f} s")
        legs.append(serve_leg(torch, card, "e: warmed", warmed, scenario))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the dense scenario, no cache
    dense_cfg = dataclasses.replace(base, pipeline="dense")
    legs.append(serve_leg(torch, card, "dense: no cache", dense_cfg,
                          dense_cfg.build_scenario()))

    a, b, c, d, e, f = legs
    if any(r["cachekey_hash_launches"] != r["cachekey_hash_launches_at_start"]
           or r["cachekey_hash_launches_at_start"] < 1 for r in legs):
        raise AssertionError("serve: a leg launched cachekey_hash other "
                             "than at service start, or never")
    if b["cache_misses"] < 1 or b["dense_topk_launches"] < 1:
        raise AssertionError("serve: the cold leg missed nothing or never "
                             "launched dense_topk")
    if c["cache_misses"] != 0 or not 0 < c["cache_prefetched"] <= \
            c["cache_hits"] or c["dense_topk_launches"] != 0:
        raise AssertionError(f"serve: the warm leg must miss nothing, serve "
                             f"0 < prefetched <= hits and launch no "
                             f"dense_topk: {c}")
    if d["cache_misses"] != 0 or e["cache_misses"] != 0:
        raise AssertionError("serve: the mmap:sqlite or the warmed leg "
                             "missed")
    # one dense_topk call per micro-batch, of as many launches as its
    # plan takes at any Q up to max_batch (the corpus split, the merge)
    per_call, = {plan(Q, n_docs, width, SERVE["cutoff"], sms=_sms(0)).launches
                 for Q in range(1, SERVE["max_batch"] + 1)}
    for r in (a, f):
        if r["dense_topk_launches"] != per_call * r["batches"]:
            raise AssertionError(f"serve: the {r['leg']} leg launched "
                                 f"dense_topk {r['dense_topk_launches']} "
                                 f"times in {r['batches']} micro-batches, "
                                 f"not {per_call} a batch")

    # dense_topk at the serving shape: Q 1 and 16 of the scenario's
    # queries against its 9,000 x 32 corpus, k = cutoff
    queries = scenario.topics["query"].tolist()
    c_serve = dense.index.matrix
    for Q in (1, SERVE["max_batch"]):
        q = dense.index.encoder.encode_queries(queries[:Q])
        time_topk(torch, card, "serving shape", q, c_serve, SERVE["cutoff"],
                  2e-5)
    return {"dense_topk": sum(r["dense_topk_launches"] for r in legs),
            "cachekey_hash": sum(r["cachekey_hash_launches"] for r in legs)}


def fleet_line(card: str, label: str, report: dict, **extra) -> dict:
    """Prints one ``fleet:`` line from a drain report (and the leg's
    latency and throughput in ``extra``); returns the line's record."""
    workers = report["workers"]
    row = {"leg": label, **extra,
           "batches": report["online"]["batches"],
           "occupancy": report["online"]["batch_occupancy"],
           "cache_hits": report["online"]["cache_hits"],
           "cache_misses": report["online"]["cache_misses"],
           "cache_prefetched": sum(w["cache_prefetched"] for w in workers),
           "workers": {w["worker"]: {
               "device": w["device"], "requests": w["requests"],
               "start_s": {k: round(v, 3) for k, v in w["start_s"].items()},
               "warm_wall_s": w.get("warm_wall_s"),
               "warm_hits": w.get("warm_hits"),
               "warm_misses": w.get("warm_misses"),
               "launches_at_start": w["kernel_launches_at_start"],
               "launches": w["kernel_launches"]} for w in workers},
           "exit_codes": report["exit_codes"],
           "lost_exit_codes": report["lost_exit_codes"],
           "respawns": report["respawns"], "requeued": report["requeued"]}
    log(f"fleet: {json.dumps(row)}; {card}")
    return row


def fleet_launches(report: dict) -> dict:
    """The kernels' launches in the drained workers of one fleet."""
    return {k: sum(w["kernel_launches"][k] for w in report["workers"])
            for k in ("dense_topk", "cachekey_hash")}


def check_fleet_workers(label: str, report: dict, n: int, device: str,
                        cuda: bool) -> None:
    """Raises unless ``n`` workers drained, each on ``device``, with exit
    code 0, and (on the card) each launched ``cachekey_hash`` at start."""
    codes = report["exit_codes"]
    if len(report["workers"]) != n or set(codes.values()) != {0} \
            or len(codes) != n:
        raise AssertionError(f"fleet: {label}: {n} workers must drain and "
                             f"exit 0: exit codes {codes}, "
                             f"{len(report['workers'])} drained")
    for w in report["workers"]:
        if w["device"] != device:
            raise AssertionError(f"fleet: {label}: worker {w['worker']} "
                                 f"served on {w['device']}, not {device}")
        if cuda and w["kernel_launches_at_start"]["cachekey_hash"] < 1:
            raise AssertionError(f"fleet: {label}: worker {w['worker']} "
                                 f"compiled its plan without cachekey_hash")


def cli(*args: str) -> subprocess.CompletedProcess:
    """``python -m repro_torch.cli ...`` in a subprocess of this checkout."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.cli", *args],
                          capture_output=True, text=True, env=env,
                          timeout=600)


def run_fleet(torch, card: str, base=None) -> dict:
    """The fleet phase (module docstring, item 8) over ``base``, the
    serve phase's config unless given.  Returns the launches of
    ``dense_topk`` and ``cachekey_hash`` the drained workers made."""
    import dataclasses

    from repro_torch.caching import BACKENDS
    from repro_torch.caching.backends import split_combinator
    from repro_torch.core import ColFrame, ExecutionPlan
    from repro_torch.ir import BM25Retriever, DenseRetriever
    from repro_torch.serve import (FleetService, ServeConfig, build_service,
                                   drive_closed_loop)

    base = base or ServeConfig(**SERVE)
    cuda = base.device != "cpu"
    device = "cuda:0" if cuda else "cpu"
    scenario = base.build_scenario()
    retrievers = find_stages(scenario.pipeline, (DenseRetriever,
                                                 BM25Retriever))
    offline = ExecutionPlan([scenario.pipeline]).run(scenario.topics)[0][0]
    offline_by_qid = {str(key[0]): offline.take(idx) for key, idx in
                      offline.group_indices(["qid"]).items()}
    rows = list(zip([str(q) for q in scenario.topics["qid"].tolist()],
                    scenario.topics["query"].tolist()))
    launches = collections.Counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="fleet-", dir=str(build)))
    try:
        # (f1) two workers, no cache, round robin
        cfg = dataclasses.replace(base, workers=FLEET_WORKERS, routing="rr")
        t = time.perf_counter()
        rec = drive_closed_loop(cfg, scenario=scenario,
                                requests=SERVE_REQUESTS,
                                clients=SERVE_CLIENTS, drain=True)
        fleet_line(card, "f1: 2 workers, no cache", rec["fleet"],
                   requests=rec["requests"], p50_ms=rec["p50_ms"],
                   p99_ms=rec["p99_ms"], rps=rec["throughput_rps"],
                   wall_s=round(time.perf_counter() - t, 3))
        check_fleet_workers("f1", rec["fleet"], FLEET_WORKERS, device, cuda)
        if rec["requests"] != SERVE_REQUESTS or not rec["drained"]:
            raise AssertionError(f"fleet: f1 resolved {rec['requests']} "
                                 f"requests, drained {rec['drained']}")
        if cuda and any(w["kernel_launches"]["dense_topk"] < 1
                        for w in rec["fleet"]["workers"]):
            raise AssertionError("fleet: f1: a worker never launched "
                                 "dense_topk")
        launches.update(fleet_launches(rec["fleet"]))
        t = time.perf_counter()
        with build_service(cfg) as svc:
            futs = [svc.submit(qid, query) for qid, query in rows]
            served = ColFrame.concat([f.result(120) for f in futs])
            report = svc.drain()
        fleet_line(card, "f1: every topic once", report,
                   requests=len(rows),
                   wall_s=round(time.perf_counter() - t, 3))
        check_fleet_workers("f1 topics", report, FLEET_WORKERS, device, cuda)
        launches.update(fleet_launches(report))
        worst, ties = served_vs_offline(served, offline, retrievers,
                                        base.cutoff)
        log(f"fleet: f1: all {len(rows)} topics served by the fleet equal "
            f"one offline ExecutionPlan.run: docnos equal on every qid but "
            f"{ties} near ties, scores within {worst:.3g} relative "
            f"(tolerance {SERVED_RTOL})")

        # (f2) warm: cache warm in a subprocess, then a warm-started fleet
        d = root / "f2"
        t = time.perf_counter()
        warm = cli("cache", "warm", base.pipeline, "--cache-dir", str(d),
                   "--backend", "mmap:sqlite", "--scale", str(base.scale),
                   "--cutoff", str(base.cutoff), "--num-results",
                   str(base.num_results), "--seed", str(base.seed),
                   *(["--device", "cpu"] if not cuda else []), "--json")
        if warm.returncode != 0:
            raise AssertionError(f"fleet: cache warm failed:\n"
                                 f"{warm.stderr[-3000:]}")
        log(f"fleet: f2: cache warm {json.dumps(json.loads(warm.stdout))} "
            f"in {time.perf_counter() - t:.1f} s (subprocess)")
        cfg = dataclasses.replace(base, workers=FLEET_WORKERS,
                                  cache_dir=str(d), backend="mmap:sqlite",
                                  warm_start=True)
        t = time.perf_counter()
        rec = drive_closed_loop(cfg, scenario=scenario,
                                requests=SERVE_REQUESTS,
                                clients=SERVE_CLIENTS, drain=True)
        fl = rec["fleet"]
        fleet_line(card, "f2: 2 workers, warm mmap:sqlite", fl,
                   requests=rec["requests"], p50_ms=rec["p50_ms"],
                   p99_ms=rec["p99_ms"], rps=rec["throughput_rps"],
                   wall_s=round(time.perf_counter() - t, 3))
        check_fleet_workers("f2", fl, FLEET_WORKERS, device, cuda)
        launches.update(fleet_launches(fl))
        for w in fl["workers"]:
            if w.get("warm_misses") != 0 or not w.get("warm_hits"):
                raise AssertionError(f"fleet: f2: worker {w['worker']} "
                                     f"warmed with {w.get('warm_hits')} "
                                     f"hits, {w.get('warm_misses')} misses")
            if w["kernel_launches"]["dense_topk"] != \
                    w["kernel_launches_at_start"]["dense_topk"]:
                raise AssertionError(f"fleet: f2: worker {w['worker']} "
                                     f"launched dense_topk after its start")
        if fl["online"]["cache_misses"] != 0 or \
                fl["online"]["cache_hits"] < 1:
            raise AssertionError(f"fleet: f2 missed: {fl['online']}")
        ver = cli("cache", "verify", str(d))
        ls = cli("cache", "ls", "--json", str(d))
        if ver.returncode != 0 or ls.returncode != 0:
            raise AssertionError(f"fleet: cache verify / ls failed:\n"
                                 f"{ver.stdout[-2000:]}{ls.stderr[-2000:]}")
        dirs = json.loads(ls.stdout)["dirs"]
        referenced = {n["dir"] for f in (d / "plans").glob("*.json")
                      for n in json.loads(f.read_text())["nodes"]
                      if n.get("dir")}
        counted = {}
        for r in dirs:
            combo = split_combinator(r["backend"])
            store = BACKENDS[combo[1] if combo else r["backend"]](r["path"])
            try:
                counted[r["dir"]] = (r["entry_count"], len(store))
            finally:
                store.close()
        if not referenced or not referenced <= set(counted) or \
                any(a != b or a < 1 for a, b in counted.values()):
            raise AssertionError(f"fleet: f2: cache ls lists "
                                 f"{counted} (manifest, store), the plans "
                                 f"reference {sorted(referenced)}")
        log(f"fleet: f2: cache verify exit 0 "
            f"({ver.stdout.strip().splitlines()[-1]}); cache ls --json: "
            f"{len(dirs)} node directories ({len(referenced)} referenced "
            f"by the last plan manifest), entries (manifest, store) "
            f"{json.dumps(counted)}")

        # (f3) chaos: three workers, one killed mid-stream
        cfg = dataclasses.replace(base, workers=CHAOS_WORKERS, max_batch=1)
        t = time.perf_counter()
        with FleetService(cfg) as svc:
            start = time.perf_counter() - t
            t = time.perf_counter()
            sent = [rows[i % len(rows)] for i in range(CHAOS_REQUESTS)]
            futs = [svc.submit(qid, query) for qid, query in sent]
            killed = svc.kill_worker()
            frames = [f.result(120) for f in futs]
            wall = time.perf_counter() - t
            summary = svc.stats.summary()
            report = svc.drain()
        for (qid, _), frame in zip(sent, frames):
            served_vs_offline(frame, offline_by_qid[qid], retrievers,
                              base.cutoff)
        fleet_line(card, f"f3: 3 workers, max_batch 1, worker {killed} "
                   f"killed", report, requests=len(frames),
                   p50_ms=summary["p50_ms"], p99_ms=summary["p99_ms"],
                   rps=round(len(frames) / wall, 2),
                   wall_s=round(wall, 3), start_s=round(start, 3))
        check_fleet_workers("f3", report, CHAOS_WORKERS, device, cuda)
        launches.update(fleet_launches(report))
        if report["respawns"] < 1 or killed not in report["lost_exit_codes"]:
            raise AssertionError(f"fleet: f3: respawns "
                                 f"{report['respawns']}, lost "
                                 f"{report['lost_exit_codes']}")
        log(f"fleet: f3: all {len(frames)} requests resolved equal to "
            f"offline; worker {killed} killed (exit code "
            f"{report['lost_exit_codes'][killed]}), "
            f"{report['respawns']} respawned, {report['requeued']} "
            f"requeued")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(launches)


class EagerMemo:
    """Stands in for the process-wide ``CompileCache`` in A/B runs: every
    call runs the function eagerly, as the encoders did before the
    memo."""

    def call(self, name, fn, *args, weight_source=None, **kwargs):
        import torch
        with torch.inference_mode():
            return fn(*args, **kwargs)


@contextlib.contextmanager
def memo_in_place(memo):
    """``memo`` as the encoders' process-wide compile cache meanwhile."""
    import repro_torch.caching.compile_cache as cc
    prev = cc.default_compile_cache
    cc.default_compile_cache = memo
    try:
        yield memo
    finally:
        cc.default_compile_cache = prev


def launches_per_call(torch, fn) -> dict:
    """``torch.profiler``'s count of one call of ``fn``: kernel launches
    the host issued, graph launches, and kernels that ran on the
    device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"host_kernel_launches": 0, "graph_launches": 0,
           "device_kernels": 0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if "memcpy" not in e.key.lower() and "memset" not in e.key.lower():
                out["device_kernels"] += e.count
        elif "LaunchKernel" in e.key:
            out["host_kernel_launches"] += e.count
        elif "GraphLaunch" in e.key:
            out["graph_launches"] += e.count
    return out


def busy_share(torch, fn) -> tuple:
    """(wall s, device-busy s, share) of one call of ``fn`` under
    ``torch.profiler``: the device-side kernels' time over the wall, as
    ``tools/torch_profile_main_path.py`` counts it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev = sum(float(getattr(e, "self_device_time_total", 0.0))
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA) / 1e6
    return wall, dev, dev / wall


def run_compile_cache(torch, card: str, mp, main_res, t2_base) -> dict:
    """The encoders with and without the CUDA-graph memo, in one call:
    the dense Experiment and Table 2's setting (1) eager, through a fresh
    memo cold (captures), then warm (replays only) and eager in turns,
    four runs each; each run's means and per-query values equal the
    earlier phases' (1e-6); the captures and replays per encoder and
    bucket; each bucket's scores replayed against eager, with the
    largest difference and whether they are bit-identical;
    ``torch.profiler``'s launches of one bucket call eager and replayed,
    and its host time to the scores;
    the dense Experiment's device busy share both ways; two seeds of one
    MonoScorer config giving two entries and two score vectors.
    Returns the memo's counts."""
    import numpy as np

    from repro_torch.caching import CompileCache
    from repro_torch.core import Experiment
    from repro_torch.models.cross_encoder import EncoderConfig, MonoScorer

    names = [f"k={k}" for k in CUTS]

    def table2():
        systems = [mp.index.bm25(num_results=max(CUTS)) % k >> mp.tl
                   >> mp.mono % 10 >> mp.duo for k in CUTS]
        return Experiment(systems, mp.topics, mp.qrels, MEASURES,
                          names=names)

    memo = CompileCache()
    runs = collections.defaultdict(list)
    # eager, then the memo cold, then warm and eager in turns (host walls
    # on a shared host spread; the turns put both in each stretch)
    for label in ("eager", "memo cold") + ("memo warm", "eager",
                                           "eager", "memo warm") * 2:
        stand_in = EagerMemo() if label == "eager" else memo
        with memo_in_place(stand_in):
            row = {}
            for what, fn, base, nm in (("dense", lambda: mp.run("cuda"),
                                        main_res, NAMES),
                                       ("table2 (1)", table2, t2_base,
                                        names)):
                t = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                row[what] = time.perf_counter() - t
                same_results(f"compile_cache {label} {what}", res, base, nm)
            runs[label].append(row)
        log("compile_cache: " + json.dumps(
            {"run": label, **{f"{k}_wall_s": round(v, 3)
                              for k, v in row.items()},
             "captures": memo.stats.compile_misses,
             "replays": sum(c for _, c in memo.entries()),
             "capture_s": round(memo.stats.compile_time_s, 3)}))
        if label == "memo cold":
            captured = memo.stats.compile_misses
    if memo.stats.compile_misses != captured or captured < 1:
        raise AssertionError(f"compile_cache: the warm run captured "
                             f"{memo.stats.compile_misses - captured} graphs")
    log(f"compile_cache: every memo run's means and per-query values equal "
        f"the eager runs' and the earlier phases' to 1e-6; median walls, s: "
        + json.dumps({label: {what: round(statistics.median(
            r[what] for r in rows), 3) for what in rows[0]}
            for label, rows in runs.items()}) + f"; {card}")
    per = collections.defaultdict(list)
    for key, calls in memo.entries():
        per[key[0]].append((key[1][0][0][1][0], calls))
    for name, rows in sorted(per.items()):
        log(f"compile_cache: {name}: (bucket, replays) "
            f"{sorted(rows)}; {len(rows)} captures")

    # each bucket's scores, replayed against eager, on the main path's
    # pairs (its queries against its corpus's texts)
    texts = list(mp.tl.text_map.values())
    queries = mp.topics["query"].tolist()
    worst, identical = 0.0, True
    for b in (8, 16, 32, 64, 128, 256, 512, 1024):
        qs = [queries[i % len(queries)] for i in range(b)]
        ts = [texts[(7 * i) % len(texts)] for i in range(b)]
        for scorer in (mp.mono, mp.duo):
            with memo_in_place(EagerMemo()):
                eager = scorer._score_pairs(qs, ts)
            with memo_in_place(memo):
                replay = scorer._score_pairs(qs, ts)
            worst = max(worst, float(np.abs(eager - replay).max()))
            identical &= bool(np.array_equal(eager, replay))
    dense_texts = texts[:300]
    with memo_in_place(EagerMemo()):
        e = mp.dense_enc.encode(dense_texts)
    with memo_in_place(memo):
        r = mp.dense_enc.encode(dense_texts)
    torch.cuda.synchronize()
    d_worst = float((e - r).abs().max())
    d_identical = bool(torch.equal(e, r))
    if worst > 1e-5 or d_worst > 1e-5:
        raise AssertionError(f"compile_cache: replayed scores differ from "
                             f"eager by {worst} (Mono, Duo) and {d_worst} "
                             f"(dense)")
    log(f"compile_cache: replay against eager at buckets 8-1,024 (Mono and "
        f"Duo) and the dense encoder's 256 + 44 (padded to 48) texts: max "
        f"abs diff {worst:.3g} / {d_worst:.3g}, bit-identical "
        f"{identical} / {d_identical}")

    # launches of one bucket call, eager and replayed
    for b in (8, 128, 1024):
        qs = [queries[i % len(queries)] for i in range(b)]
        ts = [texts[(3 * i) % len(texts)] for i in range(b)]
        toks = np.stack([mp.mono.tokenizer.encode_pair(q, t, 64)
                         for q, t in zip(qs, ts)])
        counts = {}
        for label, stand_in in (("eager", EagerMemo()), ("replay", memo),
                                ("eager", EagerMemo()), ("replay", memo)):
            with memo_in_place(stand_in):
                row = counts.setdefault(label, {**launches_per_call(
                    torch, lambda: mp.mono._score_tokens(toks)),
                    "call_ms": []})
                times = []
                for _ in range(20):
                    t = time.perf_counter()
                    mp.mono._score_tokens(toks)     # ends in a copy out
                    times.append(time.perf_counter() - t)
                row["call_ms"].append(round(statistics.median(times) * 1e3,
                                            4))
        log(f"compile_cache: Mono bucket {b}, one call (profiler counts; "
            f"host ms to the scores on the host, median of 20, two "
            f"turns): " + json.dumps(counts) + f"; {card}")

    # the dense Experiment's device busy share, eager and replayed
    shares = {}
    for label, stand_in in (("eager", EagerMemo()), ("memo", memo),
                            ("memo", memo), ("eager", EagerMemo())):
        with memo_in_place(stand_in):
            shares.setdefault(label, []).append(
                busy_share(torch, lambda: mp.run("cuda")))
    log("compile_cache: dense Experiment under torch.profiler, (wall s, "
        "device-busy s, share): " + json.dumps(
            {k: [[round(x, 4) for x in v] for v in vs]
             for k, vs in shares.items()}) + f"; {card}")

    # two seeds of one MonoScorer config: two entries, two score vectors
    mono3 = MonoScorer(EncoderConfig(), seed=3)
    qs, ts = queries[:8], texts[:8]
    with memo_in_place(memo):
        before = len([k for k, _ in memo.entries()
                      if k[0] == "MonoScorer:mono-ce"
                      and k[1][0][0][1][0] == 8])
        s0, s3 = mp.mono._score_pairs(qs, ts), mono3._score_pairs(qs, ts)
        after = [k for k, _ in memo.entries()
                 if k[0] == "MonoScorer:mono-ce" and k[1][0][0][1][0] == 8]
    diff = float(np.abs(s0 - s3).max())
    if len(after) != before + 1 or before != 1 or diff <= 1e-3:
        raise AssertionError(f"compile_cache: two seeds gave {len(after)} "
                             f"entries at bucket 8 and scores {diff} apart")
    log(f"compile_cache: MonoScorer seeds 0 and 3 in one process: "
        f"{len(after)} entries at bucket 8 (weight sources "
        f"{sorted(str(k[3][1:]) for k in after)}), scores differ by up to "
        f"{diff:.3g}")
    return {"captures": memo.stats.compile_misses,
            "replays": sum(c for _, c in memo.entries())}


# smollm-360m's lm phase: train_4k's length, 32 decode steps after it,
# and one step at decode_32k's cache length at B 16 (decode_32k's
# global_batch 128 would need a 172 GB cache: more than the card's 80 GB)
LM_PREFILL, LM_STEPS, LM_32K, LM_32K_BATCH = 4096, 32, 32768, 16
# logits of the kernel path against the port's plain attention on the
# card, as ||flash - plain||_2 / ||plain||_2: bf16 rounds the plain path's
# scores, probabilities and PV product to bf16 (2**-8 each) where the
# kernels keep them in fp32, and 32 layers carry the difference forward:
# each path lies ~2 % from an fp32 run of the same weights (the port on
# the CPU, S 256), so 2**-4 for their distance; a wiring fault (a decode
# step whose heads read the wrong KV heads) lands past it, as the phase
# shows.
# In fp32 both sum in fp32 in other orders, so 1e-4
LM_TOL = {"bfloat16": 2 ** -4, "float32": 1e-4}
# the tests' tiny MoE config on the card against the CPU (fp32)
LM_MOE_ATOL = 1e-4


def conditioned(params: dict, cfg) -> dict:
    """The attention projections of random ``params`` rescaled in place
    to the fan-in of the dimensions they contract (D for wq, wk and wv,
    H·hd for wo).  The reference's init, which the port copies, takes
    the fan-in from a spec's second-to-last axis: H or K for these, hd
    for wo.  A random smollm-360m drawn so has attention scores of ~100,
    its softmax saturates, and bf16 rounding of the scores decides which
    key wins: no two bf16 paths then agree with each other or with fp32
    (relative logit error ~1.3, the port on the CPU and on the card)."""
    import torch
    layers = params["layers"]
    with torch.no_grad():
        for name in ("wq", "wk", "wv"):
            layers[name].mul_(math.sqrt(layers[name].shape[-2]
                                        / cfg.d_model))
        layers["wo"].mul_(1 / math.sqrt(cfg.n_heads))
    return params


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def lm_counts(torch, fn):
    """(``fn()``, launches, calls by path) of ``flash_attention`` in it,
    every kernel's count set to 0 just before and read just after;
    raises if another kernel launched."""
    from repro_torch.kernels.flash_attention import flash_attention
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    flash_attention.paths.clear()
    out = fn()
    torch.cuda.synchronize()
    others = {n: w.launches for n, w in wrappers.items()
              if n != "flash_attention" and w.launches}
    if others:
        raise AssertionError(f"lm: other kernels launched: {others}")
    return out, flash_attention.launches, dict(flash_attention.paths)


def kernel_share(torch, fn) -> tuple:
    """(wall ms, device ms, flash_attention's device ms) of one call of
    ``fn``: the wall the median of 5 calls, each ended by a synchronise;
    the device times from one more under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = flash = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = float(getattr(e, "self_device_time_total", 0.0))
            dev += us
            if any(n in e.key for n in ("wgmma_kernel", "decode_kernel",
                                        "combine_kernel",
                                        "flash_attention_kernel")):
                flash += us
    return wall * 1e3, dev / 1e3, flash / 1e3


def run_lm(torch, card: str) -> dict:
    """smollm-360m at full width and depth, random bf16 weights from
    ``torch.Generator``: a prefill of B 1 x S 4,096 (the "wgmma" path),
    32 greedy decode steps into a cache of 4,096 + 32 keys (the "decode"
    path with sk_valid), then one decode step at 32,768 keys and B 16;
    each step's logits against the same step through the port's plain
    attention (LM_TOL), the prefill again in fp32 on the "simt" path;
    launches per prefill and decode step by path, walls and the
    kernel's share from ``torch.profiler``; then the tests' tiny MoE
    config on the card against the CPU.  Returns ``flash_attention``'s
    launches in the smollm-360m runs (the bf16 prefill, the decode
    steps, the 32k step and the fp32 prefill) and, apart, in the tiny
    MoE's."""
    from dataclasses import replace

    from repro_torch.configs.smollm_360m import CONFIG
    from repro_torch.models import lm

    t = time.perf_counter()
    params, source = lm.load_params(CONFIG, seed=0)
    conditioned(params, CONFIG)
    torch.cuda.synchronize()
    log(f"lm: smollm-360m {lm.num_params(CONFIG):,} params, bf16, weights "
        f"{source} in {time.perf_counter() - t:.1f} s")
    gen = torch.Generator().manual_seed(11)
    V = CONFIG.vocab_size
    tokens = torch.randint(0, V, (1, LM_PREFILL), generator=gen).cuda()
    max_len = LM_PREFILL + LM_STEPS
    launches = 0

    # prefill, B 1 x S 4,096
    (logits, cache), n, paths = lm_counts(torch, lambda: lm.prefill(
        params, tokens, CONFIG, max_len=max_len))
    if paths != {"wgmma": CONFIG.n_layers} or n != CONFIG.n_layers:
        raise AssertionError(f"lm: prefill launched {n} on {paths}")
    launches += n
    plain, _ = lm.prefill(params, tokens, CONFIG, max_len=max_len,
                          attention="plain")
    err = rel_err(logits, plain)
    if not err <= LM_TOL["bfloat16"]:
        raise AssertionError(f"lm: prefill logits {err} from plain")
    pre_ms, pre_dev, pre_flash = kernel_share(torch, lambda: lm.prefill(
        params, tokens, CONFIG, max_len=max_len))
    log(f"lm: prefill B=1 S={LM_PREFILL}: flash_attention {n} launches "
        f"{paths}; logits vs plain attention rel err {err:.3g} (tol "
        f"{LM_TOL['bfloat16']:.3g}), max abs {float((logits - plain).abs().max()):.3g}"
        f" of max |logit| {float(plain.abs().max()):.3g}; wall "
        f"{pre_ms:.2f} ms, device {pre_dev:.2f} ms, flash_attention "
        f"{pre_flash:.3f} ms ({100 * pre_flash / pre_dev:.2f} % of device); "
        f"{card}")
    del plain

    # a wiring fault for scale: a decode step whose query heads read the
    # wrong KV heads (rolled by one).  A fault of a single key does not
    # show at this level (one key of 4,097 moves a logit by ~1/4,097);
    # the kernel rows above hold each kernel key by key
    fault_cache = {k: v.clone() for k, v in cache.items()}
    fault_tok = logits[:, :V].argmax(-1)
    plain, _ = lm.decode_one(params, fault_cache, fault_tok, LM_PREFILL,
                             CONFIG, attention="plain")
    op = lm.flash_attention_op
    lm.flash_attention_op = lambda q, k, v, **kw: op(
        q, k.roll(1, 1).contiguous(), v.roll(1, 1).contiguous(), **kw)
    try:
        faulty, _ = lm.decode_one(params, fault_cache, fault_tok,
                                  LM_PREFILL, CONFIG)
    finally:
        lm.flash_attention_op = op
    fault_err = rel_err(faulty, plain)
    if fault_err <= LM_TOL["bfloat16"]:
        raise AssertionError(f"lm: a decode step reading the wrong KV "
                             f"heads is within the tolerance ({fault_err})")
    del fault_cache, faulty, plain

    # 32 greedy decode steps into the 4,128-key cache
    errs, step_paths, step_launches, agree = [], collections.Counter(), 0, 0
    tok = logits[:, :V].argmax(-1)
    for i in range(LM_STEPS):
        pos = LM_PREFILL + i
        plain, _ = lm.decode_one(params, cache, tok, pos, CONFIG,
                                 attention="plain")
        (logits, _), n, paths = lm_counts(torch, lambda: lm.decode_one(
            params, cache, tok, pos, CONFIG))
        if sum(paths.values()) != CONFIG.n_layers or set(paths) != {"decode"}:
            raise AssertionError(f"lm: decode step {i} took {paths}")
        step_paths.update(paths)
        step_launches += n
        errs.append(rel_err(logits, plain))
        agree += int(torch.equal(logits[:, :V].argmax(-1),
                                 plain[:, :V].argmax(-1)))
        tok = logits[:, :V].argmax(-1)
    launches += step_launches
    if not max(errs) <= LM_TOL["bfloat16"]:
        raise AssertionError(f"lm: decode logits {max(errs)} from plain")
    pos = LM_PREFILL + LM_STEPS - 1
    dec_ms, dec_dev, dec_flash = kernel_share(torch, lambda: lm.decode_one(
        params, cache, tok, pos, CONFIG))
    from repro_torch.kernels.flash_attention.kernel import decode_splits
    log(f"lm: {LM_STEPS} greedy decode steps, cache {max_len} keys, "
        f"sk_valid {LM_PREFILL + 1}-{max_len}: flash_attention "
        f"{step_launches // LM_STEPS} launches a step ({CONFIG.n_layers} "
        f"calls, {decode_splits(1, 5, LM_PREFILL + 1)[0]} splits each, "
        f"decode + combine) {dict(step_paths)}; logits vs plain rel err "
        f"max {max(errs):.3g} mean {statistics.mean(errs):.3g} (tol "
        f"{LM_TOL['bfloat16']:.3g}; a step whose heads read the wrong KV "
        f"heads: {fault_err:.3g}); greedy "
        f"token equal in {agree}/{LM_STEPS} steps; a step's wall "
        f"{dec_ms:.2f} ms, device {dec_dev:.2f} ms, flash_attention "
        f"{dec_flash:.3f} ms ({100 * dec_flash / dec_dev:.2f} % of device); "
        f"{card}")
    del cache, plain

    # one step at decode_32k's cache length, B 16
    B = LM_32K_BATCH
    cache = lm.init_cache(CONFIG, B, LM_32K)
    g = torch.Generator(device="cuda").manual_seed(12)
    for name in ("k", "v"):
        for li in range(CONFIG.n_layers):
            cache[name][li].normal_(generator=g)
    tok = torch.randint(0, V, (B,), generator=gen).cuda()
    pos = LM_32K - 1
    plain, _ = lm.decode_one(params, cache, tok, pos, CONFIG,
                             attention="plain")
    (logits, _), n, paths = lm_counts(torch, lambda: lm.decode_one(
        params, cache, tok, pos, CONFIG))
    if paths != {"decode": CONFIG.n_layers}:
        raise AssertionError(f"lm: the 32k step took {paths}")
    launches += n
    err = rel_err(logits, plain)
    if not err <= LM_TOL["bfloat16"]:
        raise AssertionError(f"lm: 32k decode logits {err} from plain")
    k_ms, k_dev, k_flash = kernel_share(torch, lambda: lm.decode_one(
        params, cache, tok, pos, CONFIG))
    log(f"lm: decode step at {LM_32K} keys, B={B} (decode_32k's batch 128 "
        f"cut to {B}: its KV cache would take "
        f"{2 * CONFIG.n_layers * 128 * LM_32K * 5 * 64 * 2 / 1e9:.0f} GB, "
        f"this one {2 * cache['k'].numel() * 2 / 1e9:.1f} GB): "
        f"flash_attention {n} launches {paths}; logits vs plain rel err "
        f"{err:.3g}; wall {k_ms:.2f} ms, device {k_dev:.2f} ms, "
        f"flash_attention {k_flash:.3f} ms ({100 * k_flash / k_dev:.2f} % of "
        f"device); {card}")
    del cache, plain, logits
    torch.cuda.empty_cache()

    # the prefill in fp32: the "simt" path
    cfg32 = replace(CONFIG, dtype=torch.float32)
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    del params
    (logits, _), n, paths = lm_counts(torch, lambda: lm.prefill(
        p32, tokens, cfg32))
    if paths != {"simt": CONFIG.n_layers}:
        raise AssertionError(f"lm: the fp32 prefill took {paths}")
    launches += n
    plain, _ = lm.prefill(p32, tokens, cfg32, attention="plain")
    err = rel_err(logits, plain)
    if not err <= LM_TOL["float32"]:
        raise AssertionError(f"lm: fp32 prefill logits {err} from plain")
    log(f"lm: fp32 prefill B=1 S={LM_PREFILL}: flash_attention {n} launches "
        f"{paths}; logits vs plain rel err {err:.3g} (tol "
        f"{LM_TOL['float32']:.3g}), max abs "
        f"{float((logits - plain).abs().max()):.3g}")
    del p32, logits, plain
    torch.cuda.empty_cache()

    # the tests' tiny MoE config, card against CPU, both dispatches
    moe_launches = 0
    for groups in (0, 2):
        tiny = lm.LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                           n_kv_heads=2, d_ff=128, vocab_size=512,
                           vocab_pad_multiple=128, dtype=torch.float32,
                           n_experts=8, top_k=2, dispatch_groups=groups)
        cpu, _ = lm.load_params(tiny, seed=5, device="cpu")
        dev = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in cpu.items()}
        toks = torch.randint(0, 512, (2, 24), generator=gen)
        want, want_aux = lm.forward(cpu, toks, tiny)
        (got, got_aux), n, _ = lm_counts(torch, lambda: lm.forward(
            dev, toks.cuda(), tiny))
        moe_launches += n
        lg_c, cache_c = lm.prefill(cpu, toks[:, :16], tiny, max_len=24)
        lg_c, _ = lm.decode_one(cpu, cache_c, toks[:, 16], 16, tiny)
        (lg_g, cache_g), n1, _ = lm_counts(torch, lambda: lm.prefill(
            dev, toks[:, :16].cuda(), tiny, max_len=24))
        (lg_g, _), n2, _ = lm_counts(torch, lambda: lm.decode_one(
            dev, cache_g, toks[:, 16].cuda(), 16, tiny))
        moe_launches += n1 + n2
        e = max(float((got.cpu() - want).abs().max()),
                float((lg_g.cpu() - lg_c).abs().max()),
                float((cache_g["k"].cpu() - cache_c["k"]).abs().max()))
        if not e <= LM_MOE_ATOL or abs(float(got_aux) - float(want_aux)) \
                > 1e-5:
            raise AssertionError(f"lm: tiny MoE (groups {groups}) on the "
                                 f"card differs from the CPU by {e}")
        log(f"lm: tiny MoE (8 experts, top 2, dispatch_groups {groups}) "
            f"forward, prefill and a decode step on the card against the "
            f"CPU: max abs {e:.3g} (atol {LM_MOE_ATOL}), aux "
            f"{float(got_aux):.6f} / {float(want_aux):.6f}")
    log(f"lm: tiny MoE flash_attention launches {moe_launches} (not in the "
        f"kernels line's count, which is smollm-360m's)")
    return {"launches": launches, "moe_launches": moe_launches}


# -- the recsys, gcn and train phases -----------------------------------------

#: recsys serving batch (``serve_p99``), the candidates of
#: ``retrieval_cand``, ten AdamW steps a model at these batches (the
#: ``train_batch`` of 65,536 for DLRM and DCN; MIND's [B, K, B] logits
#: would take 68.7 GB at 65,536, two-tower's [B, B] logits and their
#: gradient 34 GB on top of 12.3 GB of weights and moments)
RECSYS_SERVE_B = 512
RECSYS_CANDIDATES = 1_000_000
RECSYS_TRAIN_B = {"dlrm": 65_536, "dcn": 65_536, "mind": 8_192,
                  "two_tower": 16_384}
RECSYS_STEPS = 10
# each serve output against the same function in float64 on the card
# (relative L2); the tests' small configs, card against CPU
RECSYS_RTOL = 1e-5
# the reference's GNN shapes (``src/repro/configs/base.py:126-136``)
GCN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                         n_classes=47),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=64,
                     n_classes=10),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114615892,
                         batch_nodes=1024, fanouts=(15, 10), d_feat=602,
                         n_classes=41),
}
GCN_STEPS = 3
CSR_LIMIT_S = 30.0
# the trained reranker: steps of the example, card against CPU
TRAIN_STEPS = 100
TRAIN_CHECK_STEPS = 3
STEP_RTOL = 1e-5
SMALL_SEED, GRAPH_SEED, DATA_SEED = 21, 22, 23


def to_device(batch: dict, device) -> dict:
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict of tensors."""
    from repro_torch.models.common import _leaves, _unflatten
    return _unflatten((path, fn(t)) for path, t in _leaves(tree))


def tree_bytes(tree) -> int:
    from repro_torch.models.common import _leaves
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))


def small_recsys(cfg):
    """The reference smoke's shrink (``src/repro/configs/base.py:522-537``),
    as the tests take it."""
    from dataclasses import replace
    e = min(cfg.embed_dim, 8)
    return replace(
        cfg, vocab_sizes=tuple(min(v, 64) for v in cfg.vocab_sizes),
        embed_dim=e,
        bot_mlp=(tuple(min(x, 16) for x in cfg.bot_mlp[:-1]) + (e,))
        if cfg.bot_mlp else (),
        top_mlp=tuple(min(x, 16) for x in cfg.top_mlp),
        deep_mlp=tuple(min(x, 16) for x in cfg.deep_mlp),
        tower_mlp=tuple(min(x, 16) for x in cfg.tower_mlp),
        item_vocab=min(cfg.item_vocab, 128),
        user_vocab=min(cfg.user_vocab, 128), hist_len=min(cfg.hist_len, 8))


def serve_batch(cfg, B: int, step: int) -> dict:
    """A serving batch from the step-keyed generator; two-tower scores
    each user against the paired item (the reference's ``serve`` cell)."""
    from repro_torch.data import StepKeyedDataset, recsys_synthetic
    b = StepKeyedDataset(recsys_synthetic(cfg), B, DATA_SEED).batch(step)
    if cfg.kind == "two_tower":
        return {"user_ids": b["user_ids"], "cand_ids": b["item_ids"]}
    return {k: v for k, v in b.items() if k != "labels"}


def timed_steps(torch, step_fn, params, opt, batches) -> tuple:
    """Run the steps; (params, opt, losses, median ms a step, peak GB):
    each step's wall on the host clock, ended by a synchronise."""
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        losses.append(float(m["loss"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return (params, opt, losses, statistics.median(walls),
            torch.cuda.max_memory_allocated() / 1e9)


def run_recsys(torch, card: str) -> dict:
    """The four recsys configurations at their published widths, native
    weights drawn on the card from a CUDA ``torch.Generator``: serving at
    ``serve_p99`` (B 512) against the same function in float64 on the
    card, two-tower's retrieval of 1,000,000 candidates, the tests' small
    configs on the card against the CPU, MIND's history through
    ``recsys.embedding_bag`` (one ``embedding_bag`` launch a call,
    against its plain version, timed beside its bound), then ten AdamW
    steps each from ``StepKeyedDataset(recsys_synthetic(cfg))`` (AdamW
    updates in place); the forwards and steps launch no kernel.
    Returns the bag's ``embedding_bag`` launches and its row."""
    import numpy as np

    from repro_torch.configs import dcn_v2, dlrm_rm2, mind, \
        two_tower_retrieval
    from repro_torch.data import StepKeyedDataset, recsys_synthetic
    from repro_torch.kernels.embedding_bag import embedding_bag_ref
    from repro_torch.models import recsys as R
    from repro_torch.models.common import init_params
    from repro_torch.train import AdamWConfig, adamw_update, make_train_step
    from repro_torch.train.loop import _value_and_grad

    bag_row = None
    bag_calls = 0
    for cfg in (dlrm_rm2.CONFIG, dcn_v2.CONFIG, mind.CONFIG,
                two_tower_retrieval.CONFIG):
        t = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SMALL_SEED)
        params = init_params(R.recsys_param_specs(cfg), gen, "cuda")
        torch.cuda.synchronize()
        log(f"recsys: {cfg.name} weights {tree_bytes(params) / 1e9:.2f} GB "
            f"drawn on the card in {time.perf_counter() - t:.1f} s")

        # serving at B 512 against float64 on the card
        calls = [("recsys_serve", serve_batch(cfg, RECSYS_SERVE_B, 10**6),
                  R.recsys_serve)]
        if cfg.kind == "two_tower":
            rng = np.random.default_rng(DATA_SEED)
            calls.append(("two_tower_retrieval_scores 1 x 1,000,000", {
                "user_ids": rng.integers(0, cfg.user_vocab, 1)
                .astype("int32"),
                "cand_ids": rng.integers(0, cfg.item_vocab,
                                         RECSYS_CANDIDATES).astype("int32")},
                R.two_tower_retrieval_scores))
        with torch.no_grad():
            p64 = tree_map(lambda t: t.double(), params)
            for label, nb, fn in calls:
                b = to_device(nb, "cuda")
                out, _ = driven(torch, lambda: fn(params, b, cfg),
                                "embedding_bag", 0)
                ms = time_ms(torch, lambda: fn(params, b, cfg), reps=5,
                             warmup=1)
                b64 = {k: v.double() if v.is_floating_point() else v
                       for k, v in b.items()}
                want = fn(p64, b64, cfg)
                err = rel_err(out.double(), want)
                if not (torch.isfinite(out).all() and err <= RECSYS_RTOL):
                    raise AssertionError(f"recsys: {cfg.name} {label}: rel "
                                         f"L2 {err} from float64")
                log(f"recsys: {cfg.name} {label} {tuple(out.shape)}: rel L2 "
                    f"{err:.3g} from float64 (tol {RECSYS_RTOL}); "
                    f"{ms:.4f} ms (CUDA events, L2 flushed, median of 5); "
                    f"{card}")
            del p64, want

        if cfg.kind == "mind":
            nb = serve_batch(cfg, RECSYS_SERVE_B, 10**6)
            tab = params["item_embed"]
            ids = torch.from_numpy(nb["hist_ids"]).cuda()
            mask = torch.from_numpy(nb["hist_mask"]).cuda()
            with torch.no_grad():
                got, n = driven(torch, lambda: R.embedding_bag(
                    tab, ids, mask, "mean"), "embedding_bag", 1)
                bag_calls += n
                den = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
                want = embedding_bag_ref(tab, ids, mask, "sum") / den
                err = float((got - want).abs().max())
                if not err <= TOL_BAG["float32"]:
                    raise AssertionError(f"recsys: MIND bag max_abs_err {err}")
                ms = time_ms(torch, lambda: R.embedding_bag(tab, ids, mask,
                                                            "mean"))
                dev = device_ms(torch, lambda: R.embedding_bag(
                    tab, ids, mask, "mean"), "embedding_bag_kernel",
                    flush_l2=True)
                plain = time_ms(torch, lambda: embedding_bag_ref(
                    tab, ids, mask, "sum") / torch.clamp(
                        mask.sum(1, keepdim=True), min=1.0))
            b_ms, b_by, rows = bag_bound(torch, tab, ids, mask)
            bag_row = {"ms": ms, "device_ms": dev, "plain_ms": plain,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "max_abs_err": err}
            log(f"recsys: mind recsys.embedding_bag(item_embed, hist_ids, "
                f"hist_mask, 'mean') B={RECSYS_SERVE_B} L={cfg.hist_len}: "
                f"{n} embedding_bag launch, max_abs_err {err:.3g} against "
                f"the plain version; {ms:.4f} ms (events), device-only "
                f"{fmt_ms(dev)} (profiler, L2 flushed), plain {plain:.4f} "
                f"ms, bound {b_ms * 1e3:.4f} us ({b_by}, {rows} distinct "
                f"rows); {card}")

        # ten AdamW steps at the training batch, updated in place; then a
        # step's two parts alone: forward and backward, and the update
        B = RECSYS_TRAIN_B[cfg.kind]
        ds = StepKeyedDataset(recsys_synthetic(cfg), B, DATA_SEED)
        batches = [to_device(ds.batch(s), "cuda") for s in range(RECSYS_STEPS)]

        def loss_fn(p, b, c=cfg):
            return R.recsys_train_loss(p, b, c)
        step_fn, init_opt = make_train_step(loss_fn, AdamWConfig())
        (params, opt, losses, step_ms, peak), _ = driven(
            torch, lambda: timed_steps(torch, step_fn, params,
                                       init_opt(params), batches),
            "embedding_bag", 0)
        fb_ms = time_ms(torch, lambda: _value_and_grad(
            loss_fn, params, batches[0]), reps=3, warmup=1, flush_l2=False)
        _, grads = _value_and_grad(loss_fn, params, batches[0])
        adam_ms = time_ms(torch, lambda: adamw_update(
            params, grads, opt["adam"], AdamWConfig()), reps=3, warmup=1,
            flush_l2=False)
        log(f"recsys: {cfg.name} train B={B}: {RECSYS_STEPS} AdamW steps, "
            f"losses {[round(x, 5) for x in losses]}; median {step_ms:.1f} "
            f"ms a step (host clock); alone, forward and backward "
            f"{fb_ms:.1f} ms, the AdamW update {adam_ms:.1f} ms (CUDA "
            f"events, median of 3); max_memory_allocated {peak:.2f} GB, of "
            f"which weights, gradients and two moments "
            f"{4 * tree_bytes(params) / 1e9:.2f} GB; {card}")
        del params, opt, grads, batches, step_fn, init_opt
        torch.cuda.empty_cache()

    # the tests' small configs: the card against the CPU
    worst = 0.0
    for cfg in (dlrm_rm2.CONFIG, dcn_v2.CONFIG, mind.CONFIG,
                two_tower_retrieval.CONFIG):
        small = small_recsys(cfg)
        cpu, _ = R.load_params(small, seed=SMALL_SEED, device="cpu")
        gpu = tree_map(lambda t: t.cuda(), cpu)
        sb = serve_batch(small, 16, 1)
        tb = StepKeyedDataset(recsys_synthetic(small), 16, DATA_SEED).batch(1)
        with torch.no_grad():
            for fn, nb in ((R.recsys_serve, sb), (R.recsys_train_loss, tb)):
                a = fn(cpu, to_device(nb, "cpu"), small)
                g = fn(gpu, to_device(nb, "cuda"), small).cpu()
                e = float((g - a).abs().max()) / max(
                    1.0, float(a.abs().max()))
                worst = max(worst, e)
                if not e <= RECSYS_RTOL:
                    raise AssertionError(f"recsys: small {cfg.name} card vs "
                                         f"CPU {e}")
    log(f"recsys: the tests' small configs (serve and loss), card against "
        f"CPU: largest difference {worst:.3g} of the largest magnitude "
        f"(tol {RECSYS_RTOL})")
    return {"launches": bag_calls, "bag": bag_row}


def synthetic_edges(torch, gen, n: int, e: int) -> tuple:
    """(src, dst): ``e`` edges with uniform ends among ``n`` nodes, drawn
    on the generator's device."""
    return tuple(torch.randint(0, n, (e,), generator=gen, device=gen.device)
                 for _ in range(2))


def csr_sampler(torch, n: int, src, dst):
    """``NeighborSampler`` over the edges' CSR, built on the card: a
    stable sort by dst is ``NeighborSampler.from_edges``'s argsort, so
    the arrays are the same (held on full_graph_sm's graph), in seconds
    where numpy's stable argsort of 114.6M ids takes about half a
    minute."""
    from repro_torch.models.gcn import NeighborSampler
    order = torch.sort(dst, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dst.device)
    indptr[1:] = torch.cumsum(torch.bincount(dst, minlength=n), 0)
    return NeighborSampler(indptr.cpu().numpy(),
                           src[order].int().cpu().numpy())


def synthetic_graph(torch, n: int, e: int, d_feat: int, n_classes: int,
                    device, seed: int) -> dict:
    """Uniform src and dst, normal features, uniform labels; degree with
    the self loop."""
    gen = torch.Generator(device=device).manual_seed(seed)
    src, dst = synthetic_edges(torch, gen, n, e)
    return {"feats": torch.randn(n, d_feat, generator=gen, device=device),
            "src": src, "dst": dst,
            "deg": torch.bincount(dst, minlength=n).float() + 1.0,
            "labels": torch.randint(0, n_classes, (n,), generator=gen,
                                    device=device),
            "label_mask": torch.ones(n, device=device)}


def fed_step(torch, make_step, grads, params, opt, batch, **kw) -> tuple:
    """(params, opt) after one ``make_step(loss, **kw)`` step, from
    copies of ``params`` and ``opt``, of the loss sum(p * g) over the
    leaves, whose gradient is ``grads`` exactly: the step's
    compression, schedule and AdamW applied to a given gradient."""
    from repro_torch.models.common import _leaves

    def linear(q, b):
        return sum((x * g).sum() for (_, x), (_, g) in zip(_leaves(q),
                                                           _leaves(grads)))
    step_fn, _ = make_step(linear, **kw)
    dev = next(iter(_leaves(grads)))[1].device
    new_p, new_o, _ = step_fn(tree_map(lambda t: t.to(dev).clone(), params),
                              tree_map(lambda t: t.to(dev).clone(), opt),
                              batch)
    return new_p, new_o


def leaf_err(got, want, floor: float) -> tuple:
    """(largest difference over the leaves relative to max(floor, the
    leaf's largest magnitude), the leaf where it lies)."""
    from repro_torch.models.common import _leaves
    worst, where = 0.0, None
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        w, g = w.detach().cpu().double(), g.detach().cpu().double()
        top = float(w.abs().max())
        diff = float((g - w).abs().max())
        e = diff / max(floor, top) if max(floor, top) else \
            (0.0 if diff == 0 else math.inf)
        if e > worst:
            worst, where = e, path
    return worst, where


def grad_err(got, want, exact) -> tuple:
    """Two fp32 gradients ``got`` and ``want`` against the tolerance
    STEP_RTOL * max|want| + 2 * max|want - exact| of each leaf, with
    ``exact`` the same gradient in float64: two evaluations each as far
    from the exact gradient as ``want`` lie within twice that of each
    other.  The Mono encoder needs the second term: its random init
    draws q, k and v with a fan-in of n_heads (the reference's rule for
    a [L, D, H, hd] spec), its attention softmax saturates, and its fp32
    gradients through q and k are differences of nearly equal terms
    (PERF.md §6).  Returns (the largest difference over its tolerance,
    its leaf, the largest max|got - want| / max|want|, the largest
    max|want - exact| / max|want|)."""
    from repro_torch.models.common import _leaves
    worst, where, raw, off = 0.0, None, 0.0, 0.0
    for (path, w), (_, g), (_, x) in zip(_leaves(want), _leaves(got),
                                         _leaves(exact)):
        w, g, x = (t.detach().cpu().double() for t in (w, g, x))
        top = float(w.abs().max())
        diff, dist = float((g - w).abs().max()), float((w - x).abs().max())
        tol = STEP_RTOL * top + 2 * dist
        e = diff / tol if tol else (0.0 if diff == 0 else math.inf)
        if e > worst:
            worst, where = e, path
        if top:
            raw, off = max(raw, diff / top), max(off, dist / top)
    return worst, where, raw, off


def held_steps(torch, label: str, make_step, loss_fn, params, batches,
               microbatches: int = 1, **kw) -> tuple:
    """The card's steps of ``make_step(loss_fn, microbatches=...,
    **kw)`` against the CPU's, each from the CPU's weights and optimiser
    state before it, so that no difference carries into the next step:
    the loss within ``STEP_RTOL`` relative; the step's gradient
    (``_step_grads``) against the CPU's by ``grad_err``, with the float64
    gradient evaluated on the CPU; and the step applied to the card's
    gradient on the card and on the CPU (``fed_step``): weights within
    ``STEP_RTOL`` of max(1, the leaf's largest magnitude), the optimiser
    state (m, v, error feedback) within ``STEP_RTOL`` of its largest
    magnitude, with no element exempted.  Each device's step applied to its own gradient
    would not do: AdamW divides m by sqrt(v) element by element, so a
    gradient that cancelled to rounding noise moves its weight a full
    lr step in whichever direction the noise points.  Returns (card
    losses, the largest gradient difference over its tolerance, the
    largest gradient difference and the CPU's distance from float64,
    each relative to the leaf's largest magnitude, and the largest step
    difference)."""
    from repro_torch.train.loop import _step_grads
    _, init_opt = make_step(loss_fn, microbatches=microbatches, **kw)
    p = tree_map(lambda t: t.cpu().clone(), params)
    opt = init_opt(p)
    losses, worst = [], [0.0, 0.0, 0.0, 0.0]
    for b in batches:
        hb = {k: v.cpu() for k, v in b.items()}
        cb = {k: v.cuda() for k, v in b.items()}
        loss_h, g_h = _step_grads(loss_fn, p, hb, microbatches)
        loss_c, g_c = _step_grads(loss_fn, tree_map(lambda t: t.cuda(), p),
                                  cb, microbatches)
        _, g_x = _step_grads(
            loss_fn, tree_map(lambda t: t.double(), p),
            {k: v.double() if v.is_floating_point() else v
             for k, v in hb.items()}, microbatches)
        e_loss = abs(float(loss_c) - float(loss_h)) / max(1.0,
                                                         abs(float(loss_h)))
        e_grad, g_at, g_raw, g_off = grad_err(g_c, g_h, g_x)
        got = fed_step(torch, make_step, g_c, p, opt, cb, **kw)
        want = fed_step(torch, make_step, tree_map(lambda t: t.cpu(), g_c),
                        p, opt, hb, **kw)
        e_p, p_at = leaf_err(got[0], want[0], 1.0)
        e_o, o_at = leaf_err(got[1], want[1], 0.0)
        if not (e_loss <= STEP_RTOL and e_grad <= 1.0
                and max(e_p, e_o) <= STEP_RTOL):
            raise AssertionError(
                f"{label}: step {len(losses)}, card against CPU: loss "
                f"{e_loss} (tol {STEP_RTOL}), gradient {e_grad} of its "
                f"tolerance at {g_at} ({g_raw} of the leaf's largest; the "
                f"CPU {g_off} from float64), the step on the same gradient: "
                f"weights {e_p} at {p_at}, state {e_o} at {o_at} (tol "
                f"{STEP_RTOL})")
        losses.append(float(loss_c))
        worst = [max(a, b) for a, b in zip(worst, (e_grad, g_raw, g_off,
                                                   max(e_p, e_o)))]
        p, opt = fed_step(torch, make_step, g_h, p, opt, hb, **kw)
    return (losses, *worst)


def held_line(e_grad, g_raw, g_off, e_step) -> str:
    return (f"card against CPU, each step from the CPU's state: gradients "
            f"{g_raw:.3g} of the leaf's largest (the CPU {g_off:.3g} from "
            f"float64; {e_grad:.3g} of the tolerance), the step on the same "
            f"gradient {e_step:.3g} (tol {STEP_RTOL})")


def run_gcn(torch, card: str) -> None:
    """GCN at the reference's GNN shapes, synthetic graphs (uniform src
    and dst) drawn from fixed seeds, three AdamW steps each with finite
    losses: the full graph at ``full_graph_sm`` (the card against the CPU),
    at ``ogb_products``, ``molecule``, and the sampled step at
    ``minibatch_lg``'s batch through ``NeighborSampler`` over its full
    graph (or, if the CSR takes longer than ``CSR_LIMIT_S``, over
    ``ogb_products``' graph, printed as a cut).  Message passing is
    ``index_add``: the phase launches no kernel."""
    import numpy as np

    from repro_torch.data import StepKeyedDataset, gcn_sampled
    from repro_torch.models import gcn as G
    from repro_torch.train import AdamWConfig, make_train_step

    opt_cfg = AdamWConfig()

    def cfg_of(sh, **kw):
        return G.GCNConfig(d_feat=sh["d_feat"], n_classes=sh["n_classes"],
                           **kw)

    # full_graph_sm: card against CPU
    sh = GCN_SHAPES["full_graph_sm"]
    cfg = cfg_of(sh)
    graph = synthetic_graph(torch, sh["n_nodes"], sh["n_edges"],
                            sh["d_feat"], sh["n_classes"], "cpu", GRAPH_SEED)
    params, _ = G.load_params(cfg, seed=GRAPH_SEED, device="cpu")
    want = G.NeighborSampler.from_edges(sh["n_nodes"], graph["src"].numpy(),
                                        graph["dst"].numpy())
    got = csr_sampler(torch, sh["n_nodes"], graph["src"].cuda(),
                      graph["dst"].cuda())
    if not (np.array_equal(got.indptr, want.indptr)
            and np.array_equal(got.indices, want.indices)):
        raise AssertionError("gcn: the card's CSR differs from from_edges'")

    t = time.perf_counter()
    losses, *errs = held_steps(
        torch, "gcn full_graph_sm",
        lambda loss, **kw: make_train_step(loss, opt_cfg, **kw),
        lambda p, b, c=cfg: G.gcn_full_graph_loss(p, b, c), params,
        [graph] * GCN_STEPS)
    log(f"gcn: full_graph_sm {sh['n_nodes']} nodes {sh['n_edges']} edges: "
        f"{GCN_STEPS} AdamW steps, losses {[round(x, 5) for x in losses]}; "
        f"{held_line(*errs)}; {time.perf_counter() - t:.1f} s; {card}")

    # ogb_products: the full graph on the card
    sh = GCN_SHAPES["ogb_products"]
    cfg = cfg_of(sh)
    t = time.perf_counter()
    graph = synthetic_graph(torch, sh["n_nodes"], sh["n_edges"],
                            sh["d_feat"], sh["n_classes"], "cuda",
                            GRAPH_SEED)
    params, _ = G.load_params(cfg, seed=GRAPH_SEED, device="cuda")
    step_fn, init_opt = make_train_step(
        lambda p, b, c=cfg: G.gcn_full_graph_loss(p, b, c), opt_cfg)
    _, _, losses, step_ms, peak = timed_steps(
        torch, step_fn, params, init_opt(params), [graph] * GCN_STEPS)
    log(f"gcn: ogb_products {sh['n_nodes']:,} nodes {sh['n_edges']:,} edges "
        f"d_feat {sh['d_feat']} {sh['n_classes']} classes (layer-1 messages "
        f"{sh['n_edges'] * sh['n_classes'] * 4 / 1e9:.1f} GB): {GCN_STEPS} "
        f"AdamW steps, losses {[round(x, 5) for x in losses]}; median "
        f"{step_ms:.1f} ms a step; max_memory_allocated {peak:.2f} GB; "
        f"{time.perf_counter() - t:.1f} s with the graph; {card}")
    ogb_edges = (graph["src"], graph["dst"])
    del graph, step_fn, init_opt, params
    torch.cuda.empty_cache()

    # molecule: 128 graphs of 30 nodes and 64 edges
    sh = GCN_SHAPES["molecule"]
    cfg = cfg_of(sh)
    gen = torch.Generator(device="cuda").manual_seed(GRAPH_SEED)
    Gn, N, E = sh["batch"], sh["n_nodes"], sh["n_edges"]
    dst = torch.randint(0, N, (Gn, E), generator=gen, device="cuda")
    mol = {"feats": torch.randn(Gn, N, sh["d_feat"], generator=gen,
                                device="cuda"),
           "src": torch.randint(0, N, (Gn, E), generator=gen, device="cuda"),
           "dst": dst,
           "deg": torch.stack([torch.bincount(d, minlength=N) for d in dst])
           .float() + 1.0,
           "labels": torch.randint(0, sh["n_classes"], (Gn,), generator=gen,
                                   device="cuda")}
    params, _ = G.load_params(cfg, seed=GRAPH_SEED, device="cuda")
    step_fn, init_opt = make_train_step(
        lambda p, b, c=cfg: G.gcn_molecule_loss(p, b, c), opt_cfg)
    _, _, losses, step_ms, _ = timed_steps(
        torch, step_fn, params, init_opt(params), [mol] * GCN_STEPS)
    log(f"gcn: molecule {Gn} graphs x {N} nodes, {E} edges: {GCN_STEPS} "
        f"AdamW steps, losses {[round(x, 5) for x in losses]}; median "
        f"{step_ms:.2f} ms a step; {card}")

    # minibatch_lg: sampled steps through NeighborSampler
    sh = GCN_SHAPES["minibatch_lg"]
    t = time.perf_counter()
    n = sh["n_nodes"]
    edges = synthetic_edges(
        torch, torch.Generator(device="cuda").manual_seed(GRAPH_SEED), n,
        sh["n_edges"])
    t_csr = time.perf_counter()
    sampler = csr_sampler(torch, n, *edges)
    csr_s = time.perf_counter() - t_csr
    graph_name = f"minibatch_lg's graph ({n:,} nodes, {sh['n_edges']:,} edges)"
    del edges
    if csr_s > CSR_LIMIT_S:
        n = GCN_SHAPES["ogb_products"]["n_nodes"]
        t_csr = time.perf_counter()
        sampler = csr_sampler(torch, n, *ogb_edges)
        log(f"gcn: cut: minibatch_lg's CSR took {csr_s:.1f} s (> "
            f"{CSR_LIMIT_S:.0f} s); the sampled step runs over "
            f"ogb_products' graph, its CSR in "
            f"{time.perf_counter() - t_csr:.1f} s")
        graph_name = f"ogb_products' graph ({n:,} nodes)"
    del ogb_edges
    rng = np.random.default_rng(GRAPH_SEED)
    feats = rng.standard_normal((n, sh["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, sh["n_classes"], n).astype(np.int32)
    cfg = cfg_of(sh, fanouts=sh["fanouts"])
    ds = StepKeyedDataset(gcn_sampled(sampler, feats, labels, sh["fanouts"]),
                          sh["batch_nodes"], DATA_SEED)
    t_b = time.perf_counter()
    batches = [to_device(ds.batch(s), "cuda") for s in range(GCN_STEPS)]
    batch_s = (time.perf_counter() - t_b) / GCN_STEPS
    params, _ = G.load_params(cfg, seed=GRAPH_SEED, device="cuda")
    step_fn, init_opt = make_train_step(
        lambda p, b, c=cfg: G.gcn_sampled_loss(p, b, c), opt_cfg)
    _, _, losses, step_ms, _ = timed_steps(
        torch, step_fn, params, init_opt(params), batches)
    log(f"gcn: minibatch_lg sampled step, batch {sh['batch_nodes']} fanouts "
        f"{sh['fanouts']} over {graph_name}: CSR built in {csr_s:.1f} s; "
        f"{batch_s:.2f} s a batch on the host (sample, gather, copy); "
        f"{GCN_STEPS} AdamW steps, losses {[round(x, 5) for x in losses]}; "
        f"median {step_ms:.2f} ms a step; {time.perf_counter() - t:.1f} s "
        f"in all; {card}")
    del feats, sampler, batches


def run_train(torch, card: str) -> None:
    """The path of ``examples/train_reranker_torch.py`` with the encoder at
    ``EncoderConfig()``'s full width: its first three steps, one step
    with ``microbatches=4`` and one with int8 compression, each on the
    card against the CPU (``held_steps``); then 100 steps; the trained
    scorer (``MonoScorer(cfg, params=<numpy tree>)``) in the example's
    Experiment, its scores equal to ``encoder_score`` of the trained
    weights exactly (a fresh CUDA graph, not the untrained weights'),
    and its ``fingerprint_extras`` its own.  Its only kernel is
    ``cachekey_hash``, the plan's digests."""
    import importlib.util

    import numpy as np

    from repro_torch.caching import compile_cache
    from repro_torch.distrib.compression import CompressionConfig
    from repro_torch.models.common import init_params
    from repro_torch.models.cross_encoder import (EncoderConfig, MonoScorer,
                                                  encoder_param_specs,
                                                  encoder_score)

    spec = importlib.util.spec_from_file_location(
        "train_reranker_torch", ROOT / "examples" / "train_reranker_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    t0 = time.perf_counter()
    cfg = EncoderConfig()
    setup = ex.Setup(cfg, torch.device("cuda"))
    params = init_params(encoder_param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    batches = [setup.batch() for _ in range(TRAIN_CHECK_STEPS)]
    loss = ex.loss_fn(cfg)
    for label, kw, n in (
            ("first three steps", {}, TRAIN_CHECK_STEPS),
            ("one step, microbatches=4", dict(microbatches=4), 1),
            ("one step, int8 compression",
             dict(compression=CompressionConfig("int8")), 1)):
        losses, *errs = held_steps(
            torch, f"train: {label}",
            lambda lo, **k: ex.train_step(lo, TRAIN_STEPS, **k), loss,
            params, batches[:n], **kw)
        log(f"train: reranker {label}: losses {[round(x, 6) for x in losses]}"
            f"; {held_line(*errs)}")

    t = time.perf_counter()
    trained, losses = ex.train(setup, tree_map(lambda x: x.cuda(), params),
                               TRAIN_STEPS, log=lambda s: None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    log(f"train: reranker {TRAIN_STEPS} steps at B {ex.BATCH}, losses "
        f"{[round(x, 4) for x in losses]}; {train_s:.1f} s "
        f"({1e3 * train_s / TRAIN_STEPS:.1f} ms a step); {card}")

    untrained = MonoScorer(cfg, device="cuda")
    toks = setup.toks[:64]                       # one bucket, no padding
    before = untrained._runner(toks)             # the untrained graph
    entries = len(compile_cache.default_compile_cache.entries())
    res, scorer = ex.evaluate(setup, trained)
    got = np.asarray(scorer._runner(toks), np.float32)
    with torch.no_grad():
        want = encoder_score(trained, torch.from_numpy(toks).cuda(),
                             cfg).cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"train: the trained scorer's scores differ "
                             f"from encoder_score by "
                             f"{float(np.abs(got - want).max())}")
    if np.array_equal(got, np.asarray(before, np.float32)):
        raise AssertionError("train: trained and untrained scores equal")
    fx, ux = scorer.fingerprint_extras(), untrained.fingerprint_extras()
    if fx == ux:
        raise AssertionError(f"train: fingerprint_extras equal: {fx}")
    added = len(compile_cache.default_compile_cache.entries()) - entries
    log(f"train: Experiment {json.dumps(res.means)}; the trained scorer's "
        f"64 scores equal encoder_score(trained) exactly (graph replay, "
        f"{added} new memo entries), and differ from the untrained's; "
        f"fingerprint_extras {fx[:2]} vs {ux}")
    log(f"train: phase wall {time.perf_counter() - t0:.1f} s; {card}")


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

    # -- 7. serving: the hybrid scenario cold, warm and warmed -------------
    t = time.perf_counter()
    served = run_serve(torch, card)
    log(f"serve: in {time.perf_counter() - t:.1f} s, launches "
        f"{json.dumps(served)}")

    # -- 8. the fleet: the hybrid scenario in worker processes ----------
    t = time.perf_counter()
    fleet = run_fleet(torch, card)
    log(f"fleet: in {time.perf_counter() - t:.1f} s, launches in the "
        f"workers {json.dumps(fleet)}")

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

    # -- 9. the encoders with and without the CUDA-graph memo --------------
    t = time.perf_counter()
    memo = run_compile_cache(torch, card, mp, res, t2["rows"][0]["res"])
    log(f"compile_cache: in {time.perf_counter() - t:.1f} s, captures "
        f"{memo['captures']}, replays {memo['replays']}")

    # -- 10. smollm-360m prefill and decode through flash_attention --------
    del mp
    torch.cuda.empty_cache()
    t = time.perf_counter()
    lm_run = run_lm(torch, card)
    log(f"lm: in {time.perf_counter() - t:.1f} s, flash_attention launches "
        f"{lm_run['launches']} (smollm-360m), {lm_run['moe_launches']} "
        f"(tiny MoE)")

    # -- 11-13. recsys, GCN and the training stack --------------------------
    torch.cuda.empty_cache()
    t = time.perf_counter()
    recsys = run_recsys(torch, card)
    log(f"recsys: in {time.perf_counter() - t:.1f} s, embedding_bag "
        f"launches {recsys['launches']} (MIND's bag; the forwards and "
        f"steps launched no kernel)")
    t = time.perf_counter()
    driven(torch, lambda: run_gcn(torch, card), "embedding_bag", 0)
    log(f"gcn: in {time.perf_counter() - t:.1f} s, no kernel launched")
    t = time.perf_counter()
    _, train_hash = driven(torch, lambda: run_train(torch, card),
                           "cachekey_hash", None)
    log(f"train: in {time.perf_counter() - t:.1f} s, cachekey_hash "
        f"launches {train_hash} (the Experiment's plan), no other kernel")

    # -- 14. result lines ---------------------------------------------------
    log(json.dumps({"kernels": [{
        "name": "dense_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/dense_topk/csrc/dense_topk.cu",
        "replaces": "src/repro/kernels/dense_topk/kernel.py:96",
        "launches": launches + planner["dense_topk"] + served["dense_topk"]
        + fleet["dense_topk"],
        **topk_entry}, {
        "name": "cachekey_hash", "route": "cuda",
        "source": "src/repro_torch/kernels/cachekey_hash/csrc/"
                  "cachekey_hash.cu",
        "replaces": "src/repro/kernels/cachekey_hash/kernel.py:54",
        "launches": t2["launches"] + planner["cachekey_hash"]
        + served["cachekey_hash"] + fleet["cachekey_hash"]
        + train_hash,
        "max_abs_err": 0, "ms": h_ms,
        "plain_ms": h_plain, "bound_ms": h_bound, "bound_by": h_by,
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
        **flash_entry, "launches": lm_run["launches"]}, {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:43",
        **bag_entry, "launches": bag_entry["launches"]
        + recsys["launches"]}, {
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
