#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one output line or more each, the JSON result last:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: every kernel under ``src/repro_torch/kernels/*/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the reference's test shapes, a duplicated-rows tie case and the
   main path's shape (with timings there);
4. main path: the Table 2 retrieve-and-rerank Experiment with BM25 and
   dense retrieval over ``msmarco_like(2, scale=1.0)`` at the
   cross-encoder's full width, once on the kernel path and once on the
   plain ``"torch"`` backend, whose means must agree;
5. the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

Any failure raises and the script exits non-zero.  Without a CUDA
device, or outside a checkout, it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

CUTS = (20, 50, 100, 200)
MEASURES = ["nDCG@10", "MAP"]
NAMES = [f"bm25%{k}" for k in CUTS] + ["dense%200", "bm25|dense"]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
NEAR_TIE = 1e-5
# (Q, N, d, k, dtype) of the reference's dense_topk sweep
# (tests/test_kernels.py DENSE_SWEEP)
SWEEP = [(8, 256, 32, 10, "float32"), (5, 300, 33, 7, "float32"),
         (16, 1024, 64, 100, "float32"), (3, 130, 128, 130, "float32"),
         (8, 512, 64, 16, "bfloat16"), (1, 8, 16, 3, "float32")]


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


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` on the card (CUDA events), with the 50 MB L2
    flushed before each timed call, as a retrieval call finds it."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
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

    return SimpleNamespace(topics=topics, dense_enc=dense_enc,
                           dense_index=dense_index, mono=mono, duo=duo,
                           run=run)


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

    # -- 5. result lines ----------------------------------------------------
    log(json.dumps({"kernels": [{
        "name": "dense_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/dense_topk/csrc/dense_topk.cu",
        "replaces": "src/repro/kernels/dense_topk/kernel.py:96",
        "launches": launches, "max_abs_err": err_main, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
