"""dense_topk of repro_torch: the plain version against the reference's
Pallas kernel (interpret mode) on its own sweep, the tie order, k
clamping, dispatch by device and the build helper; the kernel's
``plan`` and a plain emulation of its split-then-merge at that plan.
The CUDA kernel itself is tested on the card by
``test_torch_dense_topk_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dense_topk import dense_topk_op as j_dense_topk_op
from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.dense_topk import (dense_topk, dense_topk_op,
                                            dense_topk_ref)
from repro_torch.kernels.dense_topk.kernel import (BN, CAND, FILTER_K,
                                                   MAX_SMEM, SELECT_CAP,
                                                   SLICE, SMS, plan,
                                                   sort_launches)

torch.set_num_threads(1)

DENSE_SWEEP = [
    # Q, N, d, k, dtype — the reference's sweep (tests/test_kernels.py)
    (8, 256, 32, 10, "float32"),
    (5, 300, 33, 7, "float32"),
    (16, 1024, 64, 100, "float32"),
    (3, 130, 128, 130, "float32"),
    (8, 512, 64, 16, "bfloat16"),
    (1, 8, 16, 3, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(Q, N, d, k, dtype):
    rng = np.random.default_rng(Q * 131 + N + d + k)
    q = rng.normal(size=(Q, d)).astype(np.float32)
    c = rng.normal(size=(N, d)).astype(np.float32)
    jq, jc = jnp.asarray(q, dtype), jnp.asarray(c, dtype)
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    tc = torch.from_numpy(c).to(getattr(torch, dtype))
    return (jq, jc), (tq, tc)


@pytest.mark.parametrize("Q,N,d,k,dtype", DENSE_SWEEP)
def test_ref_matches_reference_kernel(Q, N, d, k, dtype):
    (jq, jc), (tq, tc) = _inputs(Q, N, d, k, dtype)
    rv, ri = j_dense_topk_op(jq, jc, k=k, interpret=True)
    vals, idxs = dense_topk_ref(tq, tc, k=k)
    assert vals.dtype == torch.float32 and idxs.dtype == torch.int32
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), atol=TOL[dtype])
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ri))


def _duplicated_rows():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    base = rng.normal(size=(20, 32)).astype(np.float32)
    return q, np.concatenate([base, base])       # every doc duplicated


def test_tie_break_is_lower_index():
    q, c = _duplicated_rows()
    _, ri = j_dense_topk_op(jnp.asarray(q), jnp.asarray(c), k=40,
                            interpret=True)
    _, idxs = dense_topk_op(torch.from_numpy(q), torch.from_numpy(c), k=40)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ri))
    for row in idxs.numpy():
        pos = {int(dd): p for p, dd in enumerate(row)}
        assert all(pos[dd] < pos[dd + 20] for dd in range(20))


def test_k_clamps_to_corpus():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(6, 16)).astype(np.float32))
    vals, idxs = dense_topk_op(q, c, k=50)
    assert vals.shape == (2, 6)
    assert sorted(idxs[0].tolist()) == list(range(6))


@pytest.mark.parametrize("Q,N", [(0, 5), (3, 0)])
def test_empty_inputs(Q, N):
    vals, idxs = dense_topk_op(torch.zeros(Q, 8), torch.zeros(N, 8), k=4)
    assert vals.shape == (Q, min(4, N)) and idxs.dtype == torch.int32


def test_cpu_tensors_take_the_plain_version():
    (_, _), (tq, tc) = _inputs(*DENSE_SWEEP[2])
    before = dense_topk.launches
    vals, idxs = dense_topk_op(tq, tc, k=100)
    rv, ri = dense_topk_ref(tq, tc, k=100)
    assert torch.equal(vals, rv) and torch.equal(idxs, ri)
    assert dense_topk.launches == before == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        dense_topk(torch.zeros(2, 8), torch.zeros(4, 8), k=2)
    assert dense_topk.launches == 0


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_build_finds_sources_and_raises_without_nvcc(monkeypatch, tmp_path):
    assert set(_build.sources()) == {"dense_topk", "cachekey_hash",
                                     "bm25_block", "flash_attention",
                                     "embedding_bag"}
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert path == _build.library_path(name)         # keyed by content
    assert _build.library_path("dense_topk") != \
        _build.library_path("cachekey_hash")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


# -- the kernel's plan, and its split-then-merge emulated -----------------

NEG_INF, IDX_PAD = -1e30, 2 ** 30


@pytest.mark.parametrize("d", [16, 33, 128, 9000])
@pytest.mark.parametrize("k", [1, 200, FILTER_K])
def test_plan_invariants(k, d):
    for Q in (1, 16, 53, 300):
        for N in (k, k + 1, 5000, 39_600, 8_841_823):
            if N < k:
                continue
            p = plan(Q, N, d, k)
            assert p.splits >= 1 and p.bq == 16
            assert p.per_split % BN == 0
            # every doc in exactly one split, and no split empty
            assert (p.splits - 1) * p.per_split < N <= p.splits * p.per_split
            assert p.k_pad >= k and p.k_pad & (p.k_pad - 1) == 0
            assert p.k_pad < 2 * k or p.k_pad == 1
            assert p.smem <= MAX_SMEM and p.merge_smem <= MAX_SMEM
            assert p.launches == (1 if p.splits == 1 else 2)
            assert (p.merge_smem == 0) == (p.splits == 1)
            blocks = -(-Q // p.bq) * p.splits
            assert p.splits == 1 or blocks <= SMS
            if p.splits > 1:
                assert p.per_split >= 4 * p.k_pad


def test_plan_fills_the_card_at_the_main_shape():
    p = plan(53, 39_600, 128, 200)        # Table 2's dense retrieval
    assert (p.splits, p.per_split, p.k_pad, p.launches) == (31, 1280, 256, 2)
    assert 4 * p.splits == 124            # of 132 SMs
    p = plan(53, 8_841_823, 128, 200)     # MS MARCO passage's corpus
    assert 4 * p.splits == 132
    assert plan(1, 8, 16, 3).launches == 1
    # above FILTER_K the select path takes over: no k <= N is refused
    assert plan(2, 2000, 16, FILTER_K + 1).path == "select"
    for bad in (0, 2001):
        with pytest.raises(ValueError, match="k"):
            plan(2, 2000, 16, bad)


def _better(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _best(entries, n):
    return sorted(entries, key=lambda e: (-e[0], e[1]))[:n]


def _split_then_merge(q, c, k, p):
    """The kernel's two stages at plan ``p``, in plain Python over the
    plain version's scores: each split walks its docs in tiles of BN in
    ascending order and holds, per query row, its best k so far and the
    docs better than the k-th of them, in k_pad + CAND slots; when the
    next tile might not fit, it keeps only the best k.  At the split's
    end its best k is its list; the merge takes the best k of all
    lists."""
    s = torch.matmul(q.float(), c.float().T).numpy()
    N, cap = s.shape[1], p.k_pad + CAND
    vals, idxs = [], []
    for row in s:
        lists = []
        for lo in range(0, p.splits * p.per_split, p.per_split):
            hi = min(N, lo + p.per_split)
            held, thr = [], (NEG_INF, IDX_PAD)
            for t0 in range(lo, hi, BN):
                tile = range(t0, min(hi, t0 + BN))
                held += [(float(row[g]), g) for g in tile
                         if _better((float(row[g]), g), thr)]
                assert len(held) <= cap
                if len(held) > cap - BN:
                    held = _best(held, k)
                    thr = held[-1]
            lists.append(_best(held, k))
        lists = [_best(sum(lists, []), k)]
        vals.append([v for v, _ in lists[0][:k]])
        idxs.append([i for _, i in lists[0][:k]])
    return (np.asarray(vals, np.float32), np.asarray(idxs, np.int32))


@pytest.mark.parametrize("Q,N,d,k,dtype", DENSE_SWEEP)
def test_split_then_merge_matches_reference_kernel(Q, N, d, k, dtype):
    (jq, jc), (tq, tc) = _inputs(Q, N, d, k, dtype)
    p = plan(Q, N, d, k)
    ev, ei = _split_then_merge(tq, tc, k, p)
    rv, ri = j_dense_topk_op(jq, jc, k=k, interpret=True)
    vals, idxs = dense_topk_ref(tq, tc, k=k)
    np.testing.assert_array_equal(ei, np.asarray(ri))
    np.testing.assert_array_equal(ei, idxs.numpy())
    np.testing.assert_array_equal(ev, vals.numpy())
    np.testing.assert_allclose(ev, np.asarray(rv), atol=TOL[dtype])


@pytest.mark.parametrize("sms", [1, 3, SMS])
def test_split_then_merge_ties_straddle_splits(sms):
    """A 300-doc base repeated 4x, so each doc's copies lie in other
    splits; small integer entries make every sum exact, so equal scores
    are everywhere, not only between copies."""
    rng = np.random.default_rng(15)
    q = rng.integers(-3, 4, size=(3, 16)).astype(np.float32)
    base = rng.integers(-3, 4, size=(300, 16)).astype(np.float32)
    c = np.concatenate([base] * 4)
    k = 40
    p = plan(3, len(c), 16, k, sms=sms)
    assert p.splits == {1: 1, 3: 3, SMS: 4}[sms]
    ev, ei = _split_then_merge(torch.from_numpy(q), torch.from_numpy(c), k, p)
    _, ri = j_dense_topk_op(jnp.asarray(q), jnp.asarray(c), k=k,
                            interpret=True)
    _, idxs = dense_topk_ref(torch.from_numpy(q), torch.from_numpy(c), k=k)
    np.testing.assert_array_equal(ei, np.asarray(ri))
    np.testing.assert_array_equal(ei, idxs.numpy())
    for row in ei:
        pos = {int(g): r for r, g in enumerate(row)}
        for g in pos:                   # a copy ranks after every earlier one
            for copy in range(g % 300, g, 300):
                assert copy in pos and pos[copy] < pos[g]


# -- the select path (k > FILTER_K): its plan, and its radix select emulated

def test_select_plan_at_table2_and_msmarco():
    assert plan(53, 39_600, 128, FILTER_K).path == "filter"
    p = plan(53, 39_600, 128, 2000)       # Table 2's corpus, k 2,000
    assert (p.path, p.q_chunk, p.slices, p.k_pad) == ("select", 53, 5, 2048)
    assert p.work_bytes == 53 * (4 * 39_600 + 4 * 1024 + 8 * 5 + 8 * 2048)
    assert p.launches == 7 + sort_launches(2048) == 8
    assert (p.splits, p.per_split) == (31, 1280)
    p = plan(53, 8_841_823, 128, 2000)    # MS MARCO passage's corpus
    assert (p.path, p.q_chunk, p.slices) == ("select", 30, 1080)
    assert p.work_bytes == 30 * (4 * 8_841_823 + 4 * 1024 + 8 * 1080
                                 + 8 * 2048) <= SELECT_CAP
    assert p.launches == 2 * 8            # two query chunks
    p = plan(53, 39_600, 128, 39_600)     # k = N: the sort spans launches
    assert p.k_pad == 65536 and sort_launches(65536) == 10
    assert p.launches == 17 and p.q_chunk == 53


@pytest.mark.parametrize("N,k", [(1500, 1025), (39_600, 2000),
                                 (8_841_823, 2000), (70_000, 70_000)])
def test_select_plan_invariants(N, k):
    for Q in (1, 16, 53, 300):
        p = plan(Q, N, 128, k)
        assert p.path == "select" and p.merge_smem == 0
        assert p.k_pad >= k > p.k_pad // 2
        assert (p.splits - 1) * p.per_split < N <= p.splits * p.per_split
        assert p.slices == -(-N // SLICE) and 1 <= p.q_chunk <= Q
        assert p.work_bytes <= SELECT_CAP or p.q_chunk == 1
        assert p.smem <= MAX_SMEM
        chunks = -(-Q // p.q_chunk)
        assert p.launches == chunks * (7 + sort_launches(p.k_pad))


def _score_keys(x):
    """Order-preserving uint32 keys of fp32 scores, -0 and +0 as one."""
    b = (x.astype(np.float32) + np.float32(0)).view(np.uint32)
    return np.where(b >> 31, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def _radix_select(row, k, slice_len):
    """The select path's kernels on one row of scores, in numpy: the
    k-th key V by four 8-bit passes; per slice, the keys above and equal
    to V; each winner's slot g + min(e, rem) from the counts before it;
    then the sort by key, then index.  Returns (vals, idxs, slots)."""
    keys = _score_keys(row)
    prefix, rem = 0, k
    for p in range(4):
        shift = 24 - 8 * p
        live = keys if p == 0 else keys[(keys >> (shift + 8)) == prefix]
        hist = np.bincount((live >> shift) & 255, minlength=256)
        above = 0
        for digit in range(255, -1, -1):
            if above + hist[digit] >= rem:
                break
            above += hist[digit]
        prefix, rem = (prefix << 8) | digit, rem - above
    v = np.uint32(prefix)
    slices = [keys[lo:lo + slice_len] for lo in range(0, len(keys),
                                                      slice_len)]
    counts = [(int((s > v).sum()), int((s == v).sum())) for s in slices]
    slots = {}
    for si, s in enumerate(slices):
        g = sum(c[0] for c in counts[:si])
        e = sum(c[1] for c in counts[:si])
        for j, key in enumerate(s):
            doc = si * slice_len + j
            if key > v:
                slots[min(e, rem) + g] = doc
                g += 1
            elif key == v:
                if e < rem:
                    slots[g + e] = doc
                e += 1
    docs = np.array([slots[i] for i in range(len(slots))])
    order = np.lexsort((docs, -keys[docs].astype(np.int64)))
    return row[docs[order]], docs[order].astype(np.int32), docs


@pytest.mark.parametrize("kind,N,k,slice_len", [
    ("integer", 3000, 1500, SLICE), ("integer", 3000, 3000, 256),
    ("integer", 3000, 2000, 256), ("normal", 2500, 2000, 300)])
def test_radix_select_emulation_matches_reference(kind, N, k, slice_len):
    """Integer entries make every score exact, so ties are everywhere;
    the winners must fill slots 0..k-1 in ascending doc order, and the
    result equal the reference's oracle exactly on indices."""
    from repro.kernels.dense_topk.ref import dense_topk_ref as j_ref
    rng = np.random.default_rng(N + k)
    if kind == "integer":
        q = rng.integers(-3, 4, size=(3, 16)).astype(np.float32)
        c = rng.integers(-3, 4, size=(N, 16)).astype(np.float32)
    else:
        q = rng.normal(size=(3, 16)).astype(np.float32)
        c = rng.normal(size=(N, 16)).astype(np.float32)
    s = torch.matmul(torch.from_numpy(q), torch.from_numpy(c).T).numpy()
    rv, ri = j_ref(jnp.asarray(q), jnp.asarray(c), k=k)
    tv, ti = dense_topk_ref(torch.from_numpy(q), torch.from_numpy(c), k=k)
    for r, row in enumerate(s):
        vals, idxs, docs = _radix_select(row, k, slice_len)
        assert len(docs) == k and bool((np.diff(docs) > 0).all())
        np.testing.assert_array_equal(idxs, ti.numpy()[r])
        np.testing.assert_array_equal(vals, tv.numpy()[r])
        np.testing.assert_array_equal(idxs, np.asarray(ri)[r])
        np.testing.assert_allclose(vals, np.asarray(rv)[r], atol=TOL["float32"])
