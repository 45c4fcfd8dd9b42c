"""The hand-written CUDA ``dense_topk`` kernel against its plain PyTorch
version, on the card.  Imports neither jax nor ``repro``, so it runs on
a machine with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dense_topk_cuda.py

Every test skips without a CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.dense_topk import (dense_topk, dense_topk_op,
                                            dense_topk_ref)
from repro_torch.kernels.dense_topk.kernel import FILTER_K, plan

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# (Q, N, d, k, dtype): the reference's sweep, then the limits: k at the
# filter path's maximum in one split and over many, a width of 9,000
# (walked in chunks of 32), N < k_pad, k = N, bf16 over many splits, Q
# not a multiple of the block's 16 queries, the main path's shape
# (Table 2's dense retrieval) at its two k; then the select path (k >
# FILTER_K): k 2,000 over Table 2's corpus, k = N in one sort launch and
# in a sort over several, bf16, and an odd width
CASES = [
    (8, 256, 32, 10, "float32"),
    (5, 300, 33, 7, "float32"),
    (16, 1024, 64, 100, "float32"),
    (3, 130, 128, 130, "float32"),
    (8, 512, 64, 16, "bfloat16"),
    (1, 8, 16, 3, "float32"),
    (4, 5000, 64, FILTER_K, "float32"),
    (2, 700, 9000, 50, "float32"),
    (4, 100_000, 64, FILTER_K, "float32"),
    (4, 150, 32, 130, "float32"),
    (3, 700, 48, 700, "float32"),
    (8, 20_000, 128, 50, "bfloat16"),
    (53, 3000, 36, 10, "float32"),
    (53, 39_600, 128, 200, "float32"),
    (53, 39_600, 128, 100, "float32"),
    (53, 39_600, 128, 2000, "float32"),
    (4, 3000, 48, 3000, "float32"),
    (2, 20_000, 32, 20_000, "float32"),
    (8, 20_000, 128, 2000, "bfloat16"),
    (5, 4000, 33, 1500, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NEAR_TIE = 1e-5    # the two sum in other orders: neighbours this close may swap


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(Q, N, d, k, dtype, device):
    """Normal entries scaled by d**-0.25, so scores are O(1) at any d."""
    rng = np.random.default_rng(Q * 131 + N + d + k)
    scale = d ** -0.25
    q = torch.from_numpy((rng.normal(size=(Q, d)) * scale).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=(N, d)) * scale).astype(np.float32))
    dt = getattr(torch, dtype)
    return q.to(device, dt), c.to(device, dt)


@pytest.mark.parametrize("Q,N,d,k,dtype", CASES)
def test_kernel_matches_plain_version(cuda, Q, N, d, k, dtype):
    q, c = _inputs(Q, N, d, k, dtype, cuda)
    before = dense_topk.launches
    vals, idxs = dense_topk_op(q, c, k=k)
    rv, ri = dense_topk_ref(q, c, k=k)
    torch.cuda.synchronize()
    assert dense_topk.launches == before + plan(
        Q, N, d, k, sms=torch.cuda.get_device_properties(cuda)
        .multi_processor_count).launches
    rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
    np.testing.assert_allclose(vals.cpu().numpy(), rv, atol=TOL[dtype])
    for r, j in zip(*np.nonzero(idxs.cpu().numpy() != ri)):
        gaps = [abs(rv[r, j] - rv[r, jj]) for jj in (j - 1, j + 1)
                if 0 <= jj < k]
        assert gaps and min(gaps) < NEAR_TIE, (r, j)


def test_duplicated_rows_put_the_lower_index_first(cuda):
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32)).to(cuda)
    base = torch.from_numpy(rng.normal(size=(20, 32)).astype(np.float32))
    c = torch.cat([base, base]).to(cuda)         # every doc duplicated
    _, idxs = dense_topk(q, c, k=40)
    pos = idxs.cpu().argsort(dim=1)              # rank of each doc
    assert bool((pos[:, :20] < pos[:, 20:]).all())


def test_copies_in_other_splits_come_out_lower_index_first(cuda):
    """A 5,000-doc base repeated 8x: each doc's copies lie in other
    splits.  Small integer entries make every sum exact, in the kernel
    and in the plain version, so the two must agree exactly."""
    rng = np.random.default_rng(12)
    q = rng.integers(-3, 4, size=(4, 64)).astype(np.float32)
    base = rng.integers(-3, 4, size=(5000, 64)).astype(np.float32)
    q = torch.from_numpy(q).to(cuda)
    c = torch.from_numpy(np.concatenate([base] * 8)).to(cuda)
    assert plan(4, len(c), 64, 200).splits > 8
    vals, idxs = dense_topk(q, c, k=200)
    rv, ri = dense_topk_ref(q, c, k=200)
    assert torch.equal(vals, rv) and torch.equal(idxs, ri)
    for row in idxs.cpu().tolist():
        pos = {g: r for r, g in enumerate(row)}
        for g in pos:                   # every earlier copy ranks before it
            assert all(pos.get(e, 10 ** 9) < pos[g]
                       for e in range(g % 5000, g, 5000))


@pytest.mark.parametrize("k", [2000, 3000])
def test_select_path_ties_are_exact(cuda, k):
    """Integer entries make every score exact, on the card and in the
    plain version; a 1,500-doc base repeated twice puts every doc's copy
    1,500 later.  k 2,000 cuts through tied scores, k = N takes all."""
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.integers(-3, 4, size=(6, 64))
                         .astype(np.float32)).to(cuda)
    base = rng.integers(-3, 4, size=(1500, 64)).astype(np.float32)
    c = torch.from_numpy(np.concatenate([base, base])).to(cuda)
    assert plan(6, 3000, 64, k).path == "select"
    vals, idxs = dense_topk(q, c, k=k)
    rv, ri = dense_topk_ref(q, c, k=k)
    assert torch.equal(vals, rv) and torch.equal(idxs, ri)


def test_kernel_refuses_what_it_cannot_take(cuda):
    q, c = _inputs(2, 64, 16, 4, "float32", cuda)
    with pytest.raises(ValueError, match="k"):
        dense_topk(q, c, k=65)                   # k > N
    with pytest.raises(ValueError, match="k"):
        dense_topk(q, c, k=0)
    # above the filter path's limit the select path takes the call
    big = torch.zeros(FILTER_K + 1, 16, device=cuda)
    vals, idxs = dense_topk(q, big, k=FILTER_K + 1)
    assert torch.equal(idxs.cpu(), torch.arange(FILTER_K + 1, dtype=torch
                                                .int32).expand(2, -1))
    assert bool((vals == 0).all())
    with pytest.raises(TypeError, match="dtype"):
        dense_topk(q, c.to(torch.bfloat16), k=4)
    with pytest.raises(ValueError, match="contiguous"):
        dense_topk(q, c.t().contiguous().t(), k=4)
    with pytest.raises(ValueError, match="device"):
        dense_topk_op(q, c.cpu(), k=4)
