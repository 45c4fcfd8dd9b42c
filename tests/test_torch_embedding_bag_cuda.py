"""The hand-written CUDA ``embedding_bag`` kernel against its plain
PyTorch version, on the card.  Imports neither jax nor ``repro``, so it
runs on a machine with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_embedding_bag_cuda.py

Every test skips without a CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_op,
                                               embedding_bag_ref)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {"float32": 1e-5, "bfloat16": 6e-2}
# (V, d, B, L, weighted, combiner, dtype): the reference's sweep, then
# MIND's bag length, a width past one 128-column group, an empty bag
CASES = [
    (64, 32, 4, 5, True, "sum", "float32"),
    (128, 48, 8, 3, False, "sum", "float32"),
    (1000, 64, 16, 10, True, "mean", "float32"),
    (64, 128, 2, 7, True, "sum", "bfloat16"),
    (32, 16, 1, 1, False, "mean", "float32"),
    (100000, 64, 513, 50, True, "mean", "float32"),
    (300, 300, 9, 4, True, "sum", "bfloat16"),
    (10, 8, 3, 0, False, "sum", "float32"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(V, d, B, L, weighted, dtype, device):
    rng = np.random.default_rng(V + d * 3 + B + L)
    dt = getattr(torch, dtype)
    tab = torch.from_numpy(rng.normal(size=(V, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, V, (B, L)).astype(np.int32))
    w = torch.from_numpy(rng.random((B, L)).astype(np.float32)) \
        if weighted else None
    return (tab.to(device, dt), ids.to(device),
            None if w is None else w.to(device, dt))


@pytest.mark.parametrize("V,d,B,L,weighted,combiner,dtype", CASES)
def test_kernel_matches_plain_version(cuda, V, d, B, L, weighted, combiner,
                                      dtype):
    tab, ids, w = _inputs(V, d, B, L, weighted, dtype, cuda)
    before = embedding_bag.launches
    got = embedding_bag_op(tab, ids, w, combiner=combiner)
    want = embedding_bag_ref(tab, ids, w, combiner)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    assert got.dtype == tab.dtype and got.shape == (B, d)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=TOL[dtype])


def test_out_of_range_ids_are_clipped(cuda):
    tab = torch.arange(32, dtype=torch.float32, device=cuda).reshape(8, 4)
    ids = torch.tensor([[-1, 8], [3, 3]], dtype=torch.int32, device=cuda)
    got = embedding_bag(tab, ids)
    assert got.cpu().tolist() == [[28, 30, 32, 34], [24, 26, 28, 30]]


def test_kernel_refuses_what_it_cannot_take(cuda):
    tab, ids, w = _inputs(64, 32, 4, 5, True, "float32", cuda)
    with pytest.raises(TypeError, match="int32"):
        embedding_bag(tab, ids.long())
    with pytest.raises(TypeError, match="bfloat16"):
        embedding_bag(tab.double(), ids)
    with pytest.raises(ValueError, match="weights"):
        embedding_bag(tab, ids, w[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(tab.t().contiguous().t(), ids)
    with pytest.raises(ValueError, match="device"):
        embedding_bag_op(tab, ids.cpu())
