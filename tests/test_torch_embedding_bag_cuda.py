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
from repro_torch.kernels.embedding_bag import kernel as kernel_mod

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {"float32": 1e-5, "bfloat16": 6e-2}
# (V, d, B, L, weighted, combiner, dtype): the reference's sweep, then
# MIND's bag length, a width past one 128-column group, an empty bag,
# MIND's serving batch (table [1M, 64], B 512, L 50) in f32 and bf16, and
# bags longer than two chunks of 32 ids
CASES = [
    (64, 32, 4, 5, True, "sum", "float32"),
    (128, 48, 8, 3, False, "sum", "float32"),
    (1000, 64, 16, 10, True, "mean", "float32"),
    (64, 128, 2, 7, True, "sum", "bfloat16"),
    (32, 16, 1, 1, False, "mean", "float32"),
    (100000, 64, 513, 50, True, "mean", "float32"),
    (300, 300, 9, 4, True, "sum", "bfloat16"),
    (10, 8, 3, 0, False, "sum", "float32"),
    (1_000_000, 64, 512, 50, True, "mean", "float32"),
    (1_000_000, 64, 512, 50, True, "mean", "bfloat16"),
    (5000, 64, 7, 200, True, "sum", "float32"),
    (5000, 96, 3, 97, False, "mean", "bfloat16"),
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


def _integer_inputs(V, d, B, L, dtype, device, seed=0):
    """Small-integer table and weights: every product and partial sum is
    exact in fp32, so every summation order gives the same bits."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    tab = torch.from_numpy(rng.integers(-8, 9, (V, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, V, (B, L)).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 4, (B, L)).astype(np.float32))
    return tab.to(device, dt), ids.to(device), w.to(device, dt)


def _kernels_in(fn):
    """{kernel name: launches} on the device in one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type != DeviceType.CPU}


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


@pytest.mark.parametrize("V,d,B,L,dtype", [
    (1_000_000, 64, 512, 50, "float32"), (1_000_000, 64, 512, 50, "bfloat16"),
    (5000, 300, 9, 130, "float32"), (5000, 300, 9, 130, "bfloat16"),
    (700, 48, 33, 1, "float32"), (64, 7, 5, 70, "bfloat16")])
def test_integer_entries_are_bit_identical(cuda, V, d, B, L, dtype):
    tab, ids, w = _integer_inputs(V, d, B, L, dtype, cuda)
    for combiner in ("sum", "mean"):
        for ww in (None, w):
            got = embedding_bag_op(tab, ids, ww, combiner=combiner)
            want = embedding_bag_ref(tab, ids, ww, combiner)
            assert torch.equal(got, want), (combiner, ww is None)


@pytest.mark.parametrize("rows_in_flight", [1, 2, 4, 8])
@pytest.mark.parametrize("warps", [1, 8])
def test_every_ring_depth_is_bit_identical(cuda, monkeypatch, rows_in_flight,
                                           warps):
    """Each rows-in-flight U the kernel is built for, over bags of 100
    ids (four chunks of 32, so the id chunks rotate), against the plain
    version bit for bit; and U past the bag's length."""
    for L in (100, 3):
        tab, ids, w = _integer_inputs(2000, 64, 21, L, "float32", cuda, L)
        p = kernel_mod.plan(2000, 64, 21, L, tab.dtype,
                            kernel_mod.alignment(tab))
        forced = p._replace(rows_in_flight=rows_in_flight, warps=warps)
        monkeypatch.setattr(kernel_mod, "plan", lambda *a: forced)
        got = embedding_bag(tab, ids, w)
        monkeypatch.undo()
        assert torch.equal(got, embedding_bag_ref(tab, ids, w)), L


def test_two_calls_are_bit_identical(cuda):
    tab, ids, w = _inputs(1_000_000, 64, 512, 50, True, "float32", cuda)
    a = embedding_bag_op(tab, ids, w, combiner="mean")
    b = embedding_bag_op(tab, ids, w, combiner="mean")
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_mean_is_one_launch_in_the_kernel(cuda, dtype, weighted):
    """Weights None or in the table's dtype: the kernel's epilogue
    divides, and the op's call runs that one kernel and nothing else."""
    tab, ids, w = _inputs(100000, 64, 512, 50, weighted, dtype, cuda)
    before = embedding_bag.launches
    got = embedding_bag_op(tab, ids, w, combiner="mean")
    assert embedding_bag.launches == before + 1
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        embedding_bag_ref(tab, ids, w, "mean").float().cpu().numpy(),
        atol=TOL[dtype])
    kernels = _kernels_in(lambda: embedding_bag_op(tab, ids, w,
                                                   combiner="mean"))
    assert sum(kernels.values()) == 1, kernels
    assert "embedding_bag_kernel" in next(iter(kernels))


def test_mean_with_f32_weights_on_a_bf16_table_divides_in_the_op(cuda):
    tab, ids, _ = _inputs(100000, 64, 512, 50, False, "bfloat16", cuda)
    _, _, w = _inputs(100000, 64, 512, 50, True, "float32", cuda)
    got = embedding_bag_op(tab, ids, w, combiner="mean")
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        embedding_bag_ref(tab, ids, w, "mean").float().cpu().numpy(),
        atol=TOL["bfloat16"])
    kernels = _kernels_in(lambda: embedding_bag_op(tab, ids, w,
                                                   combiner="mean"))
    assert sum(kernels.values()) > 1, kernels
    with pytest.raises(TypeError, match="mean"):
        embedding_bag(tab, ids, w, mean=True)


@pytest.mark.parametrize("dtype,vec", [("float32", 4), ("bfloat16", 2)])
def test_misaligned_table_takes_the_plans_width(cuda, dtype, vec):
    """A contiguous view one element past an aligned address."""
    V, d, B, L = 5000, 64, 64, 50
    tab, ids, w = _integer_inputs(V, d, B, L, dtype, cuda)
    flat = torch.empty(V * d + 1, dtype=tab.dtype, device=cuda)
    view = flat[1:1 + V * d].view(V, d)
    view.copy_(tab)
    assert view.is_contiguous() and kernel_mod.alignment(view) == vec
    assert kernel_mod.plan(V, d, B, L, view.dtype,
                           kernel_mod.alignment(view)).vec == vec
    for combiner in ("sum", "mean"):
        got = embedding_bag_op(view, ids, w, combiner=combiner)
        assert torch.equal(got, embedding_bag_ref(tab, ids, w, combiner))
    rtab, rids, rw = _inputs(V, d, B, L, True, dtype, cuda)
    view.copy_(rtab)
    np.testing.assert_allclose(
        embedding_bag_op(view, rids, rw).float().cpu().numpy(),
        embedding_bag_ref(rtab, rids, rw).float().cpu().numpy(),
        atol=TOL[dtype])


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
    with pytest.raises(TypeError, match="mean"):
        embedding_bag(tab, ids, w.double(), mean=True)


def test_launch_refuses_a_plan_it_was_not_built_for(cuda, monkeypatch):
    tab, ids, w = _inputs(64, 32, 4, 5, True, "float32", cuda)
    p = kernel_mod.plan(64, 32, 4, 5, tab.dtype, kernel_mod.alignment(tab))
    for bad in (p._replace(rows_in_flight=kernel_mod.MAX_U * 2),
                p._replace(rows_in_flight=3), p._replace(vec=p.vec * 2),
                p._replace(warps=16), p._replace(groups=p.groups + 1)):
        monkeypatch.setattr(kernel_mod, "plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="CUDA error"):
            embedding_bag(tab, ids, w)
