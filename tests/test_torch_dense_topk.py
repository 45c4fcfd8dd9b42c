"""dense_topk of repro_torch: the plain version against the reference's
Pallas kernel (interpret mode) on its own sweep, the tie order, k
clamping, dispatch by device and the build helper.  The CUDA kernel
itself is tested on the card by ``test_torch_dense_topk_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dense_topk import dense_topk_op as j_dense_topk_op
from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.dense_topk import (dense_topk, dense_topk_op,
                                            dense_topk_ref)

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
