"""embedding_bag of repro_torch: the port's op on the CPU (its plain
version) against the reference's op (the Pallas kernel in interpret
mode) on the same numpy-seeded inputs — the reference's sweep,
duplicate ids, ``mean`` with and without weights — clipped
out-of-range ids against the reference's oracle, and dispatch by
device.  The CUDA kernel itself is tested on the card by
``test_torch_embedding_bag_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag_op as j_op
from repro.kernels.embedding_bag import embedding_bag_ref as j_ref
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_op,
                                               embedding_bag_ref)

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 6e-2}
EB_SWEEP = [
    # V, d, B, L, weighted, combiner, dtype — the reference's sweep
    (64, 32, 4, 5, True, "sum", "float32"),
    (128, 48, 8, 3, False, "sum", "float32"),
    (1000, 64, 16, 10, True, "mean", "float32"),
    (64, 128, 2, 7, True, "sum", "bfloat16"),
    (32, 16, 1, 1, False, "mean", "float32"),
]
MORE = [
    (500, 64, 12, 9, False, "mean", "float32"),   # mean over L
    (300, 40, 6, 11, True, "mean", "bfloat16"),
    (200, 200, 3, 4, True, "sum", "float32"),     # d past one 128 group
    (1000, 64, 8, 50, True, "mean", "float32"),   # MIND's hist_len
]


def _inputs(V, d, B, L, weighted, dtype, seed):
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    w = rng.random((B, L)).astype(np.float32) if weighted else None
    dt = getattr(torch, dtype)
    return ((jnp.asarray(tab, dtype), jnp.asarray(ids),
             None if w is None else jnp.asarray(w, dtype)),
            (torch.from_numpy(tab).to(dt), torch.from_numpy(ids),
             None if w is None else torch.from_numpy(w).to(dt)))


@pytest.mark.parametrize("V,d,B,L,weighted,combiner,dtype", EB_SWEEP + MORE)
def test_op_matches_reference_op(V, d, B, L, weighted, combiner, dtype):
    j_in, t_in = _inputs(V, d, B, L, weighted, dtype, V + d * 3 + B + L)
    want = np.asarray(j_op(*j_in, combiner=combiner, interpret=True),
                      np.float32)
    got = embedding_bag_op(*t_in, combiner=combiner)
    assert got.dtype == t_in[0].dtype and got.shape == (B, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


def test_duplicate_ids_accumulate():
    ids = np.array([[3, 3, 3], [1, 5, 1]], np.int32)
    want = np.asarray(j_op(jnp.eye(8, dtype=jnp.float32), jnp.asarray(ids),
                           interpret=True))
    got = embedding_bag_op(torch.eye(8), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0, 3]) == 3.0 and float(got[1, 1]) == 2.0


def test_out_of_range_ids_are_clipped_as_the_oracle_clips():
    """The reference's oracle clips ids to [0, V-1]; its Pallas index map
    does not (-1 wraps to row 7 and 8 is clamped to 7 in interpret
    mode).  The port clips, so it equals the oracle."""
    tab = np.arange(32, dtype=np.float32).reshape(8, 4)
    ids = np.array([[-1, 8]], np.int32)
    oracle = np.asarray(j_ref(jnp.asarray(tab), jnp.asarray(ids)))
    np.testing.assert_array_equal(oracle, [[28, 30, 32, 34]])     # rows 0+7
    got = embedding_bag_op(torch.from_numpy(tab), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), oracle)
    pallas = np.asarray(j_op(jnp.asarray(tab), jnp.asarray(ids),
                             interpret=True))
    np.testing.assert_array_equal(pallas, [[56, 58, 60, 62]])     # rows 7+7


def test_mean_of_zero_weights_divides_by_the_floor():
    _, (tab, ids, _) = _inputs(16, 8, 2, 3, False, "float32", 4)
    w = torch.zeros(2, 3)
    got = embedding_bag_op(tab, ids, w, combiner="mean")
    want = np.asarray(j_op(jnp.asarray(tab.numpy()), jnp.asarray(ids.numpy()),
                           jnp.zeros((2, 3)), combiner="mean",
                           interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not bool(got.isnan().any())


def test_unknown_combiner_raises():
    with pytest.raises(ValueError, match="combiner"):
        embedding_bag_op(torch.eye(4), torch.zeros(1, 2, dtype=torch.int32),
                         combiner="max")


def test_cpu_tensors_take_the_plain_version():
    _, (tab, ids, w) = _inputs(100, 16, 4, 6, True, "float32", 2)
    got = embedding_bag_op(tab, ids, w, combiner="mean")
    assert torch.equal(got, embedding_bag_ref(tab, ids, w, "mean"))
    assert embedding_bag.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        embedding_bag(torch.eye(4), torch.zeros(1, 2, dtype=torch.int32))
    assert embedding_bag.launches == 0
