"""The plain PyTorch version of ``cachekey_hash`` (what the port runs on
the CPU, and what the kernel is held against on the card) equals the
reference's Pallas kernel in interpret mode, its jnp oracle and its
host digest, bit for bit."""
import numpy as np
import pytest
import torch

from repro.kernels.cachekey_hash import (cachekey_hash_op as j_op,
                                         cachekey_hash_ref as j_ref,
                                         host_cachekey as j_host)
from repro_torch.kernels.cachekey_hash import (cachekey_hash_op,
                                               cachekey_hash_ref,
                                               host_cachekey)

torch.set_num_threads(1)

# the reference's sweep (tests/test_kernels.py) and a provenance row
SWEEP = [(1, 1), (10, 7), (256, 16), (300, 64), (1, 64)]


def _tokens(n, L, seed):
    """Random int32 rows over the full range, negative values included."""
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, size=(n, L),
                        dtype=np.int64).astype(np.int32)


def _lanes(out):
    """[N, 2] digest (int32 or uint32 bits) -> uint32 numpy."""
    return np.asarray(out).astype(np.int64).astype(np.uint32) \
        if np.asarray(out).dtype != np.uint32 else np.asarray(out)


@pytest.mark.parametrize("n,L", SWEEP)
def test_plain_version_equals_reference_kernel_and_oracle(n, L):
    t = _tokens(n, L, n * 1000 + L)
    got = _lanes(cachekey_hash_op(torch.from_numpy(t)).numpy())
    assert got.shape == (n, 2)
    np.testing.assert_array_equal(got, _lanes(j_op(t, interpret=True)))
    np.testing.assert_array_equal(got, _lanes(j_ref(t)))
    np.testing.assert_array_equal(
        _lanes(cachekey_hash_ref(torch.from_numpy(t)).numpy()), got)


@pytest.mark.parametrize("n,L", [(3, 5), (9, 33)])
def test_equals_host_digest_row_by_row(n, L):
    t = _tokens(n, L, 7 + L)
    got = _lanes(cachekey_hash_op(torch.from_numpy(t)).numpy())
    for i in range(n):
        want = host_cachekey(t[i])
        assert want == j_host(t[i])
        assert got[i].astype("<u4").tobytes() == want


def test_signed_extremes_and_byte_order():
    t = np.array([[-1, -2**31, 2**31 - 1, 0, 0x01020304]], dtype=np.int32)
    got = _lanes(cachekey_hash_op(torch.from_numpy(t)).numpy())
    np.testing.assert_array_equal(got, _lanes(j_ref(t)))
    # the low byte mixes first: a token and its byte-reversed twin differ
    rev = np.array([[0x04030201]], dtype=np.int32)
    fwd = np.array([[0x01020304]], dtype=np.int32)
    assert host_cachekey(fwd[0]) != host_cachekey(rev[0])
    assert host_cachekey(fwd[0]) == _lanes(cachekey_hash_op(
        torch.from_numpy(fwd)).numpy())[0].astype("<u4").tobytes()


def test_one_token_change_flips_the_digest():
    t = _tokens(4, 64, 3)
    base = _lanes(cachekey_hash_op(torch.from_numpy(t)).numpy())
    for j in (0, 31, 63):
        u = t.copy()
        u[2, j] ^= 1
        got = _lanes(cachekey_hash_op(torch.from_numpy(u)).numpy())
        assert (got[2] != base[2]).all()
        np.testing.assert_array_equal(np.delete(got, 2, 0),
                                      np.delete(base, 2, 0))


def test_padding_is_cut_off_and_empty_input():
    t = _tokens(13, 4, 11)      # padded to 13 rows, then to 256 at 257+
    out = cachekey_hash_op(torch.from_numpy(t))
    assert out.shape == (13, 2) and out.dtype == torch.int32
    empty = cachekey_hash_op(torch.zeros((0, 8), dtype=torch.int32))
    assert empty.shape == (0, 2)
    with pytest.raises(TypeError):
        cachekey_hash_op(torch.zeros((2, 3), dtype=torch.int64))
