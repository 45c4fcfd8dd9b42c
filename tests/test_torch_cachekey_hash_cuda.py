"""The hand-written CUDA ``cachekey_hash`` kernel against its plain
PyTorch version and the host digest, on the card.  Imports neither jax
nor ``repro``, so it runs on a machine with only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cachekey_hash_cuda.py

Every test skips without a CUDA device."""
import numpy as np
import pytest
import torch

import repro_torch.caching.provenance as prov
from repro_torch.kernels.cachekey_hash import (cachekey_hash,
                                               cachekey_hash_op,
                                               cachekey_hash_ref,
                                               host_cachekey)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# the reference's sweep, provenance rows (N = 1, long L) and a wide
# batch; then L not a multiple of the 32-word staging chunk (16-byte
# loads with a tail: 100; 4-byte loads: 37, 7), N not a multiple of the
# block's 256 rows, N = 1 at a plan digest's 64 words
CASES = [(1, 1), (10, 7), (256, 16), (300, 64), (1, 64), (1, 4096),
         (4096, 64), (257, 0), (513, 100), (1000, 37), (1, 40), (1, 7),
         (65536, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tokens(n, L, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, L),
                                         dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("n,L", CASES)
def test_kernel_matches_plain_version_bit_for_bit(cuda, n, L):
    t = _tokens(n, L, n * 7 + L)
    before = cachekey_hash.launches
    got = cachekey_hash_op(t.to(cuda))
    torch.cuda.synchronize()
    assert cachekey_hash.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n, 2)
    want = cachekey_hash_ref(t) if L <= 64 else None
    if want is not None:
        assert torch.equal(got.cpu(), want)
    for i in range(0, n, max(1, n // 4)):
        assert got[i].cpu().numpy().astype("<i4").tobytes() == \
            host_cachekey(t[i].numpy())


@pytest.mark.parametrize("n,L", [(3, 64), (300, 36)])
def test_misaligned_rows_and_out_views(cuda, n, L):
    """A view 4 bytes into its storage takes the 4-byte loads; ``out``
    may be a row range of a larger output."""
    t = _tokens(n, L, 5)
    flat = torch.zeros(n * L + 1, dtype=torch.int32, device=cuda)
    flat[1:] = t.reshape(-1).to(cuda)
    view = flat[1:].view(n, L)
    assert view.data_ptr() % 16 != 0
    out = torch.full((n + 2, 2), 7, dtype=torch.int32, device=cuda)
    cachekey_hash(view, out[1:n + 1])
    torch.cuda.synchronize()
    assert torch.equal(out[1:n + 1].cpu(), cachekey_hash_ref(t))
    assert bool((out[0] == 7).all() and (out[-1] == 7).all())


def test_digest_many_on_the_card_equals_digest_bytes(cuda):
    prev = prov.set_digest_device("cuda")
    try:
        rng = np.random.default_rng(1)
        payloads = [rng.bytes(n) for n in (0, 5, 248, 249, 700, 20000)]
        payloads += payloads[:3]
        before = cachekey_hash.launches
        got = prov.digest_many(payloads)
        assert cachekey_hash.launches == before + 4   # 64, 128, 192, 5056
        assert got == [prov.digest_bytes(p) for p in payloads]
        prov.set_digest_device("cpu")
        assert got == prov.digest_many(payloads)
    finally:
        prov.set_digest_device(prev)


def test_digest_bytes_on_the_card_equals_host_loop(cuda):
    prev = prov.set_digest_device("cuda")
    try:
        rng = np.random.default_rng(0)
        before = cachekey_hash.launches
        for size in (0, 1, 3, 255, 256, 257, 4096, 20000):
            data = rng.bytes(size)
            buf = len(data).to_bytes(8, "little") + data
            buf += b"\x00" * ((-len(buf)) % 4)
            words = np.frombuffer(buf, dtype="<u4")
            words = np.concatenate([words, np.zeros(
                (-len(words)) % 64, dtype="<u4")])
            assert prov.digest_bytes(data) == \
                prov._host_digest(words).hex()
        assert cachekey_hash.launches == before + 8
    finally:
        prov.set_digest_device(prev)


def test_kernel_refuses_what_it_cannot_take(cuda):
    with pytest.raises(TypeError):
        cachekey_hash(torch.zeros((4, 4), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        cachekey_hash(torch.zeros((4, 8), dtype=torch.int32,
                                  device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="CUDA"):
        cachekey_hash(torch.zeros((4, 4), dtype=torch.int32))
