"""The hand-written CUDA ``flash_attention`` kernel against its plain
PyTorch version, on the card.  Imports neither jax nor ``repro``, so it
runs on a machine with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention_cuda.py

Every test skips without a CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_op)
from repro_torch.kernels.flash_attention.kernel import MAX_HEAD_DIM

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# (rtol, atol): kernel and plain version both compute in fp32, so their
# bf16 outputs differ by at most one rounding, 2**-7 of the output's size
TOL = {"float32": (0.0, 2e-5), "bfloat16": (2 ** -7, 1e-4)}
# (B, H, K, Sq, Sk, hd, causal, dtype): the reference's sweep, then a
# decode step, causal Sq < Sk, smollm-360m's grouping, odd widths
CASES = [
    (1, 2, 2, 64, 64, 32, True, "float32"),
    (2, 4, 2, 128, 128, 64, True, "float32"),
    (1, 8, 1, 128, 128, 64, True, "float32"),
    (2, 4, 4, 96, 96, 32, True, "float32"),
    (1, 2, 2, 64, 256, 64, True, "float32"),
    (1, 4, 2, 128, 128, 64, False, "float32"),
    (1, 2, 2, 128, 128, 128, True, "bfloat16"),
    (4, 15, 5, 1, 1000, 64, True, "bfloat16"),
    (1, 6, 2, 70, 300, 48, True, "float32"),
    (1, 15, 5, 257, 257, 64, True, "bfloat16"),
    (2, 3, 1, 33, 65, 100, False, "float32"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(B, H, K, Sq, Sk, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed + B * 1000 + Sq + hd)
    dt = getattr(torch, dtype)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device, dt)
            for s in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd))]


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,dtype", CASES)
def test_kernel_matches_plain_version(cuda, B, H, K, Sq, Sk, hd, causal,
                                      dtype):
    q, k, v = _inputs(B, H, K, Sq, Sk, hd, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention_op(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def test_rows_without_a_valid_key_are_zero(cuda):
    """Causal Sq = 8 > Sk = 4: rows 0-3 see no key.  The reference's
    kernel gives a block-size-dependent average there and its oracle
    NaN; this kernel writes 0, and the other rows match."""
    q, k, v = _inputs(1, 2, 1, 8, 4, 16, "float32", cuda)
    got = flash_attention_op(q, k, v).cpu()
    want = attention_ref(q, k, v).cpu()
    assert bool((got[:, :, :4] == 0).all())
    assert bool(want[:, :, :4].isnan().all())
    np.testing.assert_allclose(got[:, :, 4:].numpy(),
                               want[:, :, 4:].numpy(), atol=2e-5)


def test_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _inputs(1, 4, 2, 8, 8, 32, "float32", cuda)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="multiple of K"):
        flash_attention(q[:, :3].contiguous(), k, v)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(strided, k, v)
    big = torch.zeros(1, 2, 8, MAX_HEAD_DIM + 1, device=cuda)
    with pytest.raises(ValueError, match="hd"):
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="device"):
        flash_attention_op(q, k.cpu(), v)
