"""The hand-written CUDA ``flash_attention`` kernels against their plain
PyTorch version, on the card, one group of tests per path that
``path_for`` picks ("wgmma", "decode", "simt"), each asserting the path
taken and the launches.  Imports neither jax nor ``repro``, so it runs
on a machine with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention_cuda.py

Every test skips without a CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_op)
from repro_torch.kernels.flash_attention.kernel import (MAX_HEAD_DIM,
                                                        decode_splits,
                                                        path_for)
from repro_torch.kernels.flash_attention.ref import bf16p_excess

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# (rtol, atol) of the fp32-P paths ("decode", "simt"): kernel and plain
# version both compute in fp32, so their bf16 outputs differ by at most
# one rounding, 2**-7 of the output's size.  The "wgmma" path rounds P
# to bf16 and is held to ref.bf16p_excess instead.
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


def _run(q, k, v, causal, path):
    """flash_attention_op on the card; asserts the path it took and its
    launches (a split decode launches twice)."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    assert path_for(q.dtype, B, H, K, Sq, Sk, hd, causal) == path
    launches = 1
    if path == "decode" and decode_splits(B, K, Sk)[0] > 1:
        launches = 2
    before, paths = flash_attention.launches, flash_attention.paths.copy()
    got = flash_attention_op(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + launches
    paths[path] += 1
    assert flash_attention.paths == paths
    assert got.dtype == q.dtype and got.shape == q.shape
    return got


def _check(got, q, k, v, causal, path):
    want = attention_ref(q, k, v, causal=causal)
    if path == "wgmma":
        share = bf16p_excess(got, q, k, v, causal=causal, plain=want)
        assert float(share.max()) <= 1.0, float(share.max())
        return
    rtol, atol = TOL[str(q.dtype).removeprefix("torch.")]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,dtype", CASES)
def test_kernel_matches_plain_version(cuda, B, H, K, Sq, Sk, hd, causal,
                                      dtype):
    q, k, v = _inputs(B, H, K, Sq, Sk, hd, dtype, cuda)
    path = path_for(q.dtype, B, H, K, Sq, Sk, hd, causal)
    _check(_run(q, k, v, causal, path), q, k, v, causal, path)


# ---- "wgmma": bf16, hd 64 / 128, G·Sq > 16 ---------------------------------
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,K,Sq,Sk", [(1, 4, 2, 257, 257),
                                         (2, 3, 1, 1000, 1000),
                                         (1, 6, 2, 100, 1000),
                                         (1, 2, 2, 257, 1000),
                                         (1, 1, 1, 17, 40)])
def test_wgmma_path(cuda, B, H, K, Sq, Sk, hd, causal):
    q, k, v = _inputs(B, H, K, Sq, Sk, hd, "bfloat16", cuda)
    _check(_run(q, k, v, causal, "wgmma"), q, k, v, causal, "wgmma")


def test_wgmma_path_at_smollm_prefill(cuda):
    q, k, v = _inputs(1, 15, 5, 4096, 4096, 64, "bfloat16", cuda)
    _check(_run(q, k, v, True, "wgmma"), q, k, v, True, "wgmma")


def test_wgmma_path_copies_a_misaligned_view(cuda):
    """TMA needs a 16-byte aligned base: a view one element in is copied
    by the wrapper and still runs on the tensor cores."""
    q, k, v = _inputs(1, 2, 1, 130, 130, 64, "bfloat16", cuda)
    flat = torch.empty(k.numel() + 1, device=cuda, dtype=k.dtype)
    k_off = flat[1:].view_as(k)
    k_off.copy_(k)
    assert k_off.data_ptr() % 16 != 0
    got = _run(q, k_off, v, True, "wgmma")
    _check(got, q, k, v, True, "wgmma")


# ---- "decode": G·Sq <= 16, any dtype -----------------------------------------
@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,dtype", [
    (1, 15, 5, 1, 32768, 64, True, "bfloat16"),     # B 1: 128 splits
    (128, 15, 5, 1, 4096, 64, True, "bfloat16"),    # B 128
    (4, 8, 2, 1, 3000, 64, True, "float32"),
    (2, 8, 1, 2, 700, 128, False, "float32"),       # G·Sq = 16
    (1, 8, 1, 1, 5000, 128, True, "bfloat16"),      # 8 rows
    (3, 4, 2, 5, 333, 32, True, "bfloat16"),        # 10 rows, Sq > 1
    (2, 2, 2, 1, 200, 16, False, "float32"),        # one split
])
def test_decode_path(cuda, B, H, K, Sq, Sk, hd, causal, dtype):
    q, k, v = _inputs(B, H, K, Sq, Sk, hd, dtype, cuda)
    _check(_run(q, k, v, causal, "decode"), q, k, v, causal, "decode")


# ---- "simt": everything else -------------------------------------------------
@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,dtype", [
    (2, 4, 2, 128, 128, 64, True, "float32"),       # f32 prefill
    (1, 8, 8, 300, 300, 128, False, "float32"),
    (1, 6, 2, 70, 300, 48, True, "bfloat16"),       # bf16, hd 48
])
def test_simt_path(cuda, B, H, K, Sq, Sk, hd, causal, dtype):
    q, k, v = _inputs(B, H, K, Sq, Sk, hd, dtype, cuda)
    _check(_run(q, k, v, causal, "simt"), q, k, v, causal, "simt")


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,dtype,path", [
    (1, 2, 1, 8, 4, 16, "float32", "decode"),
    (1, 1, 1, 200, 100, 64, "bfloat16", "wgmma"),
    (1, 2, 1, 40, 20, 48, "bfloat16", "simt"),
])
def test_rows_without_a_valid_key_are_zero(cuda, B, H, K, Sq, Sk, hd, dtype,
                                           path):
    """Causal Sq > Sk: rows 0 to Sq - Sk - 1 see no key.  The reference's
    kernel gives a block-size-dependent average there and its oracle
    NaN; every path here writes 0, and the other rows match."""
    q, k, v = _inputs(B, H, K, Sq, Sk, hd, dtype, cuda)
    got = _run(q, k, v, True, path)
    want = attention_ref(q, k, v)
    n = Sq - Sk
    assert bool((got[:, :, :n] == 0).all())
    assert bool(want[:, :, :n].isnan().all())
    # the rows past n, as queries of their own, have the same causal limits
    _check(got[:, :, n:].contiguous(), q[:, :, n:].contiguous(), k, v, True,
           path)


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


# ---- sk_valid: a preallocated cache, partly filled --------------------------
@pytest.mark.parametrize("B,H,K,Sq,Sk,sk_valid,q_offset,hd,causal,dtype,path", [
    (16, 15, 5, 1, 4128, 4097, None, 64, True, "bfloat16", "decode"),
    (2, 15, 5, 1, 1000, 1, None, 64, True, "bfloat16", "decode"),
    (1, 8, 2, 1, 700, 333, None, 64, True, "float32", "decode"),
    (2, 4, 2, 3, 900, 500, 200, 32, True, "bfloat16", "decode"),
    (1, 15, 5, 300, 1024, 700, None, 64, True, "bfloat16", "wgmma"),
    (1, 4, 2, 130, 512, 257, None, 128, True, "bfloat16", "wgmma"),
    (1, 4, 2, 130, 512, 257, None, 64, False, "bfloat16", "wgmma"),
    (1, 6, 2, 70, 512, 300, None, 48, True, "float32", "simt"),
    (1, 6, 2, 70, 512, 300, 100, 48, True, "bfloat16", "simt"),
    (2, 4, 4, 64, 256, 100, None, 32, False, "float32", "simt"),
    # qwen3-14b's heads: hd 128, 40 heads over 8 KV heads (a group of 5)
    (1, 40, 8, 1, 4128, 4097, None, 128, True, "bfloat16", "decode"),
    (4, 40, 8, 1, 8192, 8000, None, 128, True, "bfloat16", "decode"),
    (1, 10, 2, 1, 700, 333, None, 128, True, "float32", "decode"),
    (1, 40, 8, 300, 1024, 700, None, 128, True, "bfloat16", "wgmma"),
    (1, 40, 8, 256, 256, 256, None, 128, True, "bfloat16", "wgmma"),
    (1, 10, 2, 70, 512, 300, None, 128, True, "float32", "simt"),
    (1, 10, 2, 70, 512, 300, 100, 128, False, "float32", "simt"),
])
def test_sk_valid_on_each_path(cuda, B, H, K, Sq, Sk, sk_valid, q_offset, hd,
                               causal, dtype, path):
    """Keys at or past sk_valid hold NaN: a path that read one would
    return NaN.  Each path takes its keys' count, not the cache's rows,
    and equals the plain version over the first sk_valid keys."""
    q, k, v = _inputs(B, H, K, Sq, Sk, hd, dtype, cuda)
    k[:, :, sk_valid:] = float("nan")
    v[:, :, sk_valid:] = float("nan")
    off = sk_valid - Sq if q_offset is None else q_offset
    assert path_for(q.dtype, B, H, K, Sq, sk_valid, hd, causal) == path
    launches = 2 if path == "decode" and \
        decode_splits(B, K, sk_valid)[0] > 1 else 1
    before, paths = flash_attention.launches, flash_attention.paths.copy()
    got = flash_attention_op(q, k, v, causal=causal, sk_valid=sk_valid,
                             q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + launches
    paths[path] += 1
    assert flash_attention.paths == paths
    assert bool(got.isfinite().all())
    ks, vs = k[:, :, :sk_valid].contiguous(), v[:, :, :sk_valid].contiguous()
    want = attention_ref(q, ks, vs, causal=causal, q_offset=off)
    if path == "wgmma":
        share = bf16p_excess(got, q, ks, vs, causal=causal, plain=want,
                             q_offset=off)
        assert float(share.max()) <= 1.0, float(share.max())
        return
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
