"""flash_attention of repro_torch: the port's op on the CPU (its plain
version) against the reference's op (the Pallas kernel in interpret
mode) on the same numpy-seeded inputs — the reference's sweep, a decode
step, causal Sq < Sk, MQA and GQA groupings — and dispatch by device.
The CUDA kernel itself is tested on the card by
``test_torch_flash_attention_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention_op as j_op
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_op)

torch.set_num_threads(1)

# (rtol, atol): bf16 outputs of two fp32 computations differ by at most
# one rounding of the output, 2**-7 of its size; the reference's oracle
# also rounds the probabilities to bf16, hence its 2e-2
TOL = {"float32": (0.0, 2e-5), "bfloat16": (2 ** -7, 1e-4)}
TOL_ORACLE = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_SWEEP = [
    # B, H, K, Sq, Sk, hd, causal, dtype — the reference's sweep
    (1, 2, 2, 64, 64, 32, True, "float32"),
    (2, 4, 2, 128, 128, 64, True, "float32"),
    (1, 8, 1, 128, 128, 64, True, "float32"),     # MQA
    (2, 4, 4, 96, 96, 32, True, "float32"),       # unaligned -> pad
    (1, 2, 2, 64, 256, 64, True, "float32"),      # cross Sq != Sk
    (1, 4, 2, 128, 128, 64, False, "float32"),
    (1, 2, 2, 128, 128, 128, True, "bfloat16"),
]
MORE = [
    (2, 6, 2, 1, 40, 32, True, "float32"),        # decode: Sq = 1 < 8
    (1, 6, 2, 1, 72, 64, True, "bfloat16"),       # decode, bf16
    (1, 4, 2, 24, 100, 32, True, "float32"),      # causal Sq < Sk, ragged
    (1, 4, 1, 40, 40, 16, True, "float32"),       # MQA, small head
    (1, 15, 5, 48, 48, 64, True, "float32"),      # smollm-360m's GQA (G=3)
    (1, 15, 5, 48, 48, 64, True, "bfloat16"),
    (2, 6, 3, 33, 70, 48, False, "float32"),      # GQA, not causal, ragged
]


def _inputs(B, H, K, Sq, Sk, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd))]
    return ([jnp.asarray(a, dtype) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,dtype", FLASH_SWEEP + MORE)
def test_op_matches_reference_op(B, H, K, Sq, Sk, hd, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, H, K, Sq, Sk, hd, dtype,
                                         B * 1000 + Sq)
    want = np.asarray(j_op(jq, jk, jv, causal=causal, block_q=64,
                           block_k=64, interpret=True), np.float32)
    got = flash_attention_op(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,dtype", MORE[:3])
def test_plain_version_matches_reference_oracle(B, H, K, Sq, Sk, hd, causal,
                                                dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, H, K, Sq, Sk, hd, dtype, 5)
    want = np.asarray(j_attention_ref(jq, jk, jv, causal=causal), np.float32)
    got = attention_ref(tq, tk, tv, causal=causal).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL_ORACLE[dtype])


def test_rows_without_a_valid_key_diverge_in_the_reference():
    """Causal Sq = 8 > Sk = 4: rows 0-3 see no key.  The reference's
    Pallas op masks with -1e30, so those rows average every key of the
    tiles it runs, padded ones included, and depend on block_k; its
    oracle gives NaN, and so does the port's plain version.  Rows with
    a valid key agree everywhere."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 1, 1, 8, 4, 8, "float32", 0)
    v0 = np.asarray(jv)[0, 0]
    pallas = np.asarray(j_op(jq, jk, jv, interpret=True))[0, 0]
    unpadded = np.asarray(j_op(jq, jk, jv, block_k=4, interpret=True))[0, 0]
    np.testing.assert_allclose(pallas[:4], np.tile(v0.sum(0) / 8, (4, 1)),
                               atol=1e-6)                 # 4 of 8 padded
    np.testing.assert_allclose(unpadded[:4], np.tile(v0.mean(0), (4, 1)),
                               atol=1e-6)
    oracle = np.asarray(j_attention_ref(jq, jk, jv))[0, 0]
    got = flash_attention_op(tq, tk, tv).numpy()[0, 0]
    assert np.isnan(oracle[:4]).all() and np.isnan(got[:4]).all()
    np.testing.assert_allclose(got[4:], oracle[4:], atol=2e-5)
    np.testing.assert_allclose(got[4:], pallas[4:], atol=2e-5)


def test_gqa_reads_the_shared_kv_head():
    """Query head h attends with KV head h // (H/K): with K = 2 and G = 3,
    heads 0-2 equal attention against KV head 0 alone."""
    _, (q, k, v) = _inputs(1, 6, 2, 8, 8, 16, "float32", 9)
    out = flash_attention_op(q, k, v)
    alone = flash_attention_op(q[:, :3], k[:, :1].expand(-1, 3, -1, -1)
                               .contiguous(), v[:, :1].expand(-1, 3, -1, -1)
                               .contiguous())
    np.testing.assert_allclose(out[:, :3].numpy(), alone.numpy(), atol=1e-6)


def test_empty_query_gives_an_empty_output():
    out = flash_attention_op(torch.zeros(1, 2, 0, 8), torch.zeros(1, 1, 4, 8),
                             torch.zeros(1, 1, 4, 8))
    assert out.shape == (1, 2, 0, 8)


def test_cpu_tensors_take_the_plain_version():
    _, (q, k, v) = _inputs(1, 4, 2, 16, 16, 32, "float32", 3)
    got = flash_attention_op(q, k, v)
    assert torch.equal(got, attention_ref(q, k, v))
    assert flash_attention.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(torch.zeros(1, 2, 4, 8), torch.zeros(1, 1, 4, 8),
                        torch.zeros(1, 1, 4, 8))
    assert flash_attention.launches == 0
