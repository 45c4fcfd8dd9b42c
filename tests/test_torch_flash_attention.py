"""flash_attention of repro_torch: the port's op on the CPU (its plain
version) against the reference's op (the Pallas kernel in interpret
mode) on the same numpy-seeded inputs — the reference's sweep, a decode
step, causal Sq < Sk, MQA and GQA groupings, ``sk_valid`` and
``q_offset`` against the reference kernel's — and dispatch by device;
``path_for``'s choice of kernel; the plain versions of the kernels'
arithmetic (bf16 probabilities for the "wgmma" path, split-and-merge
for the "decode" path) against the reference and its bound.  The CUDA
kernels themselves are tested on the card by
``test_torch_flash_attention_cuda.py``."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention_op as j_op
from repro.kernels.flash_attention.kernel import flash_attention as j_kernel
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_op)
from repro_torch.kernels.flash_attention.kernel import (decode_splits,
                                                        path_for)
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     attention_bf16p_ref,
                                                     attention_split_ref,
                                                     bf16p_excess,
                                                     merge_partials)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

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


# (dtype, B, H, K, Sq, Sk, hd, causal, path): smollm-360m's prefill and
# decode steps, the reference's sweep, kernels_bench's f32 shape, bf16
# at head sizes the tensor-core path does not take, and G·Sq at the
# decode path's limit of 16 rows and one past it
PATHS = [
    ("bfloat16", 1, 15, 5, 4096, 4096, 64, True, "wgmma"),
    ("bfloat16", 128, 15, 5, 1, 32768, 64, True, "decode"),
    ("bfloat16", 1, 15, 5, 1, 32768, 64, True, "decode"),
    *[(dt, B, H, K, Sq, Sk, hd, c, "simt" if dt == "float32" else "wgmma")
      for B, H, K, Sq, Sk, hd, c, dt in FLASH_SWEEP],
    ("float32", 2, 8, 8, 1024, 1024, 64, True, "simt"),
    ("float32", 1, 8, 2, 512, 512, 64, True, "simt"),
    ("float32", 4, 8, 2, 1, 500, 64, True, "decode"),
    ("float32", 2, 3, 1, 1, 65, 100, False, "simt"),
    ("bfloat16", 1, 4, 2, 64, 64, 32, True, "simt"),
    ("bfloat16", 1, 4, 2, 64, 64, 48, True, "simt"),
    ("bfloat16", 1, 4, 2, 64, 64, 100, True, "simt"),
    ("bfloat16", 1, 4, 2, 1, 64, 32, True, "decode"),
    ("bfloat16", 1, 4, 2, 1, 64, 48, True, "simt"),
    ("bfloat16", 1, 4, 2, 1, 64, 100, True, "simt"),
    ("bfloat16", 1, 16, 1, 1, 64, 64, True, "decode"),     # G·Sq = 16
    ("bfloat16", 1, 17, 1, 1, 64, 64, True, "wgmma"),      # G·Sq = 17
    ("bfloat16", 1, 4, 1, 4, 64, 128, False, "decode"),    # 16
    ("bfloat16", 1, 1, 1, 17, 64, 128, False, "wgmma"),    # 17
    ("float32", 1, 1, 1, 16, 64, 64, True, "decode"),
    ("float32", 1, 1, 1, 17, 64, 64, True, "simt"),
]


@pytest.mark.parametrize("dt,B,H,K,Sq,Sk,hd,causal,path", PATHS)
def test_path_for(dt, B, H, K, Sq, Sk, hd, causal, path):
    assert path_for(getattr(torch, dt), B, H, K, Sq, Sk, hd, causal) == path


@pytest.mark.parametrize("B,K,Sk", [(128, 5, 32768), (1, 5, 32768),
                                    (4, 5, 1000), (1, 1, 1), (3, 2, 4097)])
def test_decode_splits_cover_the_keys_once(B, K, Sk):
    n, per = decode_splits(B, K, Sk)
    assert per % 64 == 0 and (n - 1) * per < Sk <= n * per
    assert n == 1 or per >= 256


def test_decode_splits_fill_the_card():
    """640 (batch, KV head) pairs at smollm's B 128 still get a few
    splits each; 5 pairs at B 1 get a split per 256 keys."""
    assert decode_splits(128, 5, 32768) == (7, 4736)
    assert decode_splits(1, 5, 32768) == (128, 256)


@pytest.mark.parametrize("B,H,K,S,hd", [(1, 3, 1, 256, 64),
                                        (1, 2, 2, 192, 128)])
def test_bf16_probabilities_are_within_their_bound(B, H, K, S, hd):
    """The "wgmma" path rounds P to bf16 for the PV product.  Its plain
    emulation stays within 2**-7 |plain| + 2**-8 A + 1e-4 of the Pallas
    op (fp32 P) and of the port's plain version, using about two thirds
    of it."""
    (jq, jk, jv), (q, k, v) = _inputs(B, H, K, S, S, hd, "bfloat16", S + hd)
    got = attention_bf16p_ref(q, k, v, causal=True)
    pallas = torch.from_numpy(np.asarray(
        j_op(jq, jk, jv, causal=True, block_q=64, block_k=64,
             interpret=True), np.float32))
    for plain in (pallas, attention_ref(q, k, v, causal=True)):
        assert 0.3 < float(bf16p_excess(got, q, k, v, plain=plain).max()) \
            <= 1.0


@pytest.mark.parametrize("B,H,K,S,hd", [(1, 3, 1, 256, 64),
                                        (1, 2, 2, 192, 128)])
def test_reference_oracle_rounds_scores_and_probabilities(B, H, K, S, hd):
    """The reference's oracle rounds P to bf16 too, but also its scores
    (its QKᵀ einsum returns q's dtype): a plain emulation of both
    roundings gives the oracle to within one rounding of the output.
    With fp32 scores that arithmetic is within the "wgmma" path's bound;
    the oracle itself goes past it, as does nothing the port computes."""
    (jq, jk, jv), (q, k, v) = _inputs(B, H, K, S, S, hd, "bfloat16", S + hd)
    oracle = torch.from_numpy(np.asarray(
        j_attention_ref(jq, jk, jv, causal=True), np.float32))
    G = H // K
    qg = q.float().reshape(B, K, G, S, hd)
    causal = torch.arange(S)[None, :] <= torch.arange(S)[:, None]
    outs = []
    for round_scores in (True, False):
        s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float())
        if round_scores:
            s = s.bfloat16().float()
        p = torch.softmax((s / hd ** 0.5).masked_fill(~causal, -np.inf), -1)
        outs.append(torch.einsum("bkgqs,bksh->bkgqh",
                                 p.bfloat16().float(), v.float())
                    .reshape(B, H, S, hd).bfloat16())
    rtol, atol = TOL["bfloat16"]
    np.testing.assert_allclose(outs[0].float().numpy(), oracle.numpy(),
                               rtol=rtol, atol=atol)
    assert float(bf16p_excess(outs[1], q, k, v).max()) <= 1.0
    assert float(bf16p_excess(oracle, q, k, v).max()) > 1.0


def test_bf16_probabilities_exceed_one_rounding_of_the_output():
    """Why the "wgmma" path has a bound of its own: rounding P to bf16
    moves outputs by more than one rounding of the output, the
    tolerance of the fp32-P paths, and so does the reference's oracle;
    a kernel that drops a tile of 64 keys fails the new bound."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 3, 1, 256, 256, 64, "bfloat16", 11)
    plain = attention_ref(q, k, v, causal=True).float()
    rtol, atol = TOL["bfloat16"]

    def beyond_old(out):
        return int(((out.float() - plain).abs()
                    > atol + rtol * plain.abs()).sum())

    assert beyond_old(attention_bf16p_ref(q, k, v, causal=True)) > 100
    oracle = torch.from_numpy(np.asarray(
        j_attention_ref(jq, jk, jv, causal=True), np.float32))
    assert beyond_old(oracle) > 100
    j = torch.arange(256)
    keep = (j[None, :] <= j[:, None]) & ((j < 128) | (j >= 192))[None, :]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float().expand(-1, 3,
                                                                   -1, -1))
    p = torch.softmax((s / 8).masked_fill(~keep, -np.inf), -1)
    skipped = torch.einsum("bhqk,bhkd->bhqd", p,      # keys 128-191 dropped
                           v.float().expand(-1, 3, -1, -1))
    assert int((bf16p_excess(skipped, q, k, v) > 1).sum()) > 1000


def _split_inputs(seed):
    rng = np.random.default_rng(seed)
    B, H, K, Sq, Sk, hd = 2, 6, 2, 40, 70, 16
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd))]


@pytest.mark.parametrize("n_splits", [1, 2, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_split_and_merge_matches_attention_ref(n_splits, causal):
    """The decode path's arithmetic: per-split (m, l, acc), merged.  At 7
    splits of 10 keys, causal, the last split's keys are all masked for
    query rows 0-29 (m = -1e30, l = 0 there)."""
    q, k, v = _split_inputs(n_splits)
    per = -(-70 // n_splits)
    got = attention_split_ref(q, k, v, causal=causal, keys_per_split=per)
    np.testing.assert_allclose(got.numpy(),
                               attention_ref(q, k, v, causal=causal).numpy(),
                               atol=2e-6)
    want = np.asarray(j_attention_ref(*(jnp.asarray(t.numpy())
                                        for t in (q, k, v)), causal=causal))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_merge_ignores_a_split_with_no_valid_key():
    rng = np.random.default_rng(4)
    m = torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(0.5, 2, size=(3, 2)).astype(np.float32))
    acc = torch.from_numpy(rng.normal(size=(3, 2, 8)).astype(np.float32))
    base = merge_partials(m, l, acc)
    with_empty = merge_partials(torch.cat([m, torch.full((3, 1), NEG_INF)], 1),
                                torch.cat([l, torch.zeros(3, 1)], 1),
                                torch.cat([acc, torch.zeros(3, 1, 8)], 1))
    np.testing.assert_allclose(with_empty.numpy(), base.numpy(), rtol=1e-6)
    none = merge_partials(torch.full((1, 4), NEG_INF), torch.zeros(1, 4),
                          torch.zeros(1, 4, 8))
    assert bool((none == 0).all())


def test_cpu_tensors_count_no_path():
    _, (q, k, v) = _inputs(1, 4, 2, 16, 16, 32, "bfloat16", 3)
    flash_attention_op(q, k, v)
    assert sum(flash_attention.paths.values()) == 0


# (B, H, K, Sq, Sk, sk_valid, q_offset, hd, causal): a decode step into a
# preallocated cache (smollm-360m's heads), a chunk of queries, an
# explicit q_offset, a cache with no valid key past the first, and a
# non-causal call that only sk_valid masks
SK_VALID = [
    (2, 6, 2, 1, 64, 41, None, 32, True),
    (1, 15, 5, 1, 128, 100, None, 64, True),
    (1, 15, 5, 1, 64, 1, None, 64, True),
    (1, 4, 2, 24, 128, 70, None, 32, True),
    (1, 4, 2, 16, 64, 50, 10, 16, True),
    (2, 6, 3, 8, 64, 33, None, 48, False),
]


def _cache_inputs(B, H, K, Sq, Sk, sk_valid, hd, seed):
    """q, and k/v caches of Sk rows whose rows past sk_valid hold large
    values: a kernel or plain version that read them would show it."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, K, Sk, hd)).astype(np.float32)
            for _ in range(2))
    for a in (k, v):
        a[:, :, sk_valid:] = rng.normal(size=a[:, :, sk_valid:].shape) * 1e3
    return q, k, v


@pytest.mark.parametrize("B,H,K,Sq,Sk,sk_valid,q_offset,hd,causal", SK_VALID)
def test_sk_valid_matches_the_reference_kernel(B, H, K, Sq, Sk, sk_valid,
                                               q_offset, hd, causal):
    """``sk_valid`` and ``q_offset`` of the port's op against the
    reference's Pallas kernel given the same arguments (interpret mode;
    q padded to its block of 8 rows, q_offset passed explicitly), and,
    with the default offset, against the reference's op over the first
    sk_valid keys, which it pads and masks through its own sk_valid."""
    q, k, v = _cache_inputs(B, H, K, Sq, Sk, sk_valid, hd, Sq * 100 + Sk)
    off = sk_valid - Sq if q_offset is None else q_offset
    got = flash_attention_op(*map(torch.from_numpy, (q, k, v)), causal=causal,
                             sk_valid=sk_valid, q_offset=q_offset).numpy()
    assert np.isfinite(got).all()
    pad = (-Sq) % 8
    want = np.asarray(j_kernel(
        jnp.asarray(np.pad(q, ((0, 0), (0, 0), (0, pad), (0, 0)))),
        jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=Sq + pad,
        block_k=Sk // 2, sk_valid=sk_valid, q_offset=off,
        interpret=True))[:, :, :Sq]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    if q_offset is None:
        sliced = np.asarray(j_op(jnp.asarray(q),
                                 jnp.asarray(k[:, :, :sk_valid]),
                                 jnp.asarray(v[:, :, :sk_valid]),
                                 causal=causal, interpret=True))
        np.testing.assert_allclose(got, sliced, rtol=0, atol=2e-5)


@pytest.mark.parametrize("B,H,K,Sq,Sk,sk_valid,q_offset,hd,causal",
                         SK_VALID[:2] + SK_VALID[3:5])
def test_sk_valid_in_the_paths_plain_versions(B, H, K, Sq, Sk, sk_valid,
                                              q_offset, hd, causal):
    """The "wgmma" and "decode" paths' plain arithmetic with sk_valid
    equals the semantics over the first sk_valid keys."""
    q, k, v = map(torch.from_numpy,
                  _cache_inputs(B, H, K, Sq, Sk, sk_valid, hd, 7))
    kw = dict(causal=causal, sk_valid=sk_valid, q_offset=q_offset)
    want = attention_ref(q, k[:, :, :sk_valid], v[:, :, :sk_valid],
                         causal=causal,
                         q_offset=sk_valid - Sq if q_offset is None
                         else q_offset)
    np.testing.assert_allclose(attention_ref(q, k, v, **kw).numpy(),
                               want.numpy(), atol=1e-6)
    n, per = decode_splits(B, K, sk_valid)
    np.testing.assert_allclose(
        attention_split_ref(q, k, v, keys_per_split=per, **kw).numpy(),
        want.numpy(), atol=2e-6)
    bq, bk, bv = (t.to(torch.bfloat16) for t in (q, k, v))
    got = attention_bf16p_ref(bq, bk, bv, block_k=32, **kw)
    assert float(bf16p_excess(got, bq, bk[:, :, :sk_valid].contiguous(),
                              bv[:, :, :sk_valid].contiguous(),
                              causal=causal,
                              q_offset=sk_valid - Sq if q_offset is None
                              else q_offset).max()) <= 1.0


def test_sk_valid_bounds_and_path_choice():
    q, k, v = (torch.zeros(1, 2, 1, 16), torch.zeros(1, 1, 8, 16),
               torch.zeros(1, 1, 8, 16))
    for bad in (-1, 9):
        with pytest.raises(ValueError, match="sk_valid"):
            flash_attention_op(q, k, v, sk_valid=bad)
    # the kernel is chosen for the keys that count, not the cache's rows
    assert path_for(torch.bfloat16, 16, 15, 5, 1, 4097, 64, True) == \
        "decode"
    assert decode_splits(16, 5, 4097) != decode_splits(16, 5, 32768)


@pytest.mark.parametrize("row", chip_smoke.FLASH_ROWS,
                         ids=lambda r: f"{r[0]}-{r[1]}x{r[4]}x{r[5]}-{r[9]}")
def test_chip_smoke_rows_take_the_path_they_name(row):
    """Each of ``chip_smoke.py``'s flash_attention rows is taken on the
    path it names, decided at its ``sk_valid``; a row that gives
    ``sk_valid`` leaves a last valid key inside the cache and no query
    row without a key."""
    label, B, H, K, Sq, Sk, sk_valid, hd, causal, dt, path = row
    sv = Sk if sk_valid is None else sk_valid
    assert path_for(getattr(torch, dt), B, H, K, Sq, sv, hd, causal) == path
    assert Sq <= sv <= Sk
