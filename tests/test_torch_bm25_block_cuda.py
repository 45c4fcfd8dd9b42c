"""The hand-written CUDA ``bm25_block`` kernel against its plain PyTorch
version, on the card.  Imports neither jax nor ``repro``, so it runs on
a machine with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_bm25_block_cuda.py

Every test skips without a CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.ir import InvertedIndex, msmarco_like
from repro_torch.kernels.bm25_block import (bm25_block, bm25_block_op,
                                            bm25_block_ref)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# (T, D): the reference's sweep, its bench's tile, ragged and empty
# edges; D not a multiple of 4 takes the 4-byte loads; T above the
# block's 8 warps gives each warp several terms
CASES = [(8, 128), (20, 150), (64, 512), (5, 40), (64, 8192), (0, 300),
         (3, 1), (7, 100001), (37, 1001), (9, 39_600), (40, 4096)]
# |kernel - plain| <= ATOL: both sum in fp32 but in other orders (the
# kernel per warp in term order, then the warps' sums in warp order)
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(T, D, device, seed=0):
    rng = np.random.default_rng(seed + T * 31 + D)
    return (torch.from_numpy(rng.poisson(0.3, (T, D)).astype(np.float32))
            .to(device),
            torch.from_numpy((rng.random(T) * 5).astype(np.float32))
            .to(device),
            torch.from_numpy(rng.integers(20, 100, D).astype(np.float32))
            .to(device))


@pytest.mark.parametrize("T,D", CASES)
def test_kernel_matches_plain_version(cuda, T, D):
    tf, idf, dl = _inputs(T, D, cuda)
    before = bm25_block.launches
    got = bm25_block_op(tf, idf, dl, avg_dl=55.0)
    want = bm25_block_ref(tf, idf, dl, avg_dl=55.0)
    torch.cuda.synchronize()
    assert bm25_block.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)


def test_misaligned_view_and_repeat_runs_give_the_same_bits(cuda):
    """A tile 4 bytes into its storage (contiguous, not 16-byte aligned)
    takes the 4-byte loads; two runs of either path give equal bits."""
    tf, idf, dl = _inputs(12, 4096, cuda, seed=3)
    flat = torch.zeros(tf.numel() + 1, device=cuda)
    flat[1:] = tf.reshape(-1)
    view = flat[1:].view(tf.shape)
    assert view.data_ptr() % 16 != 0 and tf.data_ptr() % 16 == 0
    want = bm25_block_ref(tf, idf, dl, avg_dl=55.0)
    for x in (view, tf):
        a = bm25_block(x, idf, dl, avg_dl=55.0)
        b = bm25_block(x, idf, dl, avg_dl=55.0)
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), want.cpu().numpy(),
                                   atol=ATOL)


def test_degenerate_parameters_give_no_nan(cuda):
    tf, idf, dl = _inputs(6, 50, cuda)
    dl[:10] = 0.0
    for k1, b in [(0.0, 0.75), (1.2, 1.0)]:
        got = bm25_block(tf, idf, dl, k1=k1, b=b, avg_dl=40.0)
        assert bool(got.isfinite().all())
        np.testing.assert_allclose(
            got.cpu().numpy(),
            bm25_block_ref(tf, idf, dl, k1=k1, b=b, avg_dl=40.0)
            .cpu().numpy(), atol=ATOL)


def test_reproduces_score_query(cuda):
    corpus = msmarco_like(1, scale=0.05)
    index = InvertedIndex.build(corpus.get_corpus_iter())
    bm25 = index.bm25(num_results=50)
    dl = torch.from_numpy(index.doc_len).to(cuda)
    for query in corpus.get_topics()["query"]:
        terms = [t for t in index.tokenizer.tokenize(query)
                 if t in index.postings]
        tf = np.zeros((len(terms), index.n_docs), np.float32)
        for ti, t in enumerate(terms):
            tf[ti, index.postings[t][0]] = index.postings[t][1]
        idf = np.array([index.idf(t) for t in terms], np.float32)
        got = bm25_block_op(torch.from_numpy(tf).to(cuda),
                            torch.from_numpy(idf).to(cuda), dl, k1=bm25.k1,
                            b=bm25.b, avg_dl=index.avg_dl).cpu().numpy()
        ids, scores = bm25.score_query(query)
        np.testing.assert_allclose(got[ids], scores, rtol=1e-4)


def test_kernel_refuses_what_it_cannot_take(cuda):
    tf, idf, dl = _inputs(4, 16, cuda)
    with pytest.raises(TypeError, match="float32"):
        bm25_block(tf.double(), idf, dl)
    with pytest.raises(ValueError, match="idf"):
        bm25_block(tf, idf[:3], dl)
    with pytest.raises(ValueError, match="contiguous"):
        bm25_block(tf.t().contiguous().t(), idf[:4], dl)
    with pytest.raises(ValueError, match="device"):
        bm25_block_op(tf, idf.cpu(), dl)
