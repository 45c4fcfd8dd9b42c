"""On the card: ``recsys.embedding_bag`` through the CUDA
``embedding_bag`` kernel against its plain version, the refused
gradient through ``flash_attention``, and the LM's ``attention="plain"``
gradients against the same gradients on the CPU.  Imports neither jax
nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_autograd_cuda.py

Every test skips without a CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import embedding_bag as bag_kernel
from repro_torch.kernels.embedding_bag import embedding_bag_ref
from repro_torch.kernels.flash_attention import flash_attention_op
from repro_torch.models import lm as TL
from repro_torch.models import recsys as TR

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=512, vocab_pad_multiple=128, remat="none",
            n_experts=8, top_k=2, dtype=torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("mask", ["none", "binary", "fractional", "zero"])
@pytest.mark.parametrize("V,B,L", [(1000, 7, 5), (1_000_448, 512, 50)])
def test_recsys_embedding_bag_launches_the_kernel(cuda, V, B, L, mask,
                                                  combiner):
    """One kernel launch a call; within 1e-5 of the plain version with
    the reference's denominator max(Σmask, 1); ids past the table clip."""
    rng = np.random.default_rng(V + B)
    tab = torch.from_numpy(rng.normal(size=(V, 64)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-3, V + 3, (B, L)).astype(np.int32))
    m = {"none": None,
         "binary": torch.from_numpy(rng.integers(0, 2, (B, L))
                                    .astype(np.float32)),
         "fractional": torch.full((B, L), 0.5 / L),
         "zero": torch.zeros(B, L)}[mask]
    want = TR.embedding_bag(tab, ids, m, combiner)     # the CPU's plain path
    tab_c, ids_c = tab.to(cuda), ids.to(cuda)
    m_c = None if m is None else m.to(cuda)
    bag_kernel.launches = 0
    got = TR.embedding_bag(tab_c, ids_c, m_c, combiner)
    torch.cuda.synchronize()
    assert bag_kernel.launches == 1
    plain = embedding_bag_ref(tab_c, ids_c, m_c, "sum")
    if combiner == "mean":
        den = (m_c.sum(1, keepdim=True) if m_c is not None
               else torch.full((1, 1), float(L), device=cuda))
        plain = plain / torch.clamp(den, min=1.0)
    assert float((got - plain).abs().max()) <= 1e-5
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def test_flash_attention_gradient_is_refused_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 4, 64, 64, generator=g, device=cuda)
               for _ in range(3))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="attention='plain'"):
        flash_attention_op(q, k, v, causal=True)
    cfg = TL.LMConfig(**TINY)
    params, _ = TL.load_params(cfg, seed=0, device=cuda)
    for t in params["layers"].values():
        t.requires_grad_(True)
    toks = torch.randint(0, 512, (2, 16), device=cuda)
    with pytest.raises(RuntimeError, match="attention='plain'"):
        TL.causal_lm_loss(params, {"tokens": toks, "labels": toks}, cfg)


def _lm_grads(device):
    cfg = TL.LMConfig(**TINY)
    params, _ = TL.load_params(cfg, seed=0, device=device)
    names, leaves = [], []
    for k in sorted(params):
        if isinstance(params[k], dict):
            for kk in sorted(params[k]):
                names.append((k, kk))
                leaves.append(params[k][kk].requires_grad_(True))
        else:
            names.append((k,))
            leaves.append(params[k].requires_grad_(True))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 24))).to(device)
    loss = TL.causal_lm_loss(params, {"tokens": toks, "labels": toks}, cfg,
                             attention="plain")
    return loss, dict(zip(names, torch.autograd.grad(loss, leaves)))


def test_plain_attention_gradients_on_the_card_equal_the_cpus(cuda):
    """1e-4 relative to each gradient's largest magnitude, as the CPU
    holds them against ``jax.grad`` (``tests/test_torch_autograd.py``)."""
    cl, cg = _lm_grads(torch.device("cpu"))
    gl, gg = _lm_grads(cuda)
    assert abs(float(gl.detach()) - float(cl.detach())) <= 1e-5
    for name, want in cg.items():
        err = float((gg[name].cpu() - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), name
