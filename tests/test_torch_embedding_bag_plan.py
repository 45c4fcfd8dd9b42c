"""How the CUDA ``embedding_bag`` is laid out and what it rounds, on the
CPU: ``kernel.plan``'s invariants at every ``EB_ROWS`` row of
``chip_smoke.py`` and every case of the card tests, and
``ref.embedding_bag_kernel_order`` (the kernel's fused ``mean`` epilogue
in its rounding order) against the reference's op in interpret mode."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag_op as j_op
from repro_torch.kernels.embedding_bag import embedding_bag_ref, kernel
from repro_torch.kernels.embedding_bag.ref import embedding_bag_kernel_order

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = {"float32": 1e-5, "bfloat16": 6e-2}
# (V, d, B, L, dtype, alignment of the table's base in bytes): the smoke's
# rows, the card tests' cases, their misaligned views and ring depths
SHAPES = sorted({(V, d, B, L, dt, 16)
                 for _, V, d, B, L, _, _, dt in chip_smoke.EB_ROWS}
                | {(64, 32, 4, 5, "float32", 16), (128, 48, 8, 3, "float32", 16),
                   (1000, 64, 16, 10, "float32", 16),
                   (64, 128, 2, 7, "bfloat16", 16), (32, 16, 1, 1, "float32", 16),
                   (100000, 64, 513, 50, "float32", 16),
                   (300, 300, 9, 4, "bfloat16", 16), (10, 8, 3, 0, "float32", 16),
                   (1_000_000, 64, 512, 50, "bfloat16", 16),
                   (5000, 64, 7, 200, "float32", 16),
                   (5000, 96, 3, 97, "bfloat16", 16),
                   (5000, 300, 9, 130, "float32", 16),
                   (5000, 300, 9, 130, "bfloat16", 16),
                   (700, 48, 33, 1, "float32", 16), (64, 7, 5, 70, "bfloat16", 16),
                   (2000, 64, 21, 100, "float32", 16),
                   (2000, 64, 21, 3, "float32", 16),
                   (5000, 64, 64, 50, "float32", 4),
                   (5000, 64, 64, 50, "bfloat16", 2)})


@pytest.mark.parametrize("V,d,B,L,dtype,align", SHAPES)
def test_plan_invariants(V, d, B, L, dtype, align):
    p = kernel.plan(V, d, B, L, getattr(torch, dtype), align)
    row = d * kernel.ELT[getattr(torch, dtype)]
    # the width divides the row's bytes and the table's alignment
    assert p.vec in (2, 4, 8, 16) and row % p.vec == 0 and align % p.vec == 0
    assert p.vec >= kernel.ELT[getattr(torch, dtype)]
    # the column groups cover the row once, at most 32 lanes each
    assert 1 <= p.lanes <= 32
    assert p.groups * p.lanes * p.vec >= row > (p.groups - 1) * p.lanes * p.vec
    # rows in flight: a power of two, 1 <= U <= max(L, 1)
    assert 1 <= p.rows_in_flight <= max(L, 1)
    assert p.rows_in_flight in (1, 2, 4, 8)
    # the grid covers each (bag, column group) once
    assert p.warps in (1, 2, 4, 8)
    assert p.grid * p.warps >= B * p.groups > (p.grid - 1) * p.warps
    # the ring fits, and the bytes in flight are stated
    assert p.ring_bytes == p.warps * p.rows_in_flight * p.lanes * p.vec
    assert p.ring_bytes <= kernel.RING_BYTES
    assert 0 < p.bytes_in_flight_sm <= p.bytes_in_flight
    assert p.bytes_in_flight <= B * p.rows_in_flight * row


def test_plan_at_mind_serve():
    f32 = kernel.plan(1_000_000, 64, 512, 50, torch.float32, 16)
    assert (f32.vec, f32.lanes, f32.groups, f32.rows_in_flight, f32.warps,
            f32.grid) == (16, 16, 1, 8, 1, 512)
    assert f32.bytes_in_flight == 512 * 8 * 256          # 1 MiB
    bf16 = kernel.plan(1_000_000, 64, 512, 50, torch.bfloat16, 16)
    assert (bf16.vec, bf16.lanes, bf16.rows_in_flight) == (16, 8, 8)
    # a view one element past an aligned address takes a narrower width
    assert kernel.plan(1_000_000, 64, 512, 50, torch.float32, 4).vec == 4
    assert kernel.plan(1_000_000, 64, 512, 50, torch.bfloat16, 2).vec == 2


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.plan(10, 8, 2, 3, torch.float64, 16)
    with pytest.raises(ValueError, match="V, d, B >= 1"):
        kernel.plan(10, 0, 2, 3, torch.float32, 16)


def _inputs(weights, dtype, seed, V=200, d=48, B=8, L=50):
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    if weights == "random":
        w = rng.random((B, L)).astype(np.float32)
    elif weights == "0/1":                     # the first n of L slots
        w = (np.arange(L)[None, :]
             < rng.integers(1, L + 1, (B, 1))).astype(np.float32)
    else:
        w = None
    return tab, ids, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", [None, "0/1", "random"])
def test_fused_mean_order_matches_reference_op(weights, dtype):
    """The kernel's fused mean, in its rounding order, against the
    reference's op (Pallas kernel in interpret mode, then its division)
    and against the port's plain version."""
    tab, ids, w = _inputs(weights, dtype, 3 + len(str(weights)))
    jdt = getattr(jnp, dtype)
    want = np.asarray(j_op(jnp.asarray(tab, jdt), jnp.asarray(ids),
                           None if w is None else jnp.asarray(w, jdt),
                           combiner="mean", interpret=True), np.float32)
    dt = getattr(torch, dtype)
    t_in = (torch.from_numpy(tab).to(dt), torch.from_numpy(ids),
            None if w is None else torch.from_numpy(w).to(dt))
    got = embedding_bag_kernel_order(*t_in, combiner="mean")
    assert got.dtype == dt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])
    np.testing.assert_allclose(
        got.float().numpy(),
        embedding_bag_ref(*t_in, combiner="mean").float().numpy(),
        atol=TOL[dtype])


def test_kernel_order_is_exact_on_small_integers():
    """Small integers: every order gives the same bits, so the kernel's
    order equals the plain version exactly, sum and mean."""
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.integers(-8, 9, (300, 32)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-5, 305, (9, 70)).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 4, (9, 70)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        for ww in (None, w):
            for c in ("sum", "mean"):
                assert torch.equal(
                    embedding_bag_kernel_order(tab.to(dt), ids, ww, c),
                    embedding_bag_ref(tab.to(dt), ids, ww, c))


def test_mean_of_zero_weights_holds_the_floor():
    tab, ids, _ = _inputs(None, "float32", 5, B=3, L=4)
    w = torch.zeros(3, 4)
    got = embedding_bag_kernel_order(torch.from_numpy(tab),
                                     torch.from_numpy(ids), w, "mean")
    assert torch.equal(got, torch.zeros_like(got))
