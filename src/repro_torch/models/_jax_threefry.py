"""A numpy copy of ``jax.random.normal`` for fixed constants of a model.

MIND's routing-logit init (``repro.models.recsys.mind_interests``) is
``jax.random.normal(jax.random.key(17), (1, K, L))``: a constant of the
function, not a weight, so the weight bridge cannot carry it.  This
module draws the same numbers without JAX, as jax 0.9 draws them with
``jax_threefry_partitionable`` on (its default):

* the key of an integer seed s is the word pair (s >> 32, s & 0xFFFFFFFF);
* the 32-bit words of a shape are ``bits1 ^ bits2`` of Threefry-2x32
  (20 rounds, Salmon et al. 2011) keyed by that pair, over the flat
  index's high and low words as the two counters;
* uniform floats take the top 23 bits as the mantissa of a float in
  [1, 2), subtract 1, then scale to [nextafter(-1, 0), 1) in float32;
* the normal values are ``sqrt(2) * erfinv(u)``.

The words and uniforms are bit-equal to JAX's.  ``erf_inv`` is not a
correctly rounded function in XLA: on the CPU it is Giles' float32
polynomial over ``w = -log1p(-u*u)``, with ``log1p`` a Cephes rational
below |x| < sqrt(2) - 1 and Cephes' ``logf`` of 1 + x above it, each
multiply-add fused.  An erfinv evaluated in float64 and rounded once
lies up to 7 float32 ulp from that polynomial, so this module repeats
it step by step in float32, with each fused multiply-add taken in
float64 (the product of two float32 values is exact there) and rounded
to float32.  The values then equal ``jax.random.normal``'s on jax 0.9's
CPU backend; ``tests/test_torch_recsys.py`` holds them within 2 ulp.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = ["threefry2x32", "random_bits", "uniform", "erf_inv", "normal"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words (x0, x1) under ``key``, as
    ``jax._src.prng.threefry2x32_p`` computes it (uint32 arithmetic
    wraps)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _key(seed: int) -> Tuple[int, int]:
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def random_bits(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(jax.random.key(seed), shape)``: uint32 words."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(_key(seed), hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """float32 uniforms on [nextafter(-1, 0), 1), as ``jax.random.normal``
    draws them before ``erf_inv``."""
    bits = random_bits(seed, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)) \
        .view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    hi = np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


_F32, _F64 = np.float32, np.float64


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (up to a double rounding)."""
    return (np.asarray(a, _F32).astype(_F64) * np.asarray(b, _F32)
            .astype(_F64) + np.asarray(c, _F32).astype(_F64)).astype(_F32)


#: Cephes ``logf``'s coefficients, as XLA's CPU backend evaluates it
_LOG_P = tuple(_F32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
#: Cephes ``log1p``'s rational for |x| < sqrt(2) - 1, highest power first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
#: Giles' float32 erfinv, w < 5 and w >= 5, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _logf(x: np.ndarray) -> np.ndarray:
    """Cephes ``logf`` in float32 for x > 0."""
    x = np.maximum(x, np.uint32(0x00800000).view(_F32)).astype(_F32)
    bits = x.view(np.uint32)
    e = (_F32(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F)
         .astype(_F32)).astype(_F32)
    t = ((bits & np.uint32(0x807FFFFF)) | _F32(0.5).view(np.uint32)) \
        .view(_F32)
    small = t < _F32(0.707106781186547524)
    t1 = np.where(small, t, _F32(0))
    t = (t - _F32(1)).astype(_F32)
    e = (e - np.where(small, _F32(1), _F32(0))).astype(_F32)
    t = (t + t1).astype(_F32)
    x2 = (t * t).astype(_F32)
    x3 = (x2 * t).astype(_F32)
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, (_F32(-2.12194440e-4) * e).astype(_F32))
    t = (t - (_F32(0.5) * x2).astype(_F32)).astype(_F32)
    t = (t + y).astype(_F32)
    return (t + (_F32(0.693359375) * e).astype(_F32)).astype(_F32)


def _horner(coefs, x: np.ndarray) -> np.ndarray:
    r = np.zeros_like(x)
    for c in coefs:
        r = _fma(r, x, _F32(c))
    return r


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU ``log1p`` in float32."""
    xs = (x * x).astype(_F32)
    small = (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)).astype(_F32)
    small = ((x * xs).astype(_F32) * small).astype(_F32)
    small = ((_F32(-0.5) * xs).astype(_F32) + small).astype(_F32)
    small = (x + small).astype(_F32)
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    _logf((x + _F32(1)).astype(_F32)))


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on the CPU (Giles' polynomial)."""
    x = np.asarray(x, _F32)
    w = -_log1p((x * -x).astype(_F32))
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0)).astype(_F32)
    p = np.zeros_like(x)
    for lo, hi in zip(_ERFINV_LT5, _ERFINV_GE5):
        p = _fma(p, w, np.where(lt, _F32(lo), _F32(hi)))
    with np.errstate(over="ignore"):
        return np.where(np.abs(x) == _F32(1), x * _F32(np.inf),
                        (p * x).astype(_F32)).astype(_F32)


def normal(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.key(seed), shape, jnp.float32)``."""
    return (_F32(math.sqrt(2)) * erf_inv(uniform(seed, shape))) \
        .astype(_F32)
