"""``jax.random``'s draws in numpy, for the few constants the JAX package
makes from a fixed key (the perceptual proxy's weights,
``tha4_tpu/utils/fidelity.py:217-233``), so that the port makes the same ones
without JAX.

  * ``prng_key(seed)``: ``jax.random.PRNGKey`` of a 32-bit seed, (0, seed).
  * ``split(key, n)`` and ``bits(key, shape)``: the partitionable threefry
    scheme (``jax_threefry_partitionable``, on by default since jax 0.5):
    element i of a draw is threefry2x32(key, (hi, lo) of i), the two words
    xored for 32-bit bits, kept as a pair for a split's keys.
  * ``uniform`` and ``normal``: JAX's float construction from the bits
    (the 23 high bits as a mantissa in [1, 2)), then ``sqrt(2) *
    erf_inv(u)`` with XLA's f32 ``erf_inv``: Giles' single-precision
    polynomial, each step one fused multiply-add, over XLA's ``log1p``
    (a Cephes rational for |x| < sqrt(2) - 1, Cephes' ``logf`` of 1 + x
    beyond).

The bits and the uniforms equal JAX's exactly.  The normals differ by a few
ulp where the large-argument ``log1p`` rounds differently from XLA's
(``tests/test_torch_fidelity.py`` holds them).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]
_F = np.float32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as ``jax.random``'s."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Key:
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def _counts(n: int) -> Tuple[np.ndarray, np.ndarray]:
    if n >= 2 ** 32:
        raise ValueError("draws of 2^32 elements or more are not reproduced")
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(key: Key, n: int = 2) -> List[Key]:
    b0, b1 = threefry2x32(key, *_counts(n))
    return [(b0[i], b1[i]) for i in range(n)]


def bits(key: Key, shape) -> np.ndarray:
    b0, b1 = threefry2x32(key, *_counts(int(np.prod(shape))))
    return (b0 ^ b1).reshape(shape)


def uniform(key: Key, shape, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform`` in f32."""
    lo, hi = _F(minval), _F(maxval)
    floats = ((bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F) - _F(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to f32 (exact in f64 for f32 operands)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(_F)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F(c))
    return p


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _logf(v: np.ndarray) -> np.ndarray:
    """Cephes' single-precision log, for v > 0."""
    v = np.maximum(v, _F(1.17549435e-38)).astype(_F)
    raw = v.view(np.int32)
    m = ((raw & ~0x7F800000) | 0x3F000000).view(_F)
    e = ((raw >> 23) - 0x7F).astype(_F) + _F(1.0)
    below = m < _F(0.707106781186547524)
    m = (m - _F(1.0)) + np.where(below, m, _F(0.0)).astype(_F)
    e = e - np.where(below, _F(1.0), _F(0.0)).astype(_F)
    z = m * m
    y = np.full_like(m, _F(_LOG_P[0]))
    for c in _LOG_P[1:]:
        y = _fma(y, m, _F(c))
    y = y * m * z
    y = _fma(e, _F(-2.12194440e-4), y)
    y = _fma(z, _F(-0.5), y)
    return _fma(e, _F(0.693359375), m + y)


def _log1p(x: np.ndarray) -> np.ndarray:
    x2 = x * x
    small = x * x2 * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(_F(-0.5), x2, small)
    return np.where(np.abs(x) < _F(0.41421356237309504880), small, _logf(_F(1.0) + x)).astype(_F)


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv`` (Giles 2010) for |x| < 1."""
    x = np.asarray(x, _F)
    w = -_log1p(-x * x)
    small = w < _F(5.0)
    w = np.where(small, w - _F(2.5), np.sqrt(w) - _F(3.0)).astype(_F)
    p = np.where(small, _F(_ERFINV_SMALL[0]), _F(_ERFINV_LARGE[0])).astype(_F)
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(small, _F(a), _F(b)))
    return p * x


def normal(key: Key, shape) -> np.ndarray:
    """``jax.random.normal`` in f32."""
    u = uniform(key, shape, np.nextafter(_F(-1.0), _F(0.0)), 1.0)
    return _F(np.sqrt(2)) * erf_inv(u)
