"""The JAX package's counter-based random draws, in numpy.

The experiments (`examples/`) draw a few deterministic inputs with the
JAX PRNG (e.g. the smooth phase field, `jax.random.normal(PRNGKey(seed +
3), (n, 5, 5, 1))`), and their zero-filled rows depend on them. This
module computes the same numbers without JAX: the Threefry-2x32 block
cipher (20 rounds, Salmon et al. 2011, as `jax._src.prng` implements
it), the partitionable bit layout (a draw's counter is its row-major
index as a 64-bit pair), JAX's float32 uniform from the top 23 bits, and
its normal as sqrt(2) erfinv(u), with erfinv the single-precision
polynomial of Giles (2010) that XLA evaluates.

Only the draws the experiments take are here: `prng_key(seed)` and
`normal(key, shape)` in float32. The samplers draw their noise from torch
generators instead.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> Tuple[int, int]:
    """jax.random.PRNGKey(seed) for the threefry2x32 implementation."""
    seed = int(seed)
    return ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 cipher of the counter pairs (x0, x1) under key."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """jax.random.bits(key, shape) as uint32, the partitionable layout."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: Tuple[int, int], shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    bits = random_bits(key, shape)
    one = np.float32(1.0).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv (Giles' single-precision polynomial)."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, np.float32(_ERFINV_SMALL[0]),
                 np.float32(_ERFINV_LARGE[0])).astype(np.float32)
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = (np.where(small, np.float32(a), np.float32(b)) + p * w
             ).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == 1, np.copysign(np.inf, x), out
                    ).astype(np.float32)


def normal(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """jax.random.normal(key, shape) in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
