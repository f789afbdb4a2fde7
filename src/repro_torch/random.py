"""Threefry-2x32 in numpy, bit-equal to the JAX PRNG the reference uses.

The reference draws one random integer per dedup call: the first
k-means++ centroid, ``jax.random.randint(PRNGKey(seed), (), 0, n)``
(``repro/core/dedup.py``). PyTorch's generators give other bits, so the
port reproduces JAX's draw exactly: ``PRNGKey`` seeding in 32-bit mode,
the partitionable ``split`` and ``random_bits`` (JAX's default since
``jax_threefry_partitionable=True``), and ``randint``'s double-width
modular reduction, all in uint32 wrap-around arithmetic.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash of counter words (x0, x1) under ``key``,
    20 rounds, as ``jax._src.prng._threefry2x32_lowering``."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed wraps
    to int32, the high word is 0 and the low word is the seed mod 2**32."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([b0, b1], axis=1)


def random_bits32(key) -> np.uint32:
    """One 32-bit draw of shape ``()``: both hash words of counter 0, XORed."""
    b0, b1 = threefry2x32(key, np.zeros((), _U32), np.zeros((), _U32))
    return _U32(b0 ^ b1)


def randint(seed: int, n: int, minval: int = 0) -> int:
    """``jax.random.randint(PRNGKey(seed), (), minval, n)`` (int32)."""
    k1, k2 = split(prng_key(seed))
    hi, lo = random_bits32(k1), random_bits32(k2)
    span = _U32(1) if n <= minval else _U32((n - minval) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        mult = _U32(1 << 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + (lo % span)) % span
    return int(minval + int(off))
