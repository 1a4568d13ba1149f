"""JAX's default random numbers (threefry2x32) in numpy, on the host.

The JAX package's sampled-softmax loss (`models/bert4rec.py`) draws its
shared negatives with `jax.random.randint(fold_in(key(0), seed), ...)`;
the port must draw the same ones, so it keeps this copy of the generator.
It follows the layout JAX uses with `jax_threefry_partitionable=True` (the
default since jax 0.5): `split` and `random_bits` hash a 64-bit counter
over the output's flat index, split into two 32-bit words. A key is a
uint32[2] array, as `jax.random.key_data` gives it. All arithmetic is on
uint32 and wraps.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under key (k0, k1), as `jax._src.prng.threefry2x32_p` computes it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """`jax.random.key(seed)`'s data for a seed below 2^32: (0, seed)."""
    return np.array([0, seed], dtype=np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in`: the hash of the pair (0, data) under k."""
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32),
                          np.array([data], dtype=np.uint32))
    return np.array([y0[0], y1[0]], dtype=np.uint32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota 0 .. n-1 as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split` -> uint32[num, 2]."""
    y0, y1 = threefry2x32(k, *_counters(num))
    return np.stack([y0, y1], axis=1)


def random_bits(k: np.ndarray, n: int) -> np.ndarray:
    """n 32-bit words of `jax.random.bits(k, (n,), uint32)`."""
    y0, y1 = threefry2x32(k, *_counters(n))
    return y0 ^ y1


def randint(k: np.ndarray, n: int, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(k, (n,), minval, maxval)` (int32, maxval within
    int32's range): two words a draw, folded into the span as JAX folds
    them (biased where the span is not a power of two, as there)."""
    k1, k2 = split(k)
    hi, lo = random_bits(k1, n), random_bits(k2, n)
    span = np.uint32(maxval - minval if maxval > minval else 1)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
