"""Host-side (NumPy) hash functions.

The reference uses mixer_64 for minimizer selection (reference:
include/hash_util.hpp:84-108) and CityHash128/PTHash for the minimal perfect
hash layer. The *observable* dictionary contract (kmer ids assigned in input
file order, weights, membership) does not depend on the concrete hash family,
only on builder/query agreement — so this engine uses one TPU-friendly family
throughout (multiply-xor mixers built from 32-bit limbs), implemented
identically here (NumPy, 64-bit) and in `ops/u64.py` (JAX, (hi, lo) uint32
pairs).

All functions operate on / return np.uint64 arrays and rely on NumPy's
wrapping modular arithmetic.
"""

import functools

import numpy as np

U64 = np.uint64
U32 = np.uint32


def _wrapping(fn):
    """Silence NumPy overflow warnings: modular wraparound is intended."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)

    return inner

MIXER_MULT = U64(0x517CC1B727220A95)  # same multiplier as reference mixer_64 (hash_util.hpp:91)

_SPLIT_C1 = U64(0xBF58476D1CE4E5B9)
_SPLIT_C2 = U64(0x94D049BB133111EB)
_GOLDEN = U64(0x9E3779B97F4A7C15)

_FMIX32_C1 = U32(0x85EBCA6B)
_FMIX32_C2 = U32(0xC2B2AE35)


@_wrapping
def splitmix64(x):
    """splitmix64 finalizer: a cheap full-avalanche 64-bit mixer."""
    x = np.asarray(x, dtype=U64)
    x = (x + _GOLDEN) & U64(0xFFFFFFFFFFFFFFFF)
    x = (x ^ (x >> U64(30))) * _SPLIT_C1
    x = (x ^ (x >> U64(27))) * _SPLIT_C2
    return x ^ (x >> U64(31))


@_wrapping
def mixer_magic(seed):
    """Derive the mixer 'magic' xor-constant from the build seed.

    The reference derives it via xxhash64(seed) (hash_util.hpp:88); we use
    splitmix64 — internal-only difference, builder and query agree.
    """
    return splitmix64(U64(seed))


@_wrapping
def mixer64(x, magic):
    """Minimizer-ordering hash, same shape as reference mixer_64::hash
    (hash_util.hpp:91): (x * C) ^ magic."""
    x = np.asarray(x, dtype=U64)
    return (x * MIXER_MULT) ^ U64(magic)


@_wrapping
def fmix32(x):
    """murmur3 32-bit finalizer (public-domain construction)."""
    x = np.asarray(x, dtype=U32)
    x ^= x >> U32(16)
    x *= _FMIX32_C1
    x ^= x >> U32(13)
    x *= _FMIX32_C2
    x ^= x >> U32(16)
    return x


@_wrapping
def hash64_u64(keys, seed):
    """64-bit key hash used by the MPHF layer for minimizer (scalar) keys."""
    keys = np.asarray(keys, dtype=U64)
    return splitmix64(keys ^ splitmix64(U64(seed)))


@_wrapping
def hash64_words(words, seed):
    """64-bit hash of multi-word keys.

    `words` has shape (..., W) of uint32 (little-word-first packed kmers).
    Must match ops/u64.py:hash64_words bit-for-bit.
    """
    words = np.asarray(words, dtype=U32)
    h = np.broadcast_to(splitmix64(U64(seed)), words.shape[:-1]).copy()
    for i in range(words.shape[-1]):
        h = splitmix64(h ^ (words[..., i].astype(U64) + U64(i) * _GOLDEN))
    return h


@_wrapping
def mulhi32(a, b):
    """High 32 bits of the 32x32 product (NumPy: via uint64)."""
    return ((np.asarray(a, dtype=U64) * np.asarray(b, dtype=U64)) >> U64(32)).astype(U32)
