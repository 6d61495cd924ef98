"""64-bit integer arithmetic as (hi, lo) pairs of 32-bit values in int64.

Plain PyTorch counterpart of sshash_tpu/ops/u64.py. PyTorch's CPU backend
has no shifts, adds or comparisons on uint32/uint64, so a u32 value lives in
an int64 tensor (0 <= v < 2^32) and a u64 value is a `u64(hi, lo)` pair of
such tensors. Every shift and multiply is masked back to 32 bits, and every
product stays below 2^63 (16-bit limbs), so the arithmetic is exact on any
device. These functions are the plain versions that the CUDA kernels'
device functions (csrc/u64.cuh) are held against; they are bit-identical
to sshash_tpu/hashing.py.
"""

from typing import NamedTuple

import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF

MIXER_MULT = 0x517CC1B727220A95  # hashing.MIXER_MULT
SPLIT_C1 = 0xBF58476D1CE4E5B9
SPLIT_C2 = 0x94D049BB133111EB
GOLDEN = 0x9E3779B97F4A7C15
FMIX32_C1 = 0x85EBCA6B
FMIX32_C2 = 0xC2B2AE35


class u64(NamedTuple):
    """A 64-bit value as two int64 tensors holding its 32-bit halves."""

    hi: torch.Tensor
    lo: torch.Tensor


def u32(x):
    """int32 tensor of u32 bits (or any int tensor) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & M32


def to_i32(x):
    """int64 in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def const64(v, like):
    """Python int -> u64 of scalar int64 tensors on `like`'s device."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    t = lambda x: torch.tensor(x, dtype=torch.int64, device=like.device)  # noqa: E731
    return u64(t(v >> 32), t(v & M32))


def from_i64(x):
    """Non-negative int64 (< 2^63) -> u64 pair."""
    return u64(x >> 32, x & M32)


def to_i64(a):
    """u64 pair whose value is < 2^63 -> int64."""
    return (a.hi << 32) | a.lo


def xor(a, b):
    return u64(a.hi ^ b.hi, a.lo ^ b.lo)


def add(a, b):
    lo = a.lo + b.lo
    return u64((a.hi + b.hi + (lo >> 32)) & M32, lo & M32)


def shr(a, s):
    """Right shift by a constant s in [0, 64)."""
    if s == 0:
        return a
    if s < 32:
        return u64(a.hi >> s, ((a.lo >> s) | (a.hi << (32 - s))) & M32)
    return u64(torch.zeros_like(a.hi), a.hi >> (s - 32))


def less(a, b):
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def equal(a, b):
    return (a.hi == b.hi) & (a.lo == b.lo)


def select(pred, a, b):
    return u64(torch.where(pred, a.hi, b.hi), torch.where(pred, a.lo, b.lo))


def mulhi32(a, b):
    """High 32 bits of the 32x32 -> 64 product. a*b = a1*b*2^16 + a0*b with
    16-bit a1, a0, so both partial products stay below 2^48."""
    return ((a >> 16) * b + (((a & M16) * b) >> 16)) >> 16


def mullo32(a, b):
    """(a * b) mod 2^32 from the same 16-bit limbs."""
    return (((((a >> 16) * b) & M16) << 16) + (a & M16) * b) & M32


def mul_const(a, c):
    """(a * c) mod 2^64 for a Python int constant c."""
    ch, cl = (c >> 32) & M32, c & M32
    lo = mullo32(a.lo, cl)
    hi = (mulhi32(a.lo, cl) + mullo32(a.lo, ch) + mullo32(a.hi, cl)) & M32
    return u64(hi, lo)


def splitmix64(x):
    """Matches hashing.splitmix64."""
    x = add(x, const64(GOLDEN, x.lo))
    x = mul_const(xor(x, shr(x, 30)), SPLIT_C1)
    x = mul_const(xor(x, shr(x, 27)), SPLIT_C2)
    return xor(x, shr(x, 31))


def mixer64(x, magic):
    """Matches hashing.mixer64: (x * C) ^ magic, magic a Python int."""
    return xor(mul_const(x, MIXER_MULT), const64(magic, x.lo))


def fmix32(x):
    """Matches hashing.fmix32 on u32 values held in int64."""
    x = x ^ (x >> 16)
    x = mullo32(x, FMIX32_C1)
    x = x ^ (x >> 13)
    x = mullo32(x, FMIX32_C2)
    return x ^ (x >> 16)


def hash64_u64(key, seed_mix):
    """Matches hashing.hash64_u64 given seed_mix = splitmix64(seed) (u64)."""
    return splitmix64(xor(key, seed_mix))


def hash64_words(words, seed_mix):
    """Matches hashing.hash64_words. words: (N, W) u32 values in int64;
    seed_mix: u64 broadcastable to (N,)."""
    n = words.shape[0]
    h = u64(seed_mix.hi.expand(n), seed_mix.lo.expand(n))
    for i in range(words.shape[1]):
        wi = add(u64(torch.zeros_like(words[:, i]), words[:, i]),
                 const64(i * GOLDEN, words))
        h = splitmix64(xor(h, wi))
    return h
