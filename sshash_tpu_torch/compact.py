"""Fixed-width / dictionary-coded compact integer vectors (host, NumPy).

The reference stores pilots, remaps, codewords and positions in succinct
structures (PTHash `compact`/`dictionary` encoders, bits::compact_vector —
reference include/minimizers_control_map.hpp, external/pthash). This module
is the NumPy equivalent used for the AT-REST and host-RAM representation;
the device engine expands what the hot path needs into uint32 arrays at
load (speed mode — see engine._device_arrays), so query latency never pays
for the packing.

Two codings, picked automatically per vector by actual size:
  * fixed:      ceil(log2(max+1)) bits per entry, little-endian bit stream
  * dictionary: distinct values (uint32) + fixed-width codes — wins when
                values are few/skewed (pilot distributions are)
"""

import numpy as np

U32 = np.uint32
U64 = np.uint64


def _pack_fixed(vals, width):
    """vals (int64 >= 0) -> little-endian bit-packed uint64 words."""
    n = len(vals)
    if n == 0 or width == 0:
        return np.zeros(1, dtype=U64)
    total_bits = n * width
    words = np.zeros((total_bits + 63) // 64 + 1, dtype=U64)
    bit = np.arange(n, dtype=np.int64) * width
    w = bit >> 6
    b = (bit & 63).astype(U64)
    v = vals.astype(U64)
    np.bitwise_or.at(words, w, (v << b) & U64(0xFFFFFFFFFFFFFFFF))
    spill = b.astype(np.int64) + width > 64
    if spill.any():
        np.bitwise_or.at(words, w[spill] + 1,
                         v[spill] >> (U64(64) - b[spill]))
    return words


def _unpack_fixed(words, width, idx):
    """Gather entries at idx (any int array) from the packed stream."""
    if width == 0:
        return np.zeros(np.shape(idx), dtype=np.int64)
    bit = np.asarray(idx, dtype=np.int64) * width
    w = bit >> 6
    b = (bit & 63).astype(U64)
    lo = np.take(words, w, mode="clip") >> b
    hi_w = np.take(words, np.minimum(w + 1, len(words) - 1), mode="clip")
    nz = b != 0
    hi = np.where(nz, hi_w << ((U64(64) - b) & U64(63)), U64(0))
    out = lo | hi
    mask = U64(0xFFFFFFFFFFFFFFFF) if width >= 64 else U64((1 << width) - 1)
    return (out & mask).astype(np.int64)


class CompactVector:
    """Immutable fixed-width or dictionary-coded uint vector."""

    __slots__ = ("n", "width", "words", "dictionary")

    def __init__(self, n, width, words, dictionary=None):
        self.n = int(n)
        self.width = int(width)
        self.words = words
        self.dictionary = dictionary  # None = fixed coding

    @classmethod
    def from_array(cls, arr):
        arr = np.asarray(arr)
        n = len(arr)
        if n == 0:
            return cls(0, 0, np.zeros(1, dtype=U64))
        v = arr.astype(np.int64)
        vmax = int(v.max())
        fixed_w = max(1, vmax.bit_length())
        distinct = np.unique(v)
        dict_w = max(1, (len(distinct) - 1).bit_length())
        # pick the smaller encoding (dictionary pays its table)
        fixed_bits = n * fixed_w
        dict_bits = n * dict_w + len(distinct) * 32
        if dict_bits < fixed_bits:
            codes = np.searchsorted(distinct, v)
            return cls(n, dict_w, _pack_fixed(codes, dict_w),
                       distinct.astype(U32))
        return cls(n, fixed_w, _pack_fixed(v, fixed_w))

    def get(self, idx):
        """Vectorized random access; returns int64 (non-negative values)."""
        raw = _unpack_fixed(self.words, self.width, idx)
        if self.dictionary is not None:
            return np.take(self.dictionary, raw, mode="clip").astype(np.int64)
        return raw

    def to_array(self, dtype=U32):
        return self.get(np.arange(self.n)).astype(dtype)

    def __len__(self):
        return self.n

    def __array__(self, dtype=None, copy=None):
        """Full expansion (uint64). Lets consumers that want the whole
        vector (engine load, tests) treat a CompactVector as an array;
        random-access consumers should use take() instead."""
        out = self.get(np.arange(self.n)).astype(U64)
        return out.astype(dtype) if dtype is not None else out

    @property
    def nbytes(self):
        d = self.dictionary.nbytes if self.dictionary is not None else 0
        return self.words.nbytes + d

    def num_bits(self):
        return 8 * self.nbytes + 2 * 64


def ef_encode(vals):
    """Elias-Fano code for a monotone non-decreasing uint64 sequence — the
    at-rest analog of the reference's EF-coded string/weight interval
    endpoints (reference include/offsets.hpp:115-155, weights.hpp:190,
    external/bits elias_fano). Returns (low_words, high_words, meta):
    low = n fixed-width(l) entries, high = unary-coded upper parts in a
    bitvector of n + (U >> l) bits; l = floor(log2(U / n)).

    Decode is a full sequential expansion (ef_decode) — the index loads
    endpoints back into plain arrays (the engine's speed mode); EF is the
    DISK format, not a random-access structure."""
    vals = np.asarray(vals, dtype=U64)
    n = len(vals)
    if n == 0:
        return np.zeros(1, dtype=U64), np.zeros(1, dtype=U64), {"n": 0, "l": 0}
    u = int(vals[-1]) + 1
    l = max(0, (u // n).bit_length() - 1)
    low = _pack_fixed((vals & U64((1 << l) - 1)).astype(np.int64), l)
    hi = (vals >> U64(l)).astype(np.int64) + np.arange(n, dtype=np.int64)
    high = np.zeros(int(hi[-1]) // 64 + 2, dtype=U64)
    np.bitwise_or.at(high, hi >> 6, U64(1) << (hi & 63).astype(U64))
    return low, high, {"n": n, "l": l}


def ef_decode(low, high, meta):
    """Inverse of ef_encode -> uint64 array."""
    n, l = int(meta["n"]), int(meta["l"])
    if n == 0:
        return np.zeros(0, dtype=U64)
    pos = np.flatnonzero(
        np.unpackbits(np.ascontiguousarray(high).view(np.uint8),
                      bitorder="little"))[:n]
    hi_vals = (pos - np.arange(n, dtype=np.int64)).astype(U64) << U64(l)
    lo_vals = _unpack_fixed(np.asarray(low), l, np.arange(n)).astype(U64)
    return hi_vals | lo_vals


def take(vec, idx, dtype=np.int64):
    """Random access on a CompactVector OR a plain array (clip semantics)."""
    if isinstance(vec, CompactVector):
        return vec.get(np.minimum(np.asarray(idx), max(0, vec.n - 1))).astype(dtype)
    return np.take(vec, idx, mode="clip").astype(dtype)
