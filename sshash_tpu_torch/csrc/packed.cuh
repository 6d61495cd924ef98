// Packed 2-bit string algebra for one query lane.
//
// Device counterparts of sshash_tpu/ops/packed.py. A kmer is W <= 4 uint32
// words, char j at word j / 16, bit 2 * (j % 16); held in registers either
// as the words or as one unsigned __int128 (char j at bit 2j).
#pragma once
#include <cstdint>

namespace sshash {

typedef unsigned __int128 u128;

// Reverse-complement the 16 chars of a uint32 / the 32 chars of a uint64:
// complement is xor 0b10 per char; bit reversal reverses the chars and the
// two bits inside each char, so the pairs are swapped back.
__device__ __forceinline__ uint32_t crc32_word(uint32_t x) {
  uint32_t r = __brev(x ^ 0xAAAAAAAAu);
  return ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
}

__device__ __forceinline__ uint64_t crc64_word(uint64_t x) {
  uint64_t r = __brevll(x ^ 0xAAAAAAAAAAAAAAAAull);
  return ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
}

// RC of an m-mer (m <= 31) packed in the low 2m bits.
__device__ __forceinline__ uint64_t revcomp_mmer64(uint64_t v, int m) {
  return crc64_word(v) >> (64 - 2 * m);
}

template <int W>
__device__ __forceinline__ u128 to_u128(const uint32_t (&w)[W]) {
  u128 x = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) x |= (u128)w[i] << (32 * i);
  return x;
}

template <int W>
__device__ __forceinline__ void from_u128(u128 x, uint32_t (&w)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = (uint32_t)(x >> (32 * i));
}

// Reverse complement of a k-char kmer: RC over all 128 bits, then drop the
// 128-2k low bits (the complements of chars k..63).
__device__ __forceinline__ u128 revcomp_kmer(u128 x, int k) {
  u128 r = ((u128)crc64_word((uint64_t)x) << 64) | crc64_word((uint64_t)(x >> 64));
  return r >> (128 - 2 * k);
}

__device__ __forceinline__ uint32_t last_word_mask(int k, int W) {
  int rem = 2 * k - 32 * (W - 1);
  return rem == 32 ? 0xFFFFFFFFu : ((1u << rem) - 1u);
}

// Word i of a window of n words, 0 past its end.
__device__ __forceinline__ uint32_t win_word(const uint32_t* win, int n, int i) {
  return i < n ? win[i] : 0u;
}

// Start word of an extraction at bit offset bitpos. The JAX select chain has
// variants for start words 0..max_start_word only, and falls back to word 0
// past them; for a real candidate the start word never exceeds the bound.
__device__ __forceinline__ int start_word(uint32_t bitpos, int nwin, int max_start_word) {
  uint32_t w0 = bitpos >> 5;
  uint32_t nvar = (uint32_t)min(nwin, max_start_word + 1);
  return w0 < nvar ? (int)w0 : 0;
}

// Up to 64 bits at a per-lane bit offset of a window (extract_window_dyn).
__device__ __forceinline__ uint64_t extract_window_dyn(const uint32_t* win, int nwin,
                                                       uint32_t bitpos, int width_bits,
                                                       int max_start_word) {
  int w0 = start_word(bitpos, nwin, max_start_word);
  uint32_t b = bitpos & 31u;
  uint32_t a0 = win_word(win, nwin, w0), a1 = win_word(win, nwin, w0 + 1);
  uint32_t a2 = win_word(win, nwin, w0 + 2);
  uint32_t lo = b ? (a0 >> b) | (a1 << (32 - b)) : a0;
  uint32_t hi = b ? (a1 >> b) | (a2 << (32 - b)) : a1;
  uint64_t v = ((uint64_t)hi << 32) | lo;
  return width_bits < 64 ? v & ((1ull << width_bits) - 1) : v;
}

// The k-char kmer at a per-lane bit offset of a window (extract_kmer_dyn).
template <int W>
__device__ __forceinline__ void extract_kmer_dyn(const uint32_t* win, int nwin, uint32_t bitpos,
                                                 int k, int max_start_word, uint32_t (&out)[W]) {
  int w0 = start_word(bitpos, nwin, max_start_word);
  uint32_t b = bitpos & 31u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint32_t a = win_word(win, nwin, w0 + j), c = win_word(win, nwin, w0 + j + 1);
    out[j] = b ? (a >> b) | (c << (32 - b)) : a;
  }
  out[W - 1] &= last_word_mask(k, W);
}

template <int W>
__device__ __forceinline__ bool kmer_equal(const uint32_t (&a)[W], const uint32_t (&b)[W]) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < W; ++i) eq &= a[i] == b[i];
  return eq;
}

// uint_kmer_t::operator<: integer compare, word W-1 most significant.
template <int W>
__device__ __forceinline__ bool kmer_less(const uint32_t (&a)[W], const uint32_t (&b)[W]) {
#pragma unroll
  for (int i = W - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] < b[i];
  }
  return false;
}

}  // namespace sshash
