// Packed 2-bit string algebra for one query lane.
//
// Device counterparts of sshash_tpu/ops/packed.py. A kmer is up to 16
// uint32 words (k <= 255), char j at word j / 16, bit 2 * (j % 16), held
// in a per-lane word array.
//
// Widths: a kernel is a template on its array width W. W = 1..kMaxFixedW
// are instantiated one by one, and their arrays stay in registers; one
// runtime-width form, W = kWideW, serves 9..16 words, with `nw` (the words
// the kmer uses) read at run time. Its arrays may live in local memory.
// Every helper takes nw beside the array; a fixed-width instantiation
// passes nw == W, and the compiler folds the checks away. Words past nw
// are zero.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace sshash {

constexpr int kMaxFixedW = 8;
constexpr int kWideW = 16;
constexpr int kMaxK = 16 * kWideW - 1;  // 255 chars; layout.MAX_K

// Words a kernel instantiated at width W uses for a kmer of nw words.
template <int W>
__device__ __forceinline__ int used_words(int64_t nw) {
  return W <= kMaxFixedW ? W : (int)nw;
}

// f(std::integral_constant<int, W>) for the kernel width that serves a
// kmer of nw words: nw itself up to kMaxFixedW, else the wide form.
template <typename F>
cudaError_t dispatch_width(int64_t nw, F&& f) {
  switch (nw) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  if (nw > kMaxFixedW && nw <= kWideW) return f(std::integral_constant<int, kWideW>{});
  return cudaErrorInvalidValue;
}

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

__device__ __forceinline__ uint32_t last_word_mask(int k, int nw) {
  int rem = 2 * k - 32 * (nw - 1);
  return rem == 32 ? 0xFFFFFFFFu : ((1u << rem) - 1u);
}

// Mask word nw-1 of x to the kmer's last chars.
template <int W>
__device__ __forceinline__ void mask_last_word(uint32_t (&x)[W], int k, int nw) {
  const uint32_t mask = last_word_mask(k, nw);
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j == nw - 1) x[j] &= mask;
}

// Load the kmer of row i of a (B, nw) array; words past nw are zero.
template <int W>
__device__ __forceinline__ void load_kmer(const uint32_t* __restrict__ rows, int64_t i, int nw,
                                          uint32_t (&x)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = j < nw ? rows[i * nw + j] : 0u;
}

template <int W>
__device__ __forceinline__ void store_kmer(uint32_t* __restrict__ rows, int64_t i, int nw,
                                           const uint32_t (&x)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j < nw) rows[i * nw + j] = x[j];
}

// Threads of a block that writes its kmer rows through store_rows.
constexpr int kRowThreads = 256;

// Widths whose row is one or two 4-, 8- or 16-byte vectors.
template <int W>
constexpr bool kVectorRow = W == 1 || W == 2 || W == 4 || W == 8;

// Shared memory of store_rows at width W: 32 rows for each warp of a block,
// 16-byte aligned (a placeholder at the widths stored as vectors).
template <int W>
struct RowStage {
  uint4 v[kVectorRow<W> ? 1 : (kRowThreads * W + 3) / 4];
};

// The rows row0 .. row0 + n - 1 (n <= 32) of a (B, nw) array that starts
// 16-byte aligned, lane t of a warp holding row row0 + t (`have`: t < n),
// written so that each store instruction of the warp covers contiguous
// bytes. At 1, 2, 4 and 8 words a row goes out as one or two vectors,
// neighbouring lanes on neighbouring addresses. At the other widths (3,
// 5-7 and the runtime-width form) each lane puts its row into the warp's
// slice of the stage, then the warp writes the n * nw words out as
// 16-byte vectors, and the last n * nw % 4 a word a lane. (A lane storing
// its nw words one by one makes each store instruction a set of words at
// a stride of 4nw bytes.) Every lane of the warp calls it with the same
// row0 and n; only the warp waits (__syncwarp), so no block barrier holds
// the warps back for the slowest one's loads, and no register stays live
// across one.
template <int W>
__device__ __forceinline__ void store_rows(uint32_t* __restrict__ rows, int64_t row0, int n,
                                           int nw, bool have, const uint32_t (&x)[W],
                                           RowStage<W>& stage) {
  const int lane = threadIdx.x & 31;
  if constexpr (kVectorRow<W>) {
    if (!have) return;
    uint32_t* dst = rows + (row0 + lane) * W;
    if constexpr (W == 1) {
      *dst = x[0];
    } else if constexpr (W == 2) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(x[0], x[1]);
    } else {
#pragma unroll
      for (int j = 0; j < W; j += 4)
        reinterpret_cast<uint4*>(dst)[j / 4] = make_uint4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    }
  } else {
    uint32_t* s = reinterpret_cast<uint32_t*>(stage.v) + (threadIdx.x >> 5) * 32 * nw;
    if (have) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (j < nw) s[lane * nw + j] = x[j];
    }
    __syncwarp();
    const int total = n * nw;
    uint32_t* dst = rows + row0 * nw;
    int i = lane;
    if (((uintptr_t)dst & 15) == 0) {  // the warp's slice starts 16-byte aligned too
      for (; i < total / 4; i += 32)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(s)[i];
      i = total / 4 * 4 + lane;
    }
    for (; i < total; i += 32) dst[i] = s[i];
    __syncwarp();
  }
}

// Reverse complement of a k-char kmer of nw words (revcomp_kmers): word i
// of the reversal is the RC of word nw-1-i, then the 32*nw - 2k bits past
// the kmer's end (the complements of the zero padding) shift out. The word
// select runs over every pair of array slots, so the indices stay
// compile-time and the arrays stay in registers at fixed widths.
template <int W>
__device__ __forceinline__ void revcomp_words(const uint32_t (&km)[W], int k, int nw,
                                              uint32_t (&rc)[W]) {
  uint32_t rev[W + 1];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t x = 0u;
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (j == nw - 1 - i) x = km[j];
    rev[i] = i < nw ? crc32_word(x) : 0u;
  }
  rev[W] = 0u;
  const uint32_t s = 32u * nw - 2u * k;  // 0..30
#pragma unroll
  for (int i = 0; i < W; ++i) rc[i] = s ? (rev[i] >> s) | (rev[i + 1] << (32 - s)) : rev[i];
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

// The k-char kmer of nw words at a per-lane bit offset of a window
// (extract_kmer_dyn).
template <int W>
__device__ __forceinline__ void extract_kmer_dyn(const uint32_t* win, int nwin, uint32_t bitpos,
                                                 int k, int max_start_word, int nw,
                                                 uint32_t (&out)[W]) {
  int w0 = start_word(bitpos, nwin, max_start_word);
  uint32_t b = bitpos & 31u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    out[j] = 0u;
    if (j < nw) {
      uint32_t a = win_word(win, nwin, w0 + j), c = win_word(win, nwin, w0 + j + 1);
      out[j] = b ? (a >> b) | (c << (32 - b)) : a;
    }
  }
  mask_last_word(out, k, nw);
}

template <int W>
__device__ __forceinline__ bool kmer_equal(const uint32_t (&a)[W], const uint32_t (&b)[W]) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < W; ++i) eq &= a[i] == b[i];
  return eq;
}

// uint_kmer_t::operator<: integer compare, the last word most significant
// (words past nw are zero in both).
template <int W>
__device__ __forceinline__ bool kmer_less(const uint32_t (&a)[W], const uint32_t (&b)[W]) {
#pragma unroll
  for (int i = W - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] < b[i];
  }
  return false;
}

}  // namespace sshash
