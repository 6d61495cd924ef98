// Access kernel: kmer id -> packed kmer, one thread per id.
//
// Replaces sshash_tpu/engine.py make_access (:1304) with _acc_resolve
// (:1272) and _acc_read_window (:1283), ops/packed.py read_kmers_at (:51)
// and mask_last_word (:24), and the shard bodies of
// sshash_tpu/parallel/sharded.py make_sharded_access (:228). Plain
// versions: sshash_tpu_torch/engine.py access_plain and access_read_plain.
//
// Per id: one acc_rows row (row id >> 5, clipped as jnp.take clips) ->
// string id = the row's hint plus the C row entries <= id -> char offset
// off = id + sid*(k-1) -> the kmer at off. In the windowed form (1+C+Wa <=
// 16 words) the row holds every char its block's accesses read, and the
// kmer is a word select and funnel shift inside the row; in the two-round
// form (wide k, or short strings where C is large) the kmer is W+1 words of
// strings32 read at off. Widths 1..8 are templates; 9..16 words (k <= 255)
// run the wide form of packed.cuh.
//
// Bound: dependent random reads of device memory: one row of at most 64
// bytes per id (the windowed form), or the row and then a strings32 read
// (the two-round form); the arithmetic is a few u32 adds and shifts. Two
// dependent trips a lane: the hint and the C crossings, then the W + 1
// words of the kmer's read at the offset they give (in the row's window,
// or in strings32). Kmers of up to 4 words (k <= 63; access_kernel) read
// both in place, 4 bytes at a time through L1, which keeps the row's
// sectors between the trips; kmers of 5 or more words
// (access_staged_kernel) stage each trip's words into the thread's slot
// of shared memory with 16-byte loads of the aligned
// segments that cover them (stage.cuh), every load issued before the first
// use: 2 to 5 loads for a window read that takes 6 to 17 in place. Staging
// at 1..4 words measured slower on the H100 (PERF.md; access_chain_ab.py
// times both): the slots' shared memory takes L1 capacity the in-place
// trips hit in, and fewer warps fit (40 registers against 32).
// For random ids a lane's row spans 2 sectors, so the floor is the sectors
// the lanes touch, not each distinct row once. Kmers of 2 and 4 words
// leave with one vector store.
//
// Arithmetic is u32 and wraps as the JAX program's does. The row-relative
// char position local = off - (o_min & ~15) is below 31 + C*(k-1) + 16 for
// every id, garbage ids included, so the windowed form's 2*local never
// wraps. The two-round form clips its strings32 reads to the last word, so
// every lane reads in bounds; JAX's gather there fills, so ids past
// num_kmers may decode differently (both are meaningless).
//
// Bucket shards (sshash_tpu/parallel/sharded.py make_sharded_access): a
// shard holds the access rows of id blocks [blk_lo, blk_hi) and the
// strings32 words [word_lo, word_hi) plus a halo of W + 1 words. A lane
// whose block is not the shard's writes zeros. The two-round form splits
// in two launches of this kernel: with off_out the block's owner writes the
// char offset (0xFFFFFFFF elsewhere) and reads no string; the caller takes
// the unsigned min over the shards; with `offsets` the owner of the char's
// word reads the kmer from its slice. An unsharded call passes whole
// ranges.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"
#include "stage.cuh"
#include "tables.cuh"

namespace sshash {

constexpr uint32_t kNoOffset = 0xFFFFFFFFu;

// Mirrored by the ctypes Structure in sshash_tpu_torch/kernels.py (8-byte
// fields only, so neither side pads).
struct AccessParams {
  int64_t B, W, k, C, windowed, win_words, row_w, rows_n, strings_n;
  int64_t blk_lo, blk_hi, word_lo, word_hi;  // this shard's id blocks and string words
};

// Words of a thread's slot: the row head it stages (the hint and the C
// crossings), then the W + 1 words of the kmer's read (of the row's
// window, or of strings32 in the two-round form).
__host__ __device__ __forceinline__ int access_stride(const AccessParams& p) {
  return stage_stride(p.C > p.W ? 1 + (int)p.C : 1 + (int)p.W);
}

// Segments a row head of 1 + C <= 32 words takes.
constexpr int kHeadSegments = (32 + 6) >> 2;

// Kmers of this many words or more read through shared-memory slots;
// fewer read in place (see the top of the file).
constexpr int kStagedW = 5;

// The kmer of k chars (nw words) at char offset off of strings32: its nw+1
// words, each index clipped to the last word, read in place.
template <int W>
__device__ __forceinline__ void read_at(const uint32_t* __restrict__ strings32, int64_t n,
                                        uint32_t off, int k, int nw, uint32_t (&km)[W]) {
  const int64_t w0 = off >> 4, last = n - 1;
  const uint32_t b = 2u * (off & 15u);
  uint32_t a = strings32[w0 < last ? w0 : last];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j >= nw) break;
    const int64_t wj = w0 + j + 1;
    const uint32_t c = strings32[wj < last ? wj : last];
    km[j] = b ? (a >> b) | (c << (32 - b)) : a;
    a = c;
  }
  mask_last_word(km, k, nw);
}

// read_at from the words staged into slot: the segments that cover the
// clipped range.
template <int W>
__device__ __forceinline__ void read_at_staged(const uint32_t* __restrict__ strings32, int64_t n,
                                               uint32_t off, int k, int nw, uint32_t* slot,
                                               uint32_t (&km)[W]) {
  const int64_t w0 = off >> 4, last = n - 1;
  const int64_t a = w0 < last ? w0 : last;
  const int64_t e = w0 + nw < last ? w0 + nw : last;
  const uint32_t* v = stage_head<((W + 7) >> 2)>(strings32 + a, (int)(e - a) + 1, slot);
  const uint32_t b = 2u * (off & 15u);
  uint32_t x = v[0];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j >= nw) break;
    const int64_t wj = w0 + j + 1;
    const uint32_t c = v[(wj < last ? wj : last) - a];
    km[j] = b ? (x >> b) | (c << (32 - b)) : x;
    x = c;
  }
  mask_last_word(km, k, nw);
}

// The kmer at bit offset bitpos of a row's window of nwin words, as
// extract_kmer_dyn reads it (words past the window read 0), from the words
// it reads staged into slot.
template <int W>
__device__ __forceinline__ void read_window_staged(const uint32_t* win, int nwin, uint32_t bitpos,
                                                   int k, int nw, uint32_t* slot,
                                                   uint32_t (&km)[W]) {
  const int w0 = start_word(bitpos, nwin, nwin - 1);
  const int e = w0 + nw < nwin ? w0 + nw : nwin - 1;
  const uint32_t* v = stage_head<((W + 7) >> 2)>(win + w0, e - w0 + 1, slot);
  const uint32_t b = bitpos & 31u;
  uint32_t x = v[0];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j >= nw) break;
    const int wj = w0 + j + 1;
    const uint32_t c = wj <= e ? v[wj - w0] : 0u;
    km[j] = b ? (x >> b) | (c << (32 - b)) : x;
    x = c;
  }
  mask_last_word(km, k, nw);
}

// The string of id from its row: the hint plus the crossings <= id.
__device__ __forceinline__ uint32_t row_string(const uint32_t* row, int C, uint32_t id) {
  uint32_t cross = 0;
  for (int c = 0; c < C; ++c) cross += id >= row[1 + c] ? 1u : 0u;
  return row[0] + cross;
}

// One row of the (B, W) output; kmers of 2 and 4 words in one vector store
// where the output is aligned for it.
template <int W>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ out, int64_t i, int nw,
                                          const uint32_t (&km)[W]) {
  if constexpr (W == 2 || W == 4) {
    if ((reinterpret_cast<uintptr_t>(out) & (4 * W - 1)) == 0) {
      if constexpr (W == 2)
        reinterpret_cast<uint2*>(out)[i] = make_uint2(km[0], km[1]);
      else
        reinterpret_cast<uint4*>(out)[i] = make_uint4(km[0], km[1], km[2], km[3]);
      return;
    }
  }
  store_kmer(out, i, nw, km);
}

// Kmers of up to 4 words: in place, no launch bounds (ptxas takes 32
// registers, every thread the SM holds; asked for 256-thread blocks it
// takes 40, and 6 blocks fit).
template <int W>
__global__ void access_kernel(const uint32_t* __restrict__ acc_rows,
                              const uint32_t* __restrict__ strings32, AccessParams p,
                              const uint32_t* __restrict__ ids,
                              const uint32_t* __restrict__ offsets, uint32_t* __restrict__ out,
                              uint32_t* __restrict__ off_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  const int nw = used_words<W>(p.W);
  uint32_t km[W];
#pragma unroll
  for (int w = 0; w < W; ++w) km[w] = 0;
  if (offsets) {
    // second round: the owner of the char's word reads from its slice
    const uint32_t o = offsets[i];
    const int64_t w0 = o >> 4;
    if (o != kNoOffset && w0 >= p.word_lo && w0 < p.word_hi)
      read_at(strings32, p.strings_n, o - 16u * (uint32_t)p.word_lo, (int)p.k, nw, km);
  } else {
    const uint32_t id = ids[i];
    const int64_t blk = id >> 5;
    uint32_t off = kNoOffset;
    if (blk >= p.blk_lo && blk < p.blk_hi) {
      const uint32_t km1 = (uint32_t)(p.k - 1);
      const uint32_t* row = acc_rows + clip_row((uint32_t)(blk - p.blk_lo), p.rows_n) * p.row_w;
      const uint32_t hint = row[0];
      uint32_t cross = 0;
      for (int c = 0; c < (int)p.C; ++c) cross += id >= row[1 + c] ? 1u : 0u;
      off = id + (hint + cross) * km1;
      if (!off_out && p.windowed) {
        const uint32_t o_min = (id & ~31u) + hint * km1;
        const uint32_t local = off - (o_min & ~15u);
        const int nwin = (int)p.win_words;
        extract_kmer_dyn(row + 1 + p.C, nwin, 2u * local, (int)p.k, nwin - 1, nw, km);
      } else if (!off_out) {
        read_at(strings32, p.strings_n, off, (int)p.k, nw, km);
      }
    }
    if (off_out) {
      off_out[i] = off;
      return;
    }
  }
  store_row(out, i, nw, km);
}

// 5 or more words: each trip's words staged into this thread's slot.
// Registers for 6 blocks of 256 threads an SM at widths 5..8, whose slots
// take 11-15 words a thread at C <= 3.
template <int W>
__global__ void __launch_bounds__(256, W <= kMaxFixedW ? 6 : 1)
    access_staged_kernel(const uint32_t* __restrict__ acc_rows,
                         const uint32_t* __restrict__ strings32, AccessParams p,
                         const uint32_t* __restrict__ ids, const uint32_t* __restrict__ offsets,
                         uint32_t* __restrict__ out, uint32_t* __restrict__ off_out) {
  extern __shared__ uint32_t stage[];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  uint32_t* slot = stage + threadIdx.x * access_stride(p);
  const int nw = used_words<W>(p.W);
  uint32_t km[W];
#pragma unroll
  for (int w = 0; w < W; ++w) km[w] = 0;
  if (offsets) {
    const uint32_t o = offsets[i];
    const int64_t w0 = o >> 4;
    if (o != kNoOffset && w0 >= p.word_lo && w0 < p.word_hi)
      read_at_staged(strings32, p.strings_n, o - 16u * (uint32_t)p.word_lo, (int)p.k, nw, slot,
                     km);
  } else {
    const uint32_t id = ids[i];
    const int64_t blk = id >> 5;
    uint32_t off = kNoOffset;
    if (blk >= p.blk_lo && blk < p.blk_hi) {
      const uint32_t km1 = (uint32_t)(p.k - 1);
      const int C = (int)p.C;
      const uint32_t* row = acc_rows + clip_row((uint32_t)(blk - p.blk_lo), p.rows_n) * p.row_w;
      const uint32_t* head = stage_head<kHeadSegments>(row, 1 + C, slot);
      off = id + row_string(head, C, id) * km1;
      if (!off_out && p.windowed) {
        // the window's words from floor(o_min / 16), o_min = 32 * blk + hint * (k - 1)
        const uint32_t o_min = (id & ~31u) + head[0] * km1;
        read_window_staged(row + 1 + C, (int)p.win_words, 2u * (off - (o_min & ~15u)), (int)p.k,
                           nw, slot, km);
      } else if (!off_out) {
        read_at_staged(strings32, p.strings_n, off, (int)p.k, nw, slot, km);
      }
    }
    if (off_out) {
      off_out[i] = off;
      return;
    }
  }
  store_row(out, i, nw, km);
}

// Shared memory a block of access_staged_kernel takes: its threads' slots.
inline size_t staged_smem(const AccessParams& p, int threads) {
  return (size_t)threads * access_stride(p) * 4;
}

template <int W>
cudaError_t launch_access(const uint32_t* acc_rows, const uint32_t* strings32,
                          const AccessParams& p, const uint32_t* ids, const uint32_t* offsets,
                          uint32_t* out, uint32_t* off_out, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((p.B + threads - 1) / threads);
  if constexpr (W < kStagedW)
    access_kernel<W><<<blocks, threads, 0, stream>>>(acc_rows, strings32, p, ids, offsets, out,
                                                     off_out);
  else
    access_staged_kernel<W><<<blocks, threads, staged_smem(p, threads), stream>>>(
        acc_rows, strings32, p, ids, offsets, out, off_out);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes: ids -> kmers (or, with off_out, char offsets), or
// with offsets instead of ids the second round. Returns the launch's
// cudaError_t (0 on success).
extern "C" int sshash_access(const void* acc_rows, const void* strings32,
                             const sshash::AccessParams* p, const void* ids, const void* offsets,
                             void* out, void* off_out, void* stream) {
  using namespace sshash;
  if (p->B <= 0) return (int)cudaGetLastError();
  if (p->k < 1 || p->k > kMaxK || p->W != (2 * p->k + 31) / 32 || p->C < 1 || p->rows_n < 1 ||
      p->strings_n < 1 || p->row_w != 1 + p->C + (p->windowed ? p->win_words : 0) ||
      !ids == !offsets || (off_out && (offsets || p->windowed)) ||
      (offsets && p->windowed) || (!off_out && !out) || p->blk_lo < 0 || p->word_lo < 0 ||
      p->C > 31 || (p->windowed && p->row_w > 16))
    return (int)cudaErrorInvalidValue;
  auto r = (const uint32_t*)acc_rows;
  auto s = (const uint32_t*)strings32;
  auto d = (const uint32_t*)ids;
  auto f = (const uint32_t*)offsets;
  auto o = (uint32_t*)out;
  auto fo = (uint32_t*)off_out;
  auto st = (cudaStream_t)stream;
  return (int)dispatch_width(p->W, [&](auto w) {
    return launch_access<decltype(w)::value>(r, s, *p, d, f, o, fo, st);
  });
}

// C entry for ctypes: resident blocks an SM of the access kernel for these
// parameters, and the threads a block: the occupancy that the registers
// and the slots allow.
extern "C" int sshash_access_occupancy(const sshash::AccessParams* p, int* blocks_per_sm,
                                       int* threads) {
  using namespace sshash;
  *threads = 256;
  return (int)dispatch_width(p->W, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if constexpr (W < kStagedW)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, access_kernel<W>,
                                                           *threads, 0);
    else
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, access_staged_kernel<W>, *threads, staged_smem(*p, *threads));
  });
}
