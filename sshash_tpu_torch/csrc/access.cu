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
// (the two-round form); the arithmetic is a few u32 adds and shifts. The
// design reads each row word from global memory as it needs it (through
// L1), so no row array lives in registers or local memory, and writes
// nothing but the kmer.
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
#include "tables.cuh"

namespace sshash {

constexpr uint32_t kNoOffset = 0xFFFFFFFFu;

// Mirrored by the ctypes Structure in sshash_tpu_torch/kernels.py (8-byte
// fields only, so neither side pads).
struct AccessParams {
  int64_t B, W, k, C, windowed, win_words, row_w, rows_n, strings_n;
  int64_t blk_lo, blk_hi, word_lo, word_hi;  // this shard's id blocks and string words
};

// The kmer of k chars (nw words) at char offset off of strings32: nw+1
// words, reads clipped to the last word.
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
  store_kmer(out, i, nw, km);
}

template <int W>
cudaError_t launch_access(const uint32_t* acc_rows, const uint32_t* strings32,
                          const AccessParams& p, const uint32_t* ids, const uint32_t* offsets,
                          uint32_t* out, uint32_t* off_out, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((p.B + threads - 1) / threads);
  access_kernel<W><<<blocks, threads, 0, stream>>>(acc_rows, strings32, p, ids, offsets, out,
                                                   off_out);
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
      (offsets && p->windowed) || (!off_out && !out) || p->blk_lo < 0 || p->word_lo < 0)
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

