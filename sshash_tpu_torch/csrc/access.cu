// Access kernel: kmer id -> packed kmer, one thread per id.
//
// Replaces sshash_tpu/engine.py make_access (:1304) with _acc_resolve
// (:1272) and _acc_read_window (:1283), and ops/packed.py read_kmers_at
// (:51) and mask_last_word (:24). Plain version:
// sshash_tpu_torch/engine.py access_plain.
//
// Per id: one acc_rows row (row id >> 5, clipped as jnp.take clips) ->
// string id = the row's hint plus the C row entries <= id -> char offset
// off = id + sid*(k-1) -> the kmer at off. In the windowed form (1+C+Wa <=
// 16 words) the row holds every char its block's accesses read, and the
// kmer is a word select and funnel shift inside the row; in the two-round
// form (wide k, or short strings where C is large) the kmer is W+1 words of
// strings32 read at off.
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
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"
#include "tables.cuh"

namespace sshash {

// Mirrored by the ctypes Structure in sshash_tpu_torch/kernels.py (8-byte
// fields only, so neither side pads).
struct AccessParams {
  int64_t B, W, k, C, windowed, win_words, row_w, rows_n, strings_n;
};

template <int W>
__global__ void access_kernel(const uint32_t* __restrict__ acc_rows,
                              const uint32_t* __restrict__ strings32, AccessParams p,
                              const uint32_t* __restrict__ ids, uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  const uint32_t id = ids[i];
  const uint32_t km1 = (uint32_t)(p.k - 1);
  const uint32_t* row = acc_rows + clip_row(id >> 5, p.rows_n) * p.row_w;
  const uint32_t hint = row[0];
  uint32_t cross = 0;
  for (int c = 0; c < (int)p.C; ++c) cross += id >= row[1 + c] ? 1u : 0u;
  const uint32_t off = id + (hint + cross) * km1;
  uint32_t km[W];
  if (p.windowed) {
    const uint32_t o_min = (id & ~31u) + hint * km1;
    const uint32_t local = off - (o_min & ~15u);
    const int nwin = (int)p.win_words;
    extract_kmer_dyn(row + 1 + p.C, nwin, 2u * local, (int)p.k, nwin - 1, km);
  } else {
    const int64_t w0 = off >> 4, last = p.strings_n - 1;
    const uint32_t b = 2u * (off & 15u);
    uint32_t a = strings32[w0 < last ? w0 : last];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int64_t wj = w0 + j + 1;
      const uint32_t c = strings32[wj < last ? wj : last];
      km[j] = b ? (a >> b) | (c << (32 - b)) : a;
      a = c;
    }
    km[W - 1] &= last_word_mask((int)p.k, W);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) out[i * W + w] = km[w];
}

template <int W>
cudaError_t launch_access(const uint32_t* acc_rows, const uint32_t* strings32,
                          const AccessParams& p, const uint32_t* ids, uint32_t* out,
                          cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((p.B + threads - 1) / threads);
  access_kernel<W><<<blocks, threads, 0, stream>>>(acc_rows, strings32, p, ids, out);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes. Returns the launch's cudaError_t (0 on success).
extern "C" int sshash_access(const void* acc_rows, const void* strings32,
                             const sshash::AccessParams* p, const void* ids, void* out,
                             void* stream) {
  using namespace sshash;
  if (p->B <= 0) return (int)cudaGetLastError();
  if (p->k < 1 || p->k > 63 || p->W != (2 * p->k + 31) / 32 || p->C < 1 || p->rows_n < 1 ||
      p->strings_n < 1 || p->row_w != 1 + p->C + (p->windowed ? p->win_words : 0))
    return (int)cudaErrorInvalidValue;
  auto r = (const uint32_t*)acc_rows;
  auto s = (const uint32_t*)strings32;
  auto d = (const uint32_t*)ids;
  auto o = (uint32_t*)out;
  auto st = (cudaStream_t)stream;
  switch (p->W) {
    case 1: return (int)launch_access<1>(r, s, *p, d, o, st);
    case 2: return (int)launch_access<2>(r, s, *p, d, o, st);
    case 3: return (int)launch_access<3>(r, s, *p, d, o, st);
    case 4: return (int)launch_access<4>(r, s, *p, d, o, st);
  }
  return (int)cudaErrorInvalidValue;
}
