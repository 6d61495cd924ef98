// Read kernel (K7): the k-char kmer and the valid-start bit at each char
// offset, from the interleaved (NW, 2) table of packed words and their
// valid-start bits; one thread per offset.
//
// Replaces sshash_tpu/ops/packed.py read_kmers_at2 (:33-48), with
// mask_last_word (:24). Plain version: sshash_tpu_torch/ops/packed.py
// read_kmers_at2_plain. Row w of the table is (strings32[w], the 16
// valid-start bits of word w's char offsets); an offset o reads rows
// o>>4 .. (o>>4) + nw, each clipped to the last row as jnp.take(...,
// mode="clip") clips, funnel-shifts their first column by 2(o & 15) bits
// and takes bit o & 15 of the first row's second column.
//
// Bound: bytes: 4 bytes in and 4nw + 1 out a lane, and the distinct table
// rows the offsets read, 8 bytes each (neighbouring offsets share rows);
// the row reads of a lane do not depend on each other. The first row is
// one 8-byte load (word and bits together), the next rows' words come
// from their pairs; the (B, nw) kmers go out through packed.cuh
// store_rows (a warp's stores cover contiguous bytes: rows of 1, 2, 4 and
// 8 words as vectors, the other widths staged in shared memory), the bits
// one byte a thread. Widths 1..8 are templates; 9..16 words (k <= 255)
// run the wide form of packed.cuh.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace sshash {

template <int W>
__global__ void read_at2_kernel(const uint32_t* __restrict__ table, int64_t n,
                                const uint32_t* __restrict__ offsets, int64_t B, int k,
                                int64_t Wrt, uint32_t* __restrict__ out,
                                uint8_t* __restrict__ vbit) {
  __shared__ RowStage<W> stage;
  const int64_t i = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
  const int64_t row0 = i - (threadIdx.x & 31);  // the warp's first row
  const int nw = used_words<W>(Wrt);
  uint32_t km[W] = {};
  if (i < B) {
    const uint32_t off = offsets[i];
    const int64_t w0 = off >> 4, last = n - 1;
    const uint32_t sh = 2u * (off & 15u);
    const uint2* pairs = reinterpret_cast<const uint2*>(table);
    const uint2 first = pairs[w0 < last ? w0 : last];
    uint32_t g[W + 1];
    g[0] = first.x;
#pragma unroll
    for (int j = 1; j <= W; ++j) g[j] = j <= nw ? pairs[w0 + j < last ? w0 + j : last].x : 0u;
    const uint32_t bits = first.y;
#pragma unroll
    for (int j = 0; j < W; ++j) km[j] = sh ? (g[j] >> sh) | (g[j + 1] << (32 - sh)) : g[j];
    mask_last_word(km, k, nw);
    vbit[i] = (bits >> (off & 15u)) & 1u;
  }
  store_rows(out, row0, (int)(B - row0 < 0 ? 0 : B - row0 < 32 ? B - row0 : 32), nw, i < B, km,
             stage);
}

template <int W>
cudaError_t launch_read_at2(const uint32_t* table, int64_t n, const uint32_t* offsets, int64_t B,
                            int k, int64_t Wrt, uint32_t* out, uint8_t* vbit,
                            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B + kRowThreads - 1) / kRowThreads);
  read_at2_kernel<W><<<blocks, kRowThreads, 0, stream>>>(table, n, offsets, B, k, Wrt, out, vbit);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes: table (n, 2) u32 (8-byte aligned), offsets (B,) u32
// -> out (B, W) kmers (16-byte aligned) and vbit (B,) bytes. Returns the
// launch's cudaError_t.
extern "C" int sshash_read_at2(const void* table, int64_t n, const void* offsets, int64_t B,
                               int64_t k, void* out, void* vbit, void* stream) {
  using namespace sshash;
  if (B <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || n < 1 || ((uintptr_t)table & 7) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t W = (2 * k + 31) / 32;
  return (int)dispatch_width(W, [&](auto w) {
    return launch_read_at2<decltype(w)::value>((const uint32_t*)table, n,
                                               (const uint32_t*)offsets, B, (int)k, W,
                                               (uint32_t*)out, (uint8_t*)vbit,
                                               (cudaStream_t)stream);
  });
}
