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
// the row reads of a lane do not depend on each other. Widths 1..8 are
// templates; 9..16 words (k <= 255) run the wide form of packed.cuh.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace sshash {

template <int W>
__global__ void read_at2_kernel(const uint32_t* __restrict__ table, int64_t n,
                                const uint32_t* __restrict__ offsets, int64_t B, int k,
                                int64_t Wrt, uint32_t* __restrict__ out,
                                uint8_t* __restrict__ vbit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int nw = used_words<W>(Wrt);
  const uint32_t off = offsets[i];
  const int64_t w0 = off >> 4, last = n - 1;
  const uint32_t sh = 2u * (off & 15u);
  uint32_t g[W + 1], km[W];
#pragma unroll
  for (int j = 0; j <= W; ++j)
    g[j] = j <= nw ? table[2 * (w0 + j < last ? w0 + j : last)] : 0u;
  const uint32_t bits = table[2 * (w0 < last ? w0 : last) + 1];
#pragma unroll
  for (int j = 0; j < W; ++j) km[j] = sh ? (g[j] >> sh) | (g[j + 1] << (32 - sh)) : g[j];
  mask_last_word(km, k, nw);
  store_kmer(out, i, nw, km);
  vbit[i] = (bits >> (off & 15u)) & 1u;
}

template <int W>
cudaError_t launch_read_at2(const uint32_t* table, int64_t n, const uint32_t* offsets, int64_t B,
                            int k, int64_t Wrt, uint32_t* out, uint8_t* vbit,
                            cudaStream_t stream) {
  const int threads = 256;
  read_at2_kernel<W><<<(unsigned)((B + threads - 1) / threads), threads, 0, stream>>>(
      table, n, offsets, B, k, Wrt, out, vbit);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes: table (n, 2) u32, offsets (B,) u32 -> out (B, W)
// kmers and vbit (B,) bytes. Returns the launch's cudaError_t.
extern "C" int sshash_read_at2(const void* table, int64_t n, const void* offsets, int64_t B,
                               int64_t k, void* out, void* vbit, void* stream) {
  using namespace sshash;
  if (B <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || n < 1) return (int)cudaErrorInvalidValue;
  const int64_t W = (2 * k + 31) / 32;
  return (int)dispatch_width(W, [&](auto w) {
    return launch_read_at2<decltype(w)::value>((const uint32_t*)table, n,
                                               (const uint32_t*)offsets, B, (int)k, W,
                                               (uint32_t*)out, (uint8_t*)vbit,
                                               (cudaStream_t)stream);
  });
}
