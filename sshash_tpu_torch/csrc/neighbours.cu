// Neighbours kernels: the 8 one-char variants of each kmer, one thread per
// four output words, or per word.
//
// Replaces the variant build of sshash_tpu/engine.py make_neighbours
// (:1412) with ops/packed.py drop_one_char (:417), shift_up_one_char (:424)
// and set_char (:431). Plain version: sshash_tpu_torch/ops/packed.py
// neighbour_variants_plain. The variants then go through lookup as one
// batch of 8B kmers.
//
// Variant v < 4 drops the first char and ORs code v into char k-1; variant
// 4 + v shifts up one char (masked to k chars) and ORs code v into char 0.
// The output is (8, B, nw), variant-major, so it is the (8B, nw) lookup
// batch as it stands.
//
// Bound: memory traffic, nw*4 bytes read and 8*nw*4 written per kmer; a
// few shifts per word. Word g of the (B, nw) input is word j = g mod nw of
// kmer g / nw; it needs words j-1, j and j+1 of its kmer, at g-1, g and g+1
// (0 past the kmer's first or last word), and gives word j of variant v at
// v*B*nw + g. Where B*nw is a multiple of 4, a thread takes four
// consecutive words, read and written as 16-byte vectors: each of a warp's
// 8 store instructions is 512 contiguous bytes. Otherwise a thread takes
// one word: neighbouring threads read neighbouring words and share L1
// lines, and each store instruction is 128 contiguous bytes. Either way a
// thread holds a few words, at every width: no per-kmer arrays, no width
// templates.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace sshash {

constexpr int kNeighboursThreads = 256;

// One word a thread (any B*nw).
__global__ void __launch_bounds__(kNeighboursThreads)
    neighbours_kernel(const uint32_t* __restrict__ kmers, int64_t n, int nw, int k,
                      uint32_t* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * kNeighboursThreads + threadIdx.x;
  if (g >= n) return;
  const int j = n <= 0xFFFFFFFFll ? (int)((uint32_t)g % (uint32_t)nw) : (int)(g % nw);
  const uint32_t x = kmers[g];
  const uint32_t next = j + 1 < nw ? kmers[g + 1] : 0u;
  const uint32_t prev = j > 0 ? kmers[g - 1] : 0u;
  const uint32_t fwd = (x >> 2) | (next << 30);
  uint32_t bwd = (x << 2) | (prev >> 30);
  if (j == nw - 1) bwd &= last_word_mask(k, nw);
  // the char k-1 of the forward variants lies in word (2k-2)/32
  const uint32_t code_at = j == (2 * (k - 1)) / 32 ? (2 * (k - 1)) % 32 : 32;
#pragma unroll
  for (uint32_t c = 0; c < 4; ++c) {
    out[c * n + g] = fwd | (code_at < 32 ? c << code_at : 0u);
    out[(4 + c) * n + g] = bwd | (j == 0 ? c : 0u);
  }
}

// Four consecutive words a thread (B*nw a multiple of 4, both tables 16-byte
// aligned): one 16-byte load and two words beside it, 8 16-byte stores.
__global__ void __launch_bounds__(kNeighboursThreads)
    neighbours_vec4_kernel(const uint32_t* __restrict__ kmers, int64_t n, int nw, int k,
                           uint32_t* __restrict__ out) {
  const int64_t g4 = (int64_t)blockIdx.x * kNeighboursThreads + threadIdx.x;
  if (4 * g4 >= n) return;
  const int64_t g = 4 * g4;
  const uint4 v = reinterpret_cast<const uint4*>(kmers)[g4];
  const uint32_t x[6] = {g > 0 ? kmers[g - 1] : 0u, v.x, v.y, v.z, v.w,
                         g + 4 < n ? kmers[g + 4] : 0u};
  const int j0 = (int)(g % nw), fw = (2 * (k - 1)) / 32, fb = (2 * (k - 1)) % 32;
  uint32_t fwd[4], bwd[4];
  int jj[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = (j0 + r) % nw;
    const uint32_t next = j + 1 < nw ? x[r + 2] : 0u, prev = j > 0 ? x[r] : 0u;
    fwd[r] = (x[r + 1] >> 2) | (next << 30);
    bwd[r] = (x[r + 1] << 2) | (prev >> 30);
    if (j == nw - 1) bwd[r] &= last_word_mask(k, nw);
    jj[r] = j;
  }
#pragma unroll
  for (uint32_t c = 0; c < 4; ++c) {
    uint32_t f[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      f[r] = fwd[r] | (jj[r] == fw ? c << fb : 0u);
      b[r] = bwd[r] | (jj[r] == 0 ? c : 0u);
    }
    reinterpret_cast<uint4*>(out + c * n)[g4] = make_uint4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<uint4*>(out + (4 + c) * n)[g4] = make_uint4(b[0], b[1], b[2], b[3]);
  }
}

}  // namespace sshash

// C entry for ctypes. Returns the launch's cudaError_t (0 on success).
extern "C" int sshash_neighbours(const void* kmers, int64_t B, int64_t W, int64_t k, void* out,
                                 void* stream) {
  using namespace sshash;
  if (B <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || W != (2 * k + 31) / 32) return (int)cudaErrorInvalidValue;
  const int64_t n = B * W;
  if (n % 4 == 0 && ((uintptr_t)kmers & 15) == 0 && ((uintptr_t)out & 15) == 0) {
    neighbours_vec4_kernel<<<(unsigned)((n / 4 + kNeighboursThreads - 1) / kNeighboursThreads),
                             kNeighboursThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)kmers, n, (int)W, (int)k, (uint32_t*)out);
    return (int)cudaGetLastError();
  }
  neighbours_kernel<<<(unsigned)((n + kNeighboursThreads - 1) / kNeighboursThreads),
                      kNeighboursThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)kmers, n, (int)W, (int)k, (uint32_t*)out);
  return (int)cudaGetLastError();
}
