// Neighbours kernel: the 8 one-char variants of each kmer, one thread per
// kmer.
//
// Replaces the variant build of sshash_tpu/engine.py make_neighbours
// (:1412) with ops/packed.py drop_one_char (:417), shift_up_one_char (:424)
// and set_char (:431). Plain version: sshash_tpu_torch/ops/packed.py
// neighbour_variants_plain. The variants then go through lookup (kernels 1
// and 2) as one batch of 8B kmers.
//
// Variant v < 4 drops the first char and ORs code v into char k-1; variant
// 4 + v shifts up one char (masked to k chars) and ORs code v into char 0.
// The output is (8, B, W), variant-major, so it is the (8B, W) lookup batch
// as it stands. Widths 1..8 are templates; 9..16 words (k <= 255) run the
// wide form of packed.cuh.
//
// Bound: memory traffic, W*4 bytes read and 8*W*4 written per kmer; a few
// shifts per word. Each thread writes its W words of each variant next to
// its neighbours' in the same variant, so the stores of a warp are
// contiguous.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace sshash {

template <int W>
__global__ void neighbours_kernel(const uint32_t* __restrict__ kmers, int64_t B, int64_t Wrt,
                                  int k, uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int nw = used_words<W>(Wrt);
  // x[1..nw] holds the kmer's words, x[0] and the words past them are zero
  uint32_t km[W], x[W + 2], fwd[W], bwd[W];
  load_kmer(kmers, i, nw, km);
#pragma unroll
  for (int j = 0; j < W + 2; ++j) x[j] = j >= 1 && j <= W ? km[j - 1] : 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    fwd[j] = (x[j + 1] >> 2) | (x[j + 2] << 30);
    bwd[j] = (x[j + 1] << 2) | (x[j] >> 30);
  }
  mask_last_word(bwd, k, nw);
  const int fw = (2 * (k - 1)) / 32, fb = (2 * (k - 1)) % 32;
#pragma unroll
  for (uint32_t c = 0; c < 4; ++c) {
    uint32_t* f = out + ((int64_t)c * B + i) * nw;
    uint32_t* b = out + ((int64_t)(4 + c) * B + i) * nw;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j >= nw) break;
      f[j] = fwd[j] | (j == fw ? c << fb : 0u);
      b[j] = bwd[j] | (j == 0 ? c : 0u);
    }
  }
}

template <int W>
cudaError_t launch_neighbours(const uint32_t* kmers, int64_t B, int64_t Wrt, int k, uint32_t* out,
                              cudaStream_t stream) {
  const int threads = 256;
  neighbours_kernel<W><<<(unsigned)((B + threads - 1) / threads), threads, 0, stream>>>(
      kmers, B, Wrt, k, out);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes. Returns the launch's cudaError_t (0 on success).
extern "C" int sshash_neighbours(const void* kmers, int64_t B, int64_t W, int64_t k, void* out,
                                 void* stream) {
  using namespace sshash;
  if (B <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || W != (2 * k + 31) / 32) return (int)cudaErrorInvalidValue;
  auto in = (const uint32_t*)kmers;
  auto o = (uint32_t*)out;
  auto s = (cudaStream_t)stream;
  return (int)dispatch_width(W, [&](auto w) {
    return launch_neighbours<decltype(w)::value>(in, B, W, (int)k, o, s);
  });
}

