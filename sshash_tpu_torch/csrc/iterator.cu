// Iterator kernel: (count, checksum) of a full iteration, in one pass.
//
// Replaces sshash_tpu/engine.py make_iterator (:1338, its reduce form) and
// ops/packed.py iterate_kmers (:312). Plain version:
// sshash_tpu_torch/engine.py iterate_plain.
//
// Char offset o = 16*w + c starts a kmer iff bit (16*(w&1) + c) of
// vstart32[w>>1] is set; its kmer is words w..w+W of strings32 shifted by
// 2c (zero past the end). Each thread takes words w of a grid-stride loop
// and, for the 16 offsets of each, XOR-folds the kmer's W words (last word
// masked) and adds the fold of every valid start to its sum; it also
// popcounts vstart32 words. Warp shuffles and one shared-memory step reduce
// a block to one (count, checksum) pair, which one thread adds to the
// result with two atomicAdds. Sums are u32 and wrap: addition mod 2^32 is
// exact in any order, so the result equals the plain version's bit for bit.
//
// Bound: one streaming read of strings32 (neighbouring threads read
// neighbouring words; the W extra words each thread reads hit L1) and of
// vstart32, 4.5 bytes per char offset; about 16*(2W+2) integer operations
// per word. The result stays in device memory and nothing synchronises.
// Widths 1..8 are templates; 9..16 words (k <= 255) run the wide form of
// packed.cuh.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace sshash {

constexpr int kIterThreads = 256;

template <int W>
__global__ void __launch_bounds__(kIterThreads)
    iterate_kernel(const uint32_t* __restrict__ s, int64_t NW, const uint32_t* __restrict__ v32,
                   int64_t NV, int k, int64_t Wrt, uint32_t* __restrict__ out) {
  const int nw = used_words<W>(Wrt);
  const uint32_t last_mask = last_word_mask(k, nw);
  uint32_t acc = 0, cnt = 0;
  const int64_t n = NW > NV ? NW : NV;
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; w < n;
       w += (int64_t)gridDim.x * blockDim.x) {
    if (w < NV) cnt += __popc(v32[w]);
    if (w >= NW) continue;
    uint32_t x[W + 1];
#pragma unroll
    for (int j = 0; j <= W; ++j) x[j] = j <= nw && w + j < NW ? s[w + j] : 0u;
    const uint32_t valid = v32[w >> 1] >> (16 * (w & 1));
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      uint32_t fold = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        uint32_t xj = c ? (x[j] >> (2 * c)) | (x[j + 1] << (32 - 2 * c)) : x[j];
        if (j == nw - 1) xj &= last_mask;
        if (j < nw) fold ^= xj;
      }
      if ((valid >> c) & 1u) acc += fold;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    acc += __shfl_down_sync(0xFFFFFFFFu, acc, d);
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, d);
  }
  __shared__ uint32_t s_acc[kIterThreads / 32], s_cnt[kIterThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_acc[warp] = acc;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (warp == 0) {
    acc = lane < kIterThreads / 32 ? s_acc[lane] : 0u;
    cnt = lane < kIterThreads / 32 ? s_cnt[lane] : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      acc += __shfl_down_sync(0xFFFFFFFFu, acc, d);
      cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, d);
    }
    if (lane == 0) {
      atomicAdd(out, cnt);
      atomicAdd(out + 1, acc);
    }
  }
}

template <int W>
cudaError_t launch_iterate(const uint32_t* s, int64_t NW, const uint32_t* v32, int64_t NV, int k,
                           int64_t Wrt, uint32_t* out, cudaStream_t stream) {
  const int64_t n = NW > NV ? NW : NV;
  int64_t blocks = (n + kIterThreads - 1) / kIterThreads;
  // a grid-stride loop: enough blocks to fill the card several times over
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (blocks > (int64_t)sms * 16) blocks = (int64_t)sms * 16;
  iterate_kernel<W><<<(unsigned)blocks, kIterThreads, 0, stream>>>(s, NW, v32, NV, k, Wrt, out);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes. out is 2 zeroed u32: (count, checksum) are added to
// it. vstart32 must cover every word of strings32 (2*NV >= NW). Returns the
// launch's cudaError_t (0 on success).
extern "C" int sshash_iterate(const void* strings32, int64_t NW, const void* vstart32, int64_t NV,
                              int64_t k, void* out, void* stream) {
  using namespace sshash;
  if (k < 1 || k > kMaxK || NW < 1 || 2 * NV < NW) return (int)cudaErrorInvalidValue;
  auto s = (const uint32_t*)strings32;
  auto v = (const uint32_t*)vstart32;
  auto o = (uint32_t*)out;
  auto st = (cudaStream_t)stream;
  const int64_t W = (2 * k + 31) / 32;
  return (int)dispatch_width(W, [&](auto w) {
    return launch_iterate<decltype(w)::value>(s, NW, v, NV, (int)k, W, o, st);
  });
}

