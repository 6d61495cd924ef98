// Kernel 1: minimizer of each query kmer, one thread per lane.
//
// Replaces the device helpers that sshash_tpu/engine.py make_lookup.fn
// inlines (engine.py:1096-1098, 1130, 1150-1151): ops/packed.py
// compute_minimizer, compute_minimizer_both, compute_minimizer_two_strand
// (and _tree_min, which computes the same function), extract_window,
// revcomp_mmer64, crc32_word and revcomp_kmers; ops/u64.py mixer64 and
// mul_const. Plain version: sshash_tpu_torch/ops/packed.py minimizer_plain.
//
// Bound: integer ALU. A lane reads W*4 bytes and writes 12 (forward) or
// 24 + W*4 (both strands); its k-m+1 windows each cost one 64-bit multiply
// (two with the RC strand). The kmer stays in registers as one 128-bit
// value, so a window is a shift and a mask, with no per-window word select
// as on the TPU.
//
// Tie rules: the forward scan keeps the leftmost minimum (strict <); the RC
// scan walks the forward windows and keeps the rightmost j (<=), which is
// the leftmost minimum in RC coordinates, reported as k-m-j.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"
#include "u64.cuh"

namespace sshash {

template <int W, bool BOTH>
__global__ void minimizer_kernel(const uint32_t* __restrict__ kmers, int64_t B, int k, int m,
                                 uint64_t magic, uint64_t* __restrict__ mv,
                                 int32_t* __restrict__ mp, uint32_t* __restrict__ kmers_rc,
                                 uint64_t* __restrict__ mv_r, int32_t* __restrict__ mp_r) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t km[W];
#pragma unroll
  for (int w = 0; w < W; ++w) km[w] = kmers[i * W + w];
  const u128 x = to_u128(km);
  const uint64_t mask = (1ull << (2 * m)) - 1;  // m <= 31
  const int nw = k - m + 1;
  uint64_t bf_h = 0, bf_v = 0, br_h = 0, br_v = 0;
  int bf_p = 0, br_j = 0;
  for (int j = 0; j < nw; ++j) {
    const uint64_t v = (uint64_t)(x >> (2 * j)) & mask;
    const uint64_t h = mixer64(v, magic);
    if (j == 0 || h < bf_h) {
      bf_h = h;
      bf_v = v;
      bf_p = j;
    }
    if (BOTH) {
      const uint64_t vr = revcomp_mmer64(v, m);
      const uint64_t hr = mixer64(vr, magic);
      if (j == 0 || hr <= br_h) {
        br_h = hr;
        br_v = vr;
        br_j = j;
      }
    }
  }
  mv[i] = bf_v;
  mp[i] = bf_p;
  if (BOTH) {
    uint32_t rc[W];
    from_u128(revcomp_kmer(x, k), rc);
#pragma unroll
    for (int w = 0; w < W; ++w) kmers_rc[i * W + w] = rc[w];
    mv_r[i] = br_v;
    mp_r[i] = k - m - br_j;
  }
}

template <int W>
cudaError_t launch_minimizer(const uint32_t* kmers, int64_t B, int k, int m, uint64_t magic,
                             uint64_t* mv, int32_t* mp, uint32_t* kmers_rc, uint64_t* mv_r,
                             int32_t* mp_r, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  if (kmers_rc)
    minimizer_kernel<W, true><<<blocks, threads, 0, stream>>>(kmers, B, k, m, magic, mv, mp,
                                                              kmers_rc, mv_r, mp_r);
  else
    minimizer_kernel<W, false><<<blocks, threads, 0, stream>>>(kmers, B, k, m, magic, mv, mp,
                                                               nullptr, nullptr, nullptr);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes. kmers_rc, mv_r and mp_r are null for the forward strand
// alone. Returns the launch's cudaError_t (0 on success).
extern "C" int sshash_minimizer(const void* kmers, int64_t B, int64_t W, int64_t k, int64_t m,
                                uint64_t magic, void* mv, void* mp, void* kmers_rc, void* mv_r,
                                void* mp_r, void* stream) {
  using namespace sshash;
  if (B <= 0) return (int)cudaGetLastError();
  if (m < 1 || m > 31 || k < m || k > 63 || W != (2 * k + 31) / 32)
    return (int)cudaErrorInvalidValue;
  auto km = (const uint32_t*)kmers;
  auto v = (uint64_t*)mv;
  auto p = (int32_t*)mp;
  auto rc = (uint32_t*)kmers_rc;
  auto vr = (uint64_t*)mv_r;
  auto pr = (int32_t*)mp_r;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 1: return (int)launch_minimizer<1>(km, B, k, m, magic, v, p, rc, vr, pr, s);
    case 2: return (int)launch_minimizer<2>(km, B, k, m, magic, v, p, rc, vr, pr, s);
    case 3: return (int)launch_minimizer<3>(km, B, k, m, magic, v, p, rc, vr, pr, s);
    case 4: return (int)launch_minimizer<4>(km, B, k, m, magic, v, p, rc, vr, pr, s);
  }
  return (int)cudaErrorInvalidValue;
}
