// Kernel 1: minimizer of each query kmer, one thread per lane.
//
// Replaces the device helpers that sshash_tpu/engine.py make_lookup.fn
// inlines (engine.py:1096-1098, 1130, 1150-1151): ops/packed.py
// compute_minimizer, compute_minimizer_both, compute_minimizer_two_strand
// (and _tree_min, which computes the same function), extract_window,
// revcomp_mmer64, crc32_word and revcomp_kmers; ops/u64.py mixer64 and
// mul_const. Plain version: sshash_tpu_torch/ops/packed.py minimizer_plain.
//
// Bound: integer ALU. A lane reads nw*4 bytes and writes 12 (forward) or
// 24 + nw*4 (both strands); its k-m+1 windows each cost one 64-bit
// multiply (two with the RC strand). The window walk and its tie rules
// are minimizer.cuh's kmer_minimizers, which the lookup kernel (probe.cu
// sshash_lookup) shares; the RC kmer is packed.cuh's revcomp_words.
// Widths 1..8 are templates; 9..16 words (k <= 255) run the wide form,
// whose window walk still indexes the array by constants.
//
// The rank form (sshash_minimizer_ranks) serves the stream's missed lanes,
// compacted in rank order with their count on the device: both strands'
// minimizers of rows j < *count, on a grid sized to the card (grid.cuh)
// that strides up to the count, so the launch is fixed and its work is
// the misses' (JAX sizes it with windows up to the count in a while_loop,
// sshash_tpu/streaming.py run_windows :551-588). Rows at or past the count
// are not written, nor is the RC kmer: the run-skip heads read the
// minimizer values and the rank-space lookup walks its kmers itself.
#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"
#include "minimizer.cuh"
#include "packed.cuh"

namespace sshash {

template <int W, bool BOTH>
__global__ void minimizer_kernel(const uint32_t* __restrict__ kmers, int64_t B, int64_t Wrt,
                                 int k, int m, uint64_t magic, uint64_t* __restrict__ mv,
                                 int32_t* __restrict__ mp, uint32_t* __restrict__ kmers_rc,
                                 uint64_t* __restrict__ mv_r, int32_t* __restrict__ mp_r) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int nw = used_words<W>(Wrt);
  uint32_t kw[W];
  load_kmer(kmers, i, nw, kw);
  const Minimizers mz = kmer_minimizers<W, BOTH>(kw, k, m, magic);
  mv[i] = mz.mv_f;
  mp[i] = mz.mp_f;
  if (BOTH) {
    uint32_t rc[W];
    revcomp_words(kw, k, nw, rc);
    store_kmer(kmers_rc, i, nw, rc);
    mv_r[i] = mz.mv_r;
    mp_r[i] = mz.mp_r;
  }
}

constexpr int kRankThreads = 256;

template <int W>
__global__ void __launch_bounds__(kRankThreads)
    minimizer_ranks_kernel(const uint32_t* __restrict__ kmers, int64_t P, int64_t Wrt,
                           const int32_t* __restrict__ count, int k, int m, uint64_t magic,
                           uint64_t* __restrict__ mv_f, int32_t* __restrict__ mp_f,
                           uint64_t* __restrict__ mv_r, int32_t* __restrict__ mp_r) {
  const int64_t n = misses(count, P), stride = (int64_t)gridDim.x * blockDim.x;
  const int nw = used_words<W>(Wrt);
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
    uint32_t kw[W];
    load_kmer(kmers, j, nw, kw);
    const Minimizers mz = kmer_minimizers<W, true>(kw, k, m, magic);
    mv_f[j] = mz.mv_f;
    mp_f[j] = mz.mp_f;
    mv_r[j] = mz.mv_r;
    mp_r[j] = mz.mp_r;
  }
}

template <int W>
cudaError_t launch_minimizer(const uint32_t* kmers, int64_t B, int64_t Wrt, int k, int m,
                             uint64_t magic, uint64_t* mv, int32_t* mp, uint32_t* kmers_rc,
                             uint64_t* mv_r, int32_t* mp_r, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  if (kmers_rc)
    minimizer_kernel<W, true><<<blocks, threads, 0, stream>>>(kmers, B, Wrt, k, m, magic, mv, mp,
                                                              kmers_rc, mv_r, mp_r);
  else
    minimizer_kernel<W, false><<<blocks, threads, 0, stream>>>(kmers, B, Wrt, k, m, magic, mv,
                                                               mp, nullptr, nullptr, nullptr);
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
  if (m < 1 || m > 31 || k < m || k > kMaxK || W != (2 * k + 31) / 32)
    return (int)cudaErrorInvalidValue;
  auto km = (const uint32_t*)kmers;
  auto v = (uint64_t*)mv;
  auto p = (int32_t*)mp;
  auto rc = (uint32_t*)kmers_rc;
  auto vr = (uint64_t*)mv_r;
  auto pr = (int32_t*)mp_r;
  auto s = (cudaStream_t)stream;
  return (int)dispatch_width(W, [&](auto w) {
    return launch_minimizer<decltype(w)::value>(km, B, W, (int)k, (int)m, magic, v, p, rc, vr,
                                                pr, s);
  });
}


// C entry for ctypes: the rank form over the (P, W) kmers; rows j <
// *count (int32, on the device) get both strands' minimizers (mv_f, mp_f,
// mv_r, mp_r: (P,) each). Returns the launch's cudaError_t (0 on success).
extern "C" int sshash_minimizer_ranks(const void* kmers, int64_t P, int64_t W, int64_t k,
                                      int64_t m, uint64_t magic, const void* count, void* mv_f,
                                      void* mp_f, void* mv_r, void* mp_r, void* stream) {
  using namespace sshash;
  static PerDevice per_sm[kMaxFixedW + 1];  // by kernel width
  if (P <= 0) return (int)cudaGetLastError();
  if (m < 1 || m > 31 || k < m || k > kMaxK || W != (2 * k + 31) / 32 || !count)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_width(W, [&](auto w) {
    constexpr int WW = decltype(w)::value;
    int64_t blocks = 0;
    const cudaError_t err = pass_blocks(minimizer_ranks_kernel<WW>, kRankThreads,
                                        per_sm[WW <= kMaxFixedW ? WW - 1 : kMaxFixedW], P,
                                        &blocks);
    if (err != cudaSuccess) return err;
    minimizer_ranks_kernel<WW><<<(unsigned)blocks, kRankThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)kmers, P, W, (const int32_t*)count, (int)k, (int)m, magic,
        (uint64_t*)mv_f, (int32_t*)mp_f, (uint64_t*)mv_r, (int32_t*)mp_r);
    return cudaGetLastError();
  });
}
