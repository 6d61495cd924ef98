// Check kernel (K13): the sanitizer's postconditions over a lookup's
// result fields, in one pass.
//
// Replaces the four checkify.check predicates of sshash_tpu/debug.py
// checkified_lookup (:59-75) over the lookup's result. Plain version:
// sshash_tpu_torch/debug.py check_plain. On every found lane: kmer_id <
// num_kmers (0), kmer_offset < num_chars (1), orientation +1 or -1 (2),
// string_begin <= kmer_offset (3); a lookup of rebased (v2) rows has no
// offset fields, and then only predicates 0 and 2 are checked.
//
// Each thread of a grid-stride loop ORs the predicates its lanes violate
// into a 4-bit mask; a warp ORs its masks with one warp reduction, and its
// first lane sets flags[p] = 1 for each violated predicate p with an
// atomicOr (one flag word per predicate, zeroed by the caller). The caller
// reads the 16 flag bytes back once per call.
//
// Bound: bytes: 9 bytes a lane (found, kmer_id, orientation), 17 with the
// offset fields; a few integer compares a lane.
//
// Also the synchronous-launch check of kernels.debug_mode:
// sshash_last_error returns (and clears) the last CUDA error.
#include <cuda_runtime.h>

#include <cstdint>

namespace sshash {

constexpr int kCheckThreads = 256;

__global__ void __launch_bounds__(kCheckThreads)
    check_kernel(const uint8_t* __restrict__ found, const uint32_t* __restrict__ kmer_id,
                 const int32_t* __restrict__ orientation,
                 const uint32_t* __restrict__ kmer_offset,
                 const uint32_t* __restrict__ string_begin, int64_t B, int64_t num_kmers,
                 int64_t num_chars, uint32_t* __restrict__ flags) {
  uint32_t bad = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < B;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (!found[i]) continue;
    const int32_t ori = orientation[i];
    bad |= (int64_t)kmer_id[i] >= num_kmers ? 1u : 0u;
    bad |= ori != 1 && ori != -1 ? 4u : 0u;
    if (kmer_offset) {
      const uint32_t off = kmer_offset[i];
      bad |= (int64_t)off >= num_chars ? 2u : 0u;
      bad |= string_begin[i] > off ? 8u : 0u;
    }
  }
  bad = __reduce_or_sync(0xFFFFFFFFu, bad);
  if ((threadIdx.x & 31) == 0 && bad) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if ((bad >> p) & 1u) atomicOr(flags + p, 1u);
  }
}

}  // namespace sshash

// C entry for ctypes: flags (4 u32, zeroed by the caller) gets 1 in word p
// when a found lane violates predicate p. kmer_offset and string_begin are
// both null (v2 rows) or both given. Returns the launch's cudaError_t.
extern "C" int sshash_check(const void* found, const void* kmer_id, const void* orientation,
                            const void* kmer_offset, const void* string_begin, int64_t B,
                            int64_t num_kmers, int64_t num_chars, void* flags, void* stream) {
  using namespace sshash;
  if (B <= 0) return (int)cudaGetLastError();
  if (!kmer_offset != !string_begin) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (B + kCheckThreads - 1) / kCheckThreads;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;
  check_kernel<<<(unsigned)blocks, kCheckThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)found, (const uint32_t*)kmer_id, (const int32_t*)orientation,
      (const uint32_t*)kmer_offset, (const uint32_t*)string_begin, B, num_kmers, num_chars,
      (uint32_t*)flags);
  return (int)cudaGetLastError();
}

// The last CUDA error of this thread (0 for none), cleared.
extern "C" int sshash_last_error() { return (int)cudaGetLastError(); }
