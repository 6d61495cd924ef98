// Weight kernel: kmer id -> weight, one thread per id.
//
// Replaces sshash_tpu/engine.py make_weight (:1404) and the shard body of
// sshash_tpu/parallel/sharded.py make_sharded_weight (:269). Plain version:
// sshash_tpu_torch/engine.py weight_plain.
//
// Per id: the run holding it is the number of run endpoints <= id, less
// one (an upper-bound binary search over w_endpoints, searchsorted(right)
// - 1), clipped to the runs as JAX's clipped take clips (-1 reads run 0);
// then its value id, then the value, each read clipped.
//
// Bound: a chain of log2(runs) + 2 dependent reads per id. At run lengths
// like the reference's E. coli example (about 945 kmers per run) a 5M-kmer
// index has a few thousand runs, a table of tens of KB that stays in L1/L2:
// the chain's latency, not HBM, sets the time. The design is the plain
// search, one thread per id, with nothing but the weight written.
#include <cuda_runtime.h>

#include <cstdint>

#include "tables.cuh"

namespace sshash {

__global__ void weight_kernel(const uint32_t* __restrict__ endpoints, int64_t n_ep,
                              const uint32_t* __restrict__ value_ids, int64_t n_runs,
                              const uint32_t* __restrict__ dictionary, int64_t n_dict,
                              const uint32_t* __restrict__ ids, int64_t B, int owned,
                              uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t id = ids[i];
  if (owned && !(id >= endpoints[0] && id < endpoints[n_ep - 1])) {
    out[i] = 0;
    return;
  }
  int64_t lo = 0, hi = n_ep;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (endpoints[mid] <= id)
      lo = mid + 1;
    else
      hi = mid;
  }
  int64_t run = lo - 1;
  run = run < 0 ? 0 : (run < n_runs ? run : n_runs - 1);
  out[i] = dictionary[clip_row(value_ids[run], n_dict)];
}

}  // namespace sshash

// C entry for ctypes. Returns the launch's cudaError_t (0 on success).
extern "C" int sshash_weight(const void* endpoints, int64_t n_ep, const void* value_ids,
                             int64_t n_runs, const void* dictionary, int64_t n_dict,
                             const void* ids, int64_t B, int64_t owned, void* out,
                             void* stream) {
  using namespace sshash;
  if (B <= 0) return (int)cudaGetLastError();
  if (n_ep < 1 || n_runs < 1 || n_dict < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  weight_kernel<<<(unsigned)((B + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)endpoints, n_ep, (const uint32_t*)value_ids, n_runs,
      (const uint32_t*)dictionary, n_dict, (const uint32_t*)ids, B, (int)owned,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
