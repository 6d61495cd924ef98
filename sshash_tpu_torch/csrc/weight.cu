// Weight kernel: kmer id -> weight, a staged two-level search.
//
// Replaces sshash_tpu/engine.py make_weight (:1404) and the shard body of
// sshash_tpu/parallel/sharded.py make_sharded_weight (:269). Plain version:
// sshash_tpu_torch/engine.py weight_plain.
//
// Per id: the run holding it is the number of run endpoints <= id, less
// one (searchsorted(right) - 1 over w_endpoints, compared as u32), clipped
// to the runs as JAX's clipped take clips (-1 reads run 0, a run past the
// last reads the last); then its value id, then the value, each read
// clipped. A shard's tables (owned) weigh 0 outside [endpoints[0],
// endpoints[n_ep - 1]); their endpoints are padded with repeats of the
// last, which the upper bound counts as searchsorted(right) does.
//
// Bound: ids in and weights out, 8 bytes an id, and the tables once. A
// plain search is a chain of log2(n_ep) dependent reads an id, so latency,
// the shared-memory wavefronts and the L2 sectors of the reads set the
// time, not HBM. The design:
// - a persistent grid (the blocks that fit on the card) walks the ids by
//   grid stride, a few ids a thread in flight, so their searches overlap;
// - each block stages a sample of the endpoints in shared memory with
//   coalesced loads (16 bytes a thread where the table allows): every s-th
//   endpoint, s the smallest power of two that leaves fewer than
//   kWeightSample of them (s = 1, the whole table, below that many
//   endpoints), and, where s = 1 and there are at most kWeightVids runs,
//   the value ids too;
// - over the sample it builds a bucket table: the sample's span above its
//   first entry cut into nb power-of-two buckets, and for each the count
//   of entries below it, so an id's count lies between its bucket's and
//   the next one's; the fullest bucket sets the number of steps;
// - the search: two reads of the bucket table, then the same fixed number
//   of branchless steps in every lane of the block (an upper bound inside
//   the bucket), then log2(s) steps in global memory inside the one
//   segment of s endpoints that the sample picked, then the two gathers;
// - every lane searches, and an unowned lane is masked to 0 at the end, so
//   a warp's time does not depend on how many of its lanes a shard owns.
#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"
#include "tables.cuh"

namespace sshash {

constexpr int kWeightThreads = 512;
// Ids a thread carries at once, and the blocks of kWeightThreads an SM that
// the launch bounds ask for, by form (point_ab.py measured each). The
// one-level form (s = 1) is bound by shared-memory wavefronts and issue:
// three blocks (40 registers; ptxas spills 4 bytes) and three ids a thread
// beat two blocks at 64 registers. The two-level form is bound by the L2
// sectors of its global steps: one id a thread and two blocks measured
// best there.
constexpr int kWeightIdsOne = 3, kWeightBlocksOne = 3;
constexpr int kWeightIdsTwo = 1, kWeightBlocksTwo = 2;
// the sample holds fewer entries than this (kernels.WEIGHT_SAMPLE): 64 KB
constexpr int kWeightSample = 16384;
// the bucket table's most buckets, a power of two: 32 KB
constexpr int kWeightBuckets = 8192;
// the most value ids staged beside a whole table (s = 1): 32 KB
constexpr int kWeightVids = 8192;

__host__ __device__ constexpr int64_t round4(int64_t n) { return (n + 3) & ~3ll; }

// The search's shape for a table of n_ep endpoints and n_runs runs.
struct WeightPlan {
  int64_t s;       // the sample's stride
  int ns;          // its entries, ceil(n_ep / s) < kWeightSample
  int nb;          // buckets: a power of two, at least 32, >= ns up to kWeightBuckets
  int stage_vids;  // the value ids are staged too
  size_t smem;     // dynamic shared memory a block, bytes
};

inline WeightPlan weight_plan(int64_t n_ep, int64_t n_runs) {
  WeightPlan p;
  p.s = 1;
  while ((n_ep + p.s - 1) / p.s >= kWeightSample) p.s *= 2;
  p.ns = (int)((n_ep + p.s - 1) / p.s);
  p.nb = 32;
  while (p.nb < p.ns && p.nb < kWeightBuckets) p.nb *= 2;
  p.stage_vids = p.s == 1 && n_runs <= kWeightVids;
  p.smem = 4 * (size_t)(round4(p.ns) + round4(p.nb + 1) + (p.stage_vids ? n_runs : 0));
  return p;
}

// the most shared memory a plan asks for, rounded up to a KB
constexpr int kWeightMaxSmem =
    (4 * (kWeightSample + kWeightBuckets + 4 + kWeightVids) + 1023) / 1024 * 1024;

template <bool kTwoLevel>
__global__ void __launch_bounds__(kWeightThreads, kTwoLevel ? kWeightBlocksTwo : kWeightBlocksOne)
    weight_kernel(const uint32_t* __restrict__ endpoints, int64_t n_ep,
                  const uint32_t* __restrict__ value_ids, int64_t n_runs,
                  const uint32_t* __restrict__ dictionary, int64_t n_dict,
                  const uint32_t* __restrict__ ids, int64_t B, int owned, int64_t s, int ns,
                  int nb, int stage_vids, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int fullest;
  uint32_t* sample = smem;
  int* lut = (int*)(smem + round4(ns));
  uint32_t* vids = smem + round4(ns) + round4(nb + 1);
  // the sample: 16-byte loads of whole endpoints at s = 1, then the rest
  const int nv = s == 1 && ((uintptr_t)endpoints & 15) == 0 ? ns / 4 : 0;
  for (int t = threadIdx.x; t < nv; t += kWeightThreads)
    reinterpret_cast<uint4*>(sample)[t] = reinterpret_cast<const uint4*>(endpoints)[t];
  for (int t = 4 * nv + threadIdx.x; t < ns; t += kWeightThreads) sample[t] = endpoints[t * s];
  if (stage_vids) {
    const int nvv = ((uintptr_t)value_ids & 15) == 0 ? (int)(n_runs / 4) : 0;
    for (int t = threadIdx.x; t < nvv; t += kWeightThreads)
      reinterpret_cast<uint4*>(vids)[t] = reinterpret_cast<const uint4*>(value_ids)[t];
    for (int t = 4 * nvv + threadIdx.x; t < n_runs; t += kWeightThreads) vids[t] = value_ids[t];
  }
  if (threadIdx.x == 0) fullest = 0;
  __syncthreads();
  // the bucket table: bucket x holds the entries e with (e - first) >> shift
  // == x, and lut[x] counts the entries below it (lut[nb] = ns)
  const uint32_t first = sample[0], span = sample[ns - 1] - first;
  const int bits = span ? 32 - __clz(span) : 0, lg_nb = __ffs(nb) - 1;
  const int shift = bits > lg_nb ? bits - lg_nb : 0;
  for (int i = threadIdx.x; i < ns; i += kWeightThreads) {
    const int hi = (int)((sample[i] - first) >> shift);
    for (int x = i ? (int)((sample[i - 1] - first) >> shift) + 1 : 0; x <= hi; ++x) lut[x] = i;
  }
  for (int x = (int)(span >> shift) + 1 + threadIdx.x; x <= nb; x += kWeightThreads) lut[x] = ns;
  __syncthreads();
  int most = 0;
  for (int x = threadIdx.x; x < nb; x += kWeightThreads) most = max(most, lut[x + 1] - lut[x]);
  atomicMax(&fullest, most);
  __syncthreads();
  // 2^steps - 1 >= the most entries a bucket holds
  const int steps = 32 - __clz(fullest);
  const uint32_t last = endpoints[n_ep - 1];
  constexpr int kWeightIds = kTwoLevel ? kWeightIdsTwo : kWeightIdsOne;
  constexpr int64_t kBlockIds = (int64_t)kWeightThreads * kWeightIds;
  for (int64_t base = (int64_t)blockIdx.x * kBlockIds; base < B;
       base += (int64_t)gridDim.x * kBlockIds) {
    uint32_t id[kWeightIds];
    int c[kWeightIds], end[kWeightIds];
#pragma unroll
    for (int q = 0; q < kWeightIds; ++q) {
      const int64_t i = base + q * kWeightThreads + threadIdx.x;
      id[q] = i < B ? ids[i] : 0u;
      uint32_t x = id[q] < first ? 0u : (id[q] - first) >> shift;
      x = x < (uint32_t)nb ? x : (uint32_t)nb - 1;
      c[q] = lut[x];
      end[q] = lut[x + 1];
    }
    // level 1: the sample entries <= id, an upper bound inside the bucket
    for (int h = (1 << steps) >> 1; h > 0; h >>= 1) {
#pragma unroll
      for (int q = 0; q < kWeightIds; ++q) {
        const int p = c[q] + h - 1;
        if (p < end[q] && sample[p] <= id[q]) c[q] += h;
      }
    }
    // level 2: endpoints (c-1)s+1 .. cs-1 hold the boundary
    int64_t pos[kWeightIds];
#pragma unroll
    for (int q = 0; q < kWeightIds; ++q) pos[q] = c[q] == 0 ? 0 : (c[q] - 1) * s + 1;
    for (int64_t h = kTwoLevel ? s >> 1 : 0; h > 0; h >>= 1) {
#pragma unroll
      for (int q = 0; q < kWeightIds; ++q) {
        const int64_t p = pos[q] + h - 1;
        if (p < n_ep && endpoints[p] <= id[q]) pos[q] += h;
      }
    }
#pragma unroll
    for (int q = 0; q < kWeightIds; ++q) {
      int64_t run = (kTwoLevel ? pos[q] : c[q]) - 1;
      run = run < 0 ? 0 : (run < n_runs ? run : n_runs - 1);
      const uint32_t vid = stage_vids ? vids[run] : value_ids[run];
      uint32_t w = dictionary[clip_row(vid, n_dict)];
      if (owned && !(id[q] >= first && id[q] < last)) w = 0u;
      const int64_t i = base + q * kWeightThreads + threadIdx.x;
      if (i < B) out[i] = w;
    }
  }
}

// Blocks of the kernel resident on one SM of the current card at this
// plan's shared memory, rounded up to a KB. The first call on a card raises
// both forms' limit there to the most a plan asks for (above the default 48
// KB; the attribute is the card's), and each count is asked once a card: a
// call captured in a CUDA graph then makes neither request. Static, so
// that its state stays this library's: an inline function's static locals
// are one object across every library of the process that defines it.
static cudaError_t weight_blocks_per_sm(const WeightPlan& p, int* per_sm) {
  static bool raised[kMaxDevices] = {};
  static int per_kb[kMaxDevices][2][kWeightMaxSmem / 1024 + 1] = {};
  const int kb = (int)((p.smem + 1023) / 1024), two = p.s > 1;
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess && !raised[dev]) {
    err = cudaFuncSetAttribute(weight_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kWeightMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(weight_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kWeightMaxSmem);
    raised[dev] = err == cudaSuccess;
  }
  if (err == cudaSuccess && per_kb[dev][two][kb] == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_kb[dev][two][kb], two ? weight_kernel<true> : weight_kernel<false>,
        kWeightThreads, 1024 * (size_t)kb);
  *per_sm = err == cudaSuccess ? per_kb[dev][two][kb] : 0;
  return err;
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
  const WeightPlan p = weight_plan(n_ep, n_runs);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = weight_blocks_per_sm(p, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t per_block = (int64_t)kWeightThreads * (p.s > 1 ? kWeightIdsTwo : kWeightIdsOne);
  int64_t blocks = (int64_t)sms * per_sm;
  if (blocks > (B + per_block - 1) / per_block) blocks = (B + per_block - 1) / per_block;
  auto kernel = p.s > 1 ? weight_kernel<true> : weight_kernel<false>;
  kernel<<<(unsigned)blocks, kWeightThreads, p.smem, (cudaStream_t)stream>>>(
      (const uint32_t*)endpoints, n_ep, (const uint32_t*)value_ids, n_runs,
      (const uint32_t*)dictionary, n_dict, (const uint32_t*)ids, B, (int)owned, p.s, p.ns, p.nb,
      p.stage_vids, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// The plan for a table of n_ep endpoints and n_runs runs, for logs and
// tests: out[0..5] = stride s, sample entries, buckets, value ids staged (0
// or 1), shared memory a block in bytes, blocks resident on one SM.
extern "C" int sshash_weight_plan(int64_t n_ep, int64_t n_runs, int64_t* out) {
  using namespace sshash;
  if (n_ep < 1 || n_runs < 1) return (int)cudaErrorInvalidValue;
  const WeightPlan p = weight_plan(n_ep, n_runs);
  int per_sm = 0;
  const cudaError_t err = weight_blocks_per_sm(p, &per_sm);
  const int64_t v[6] = {p.s, p.ns, p.nb, p.stage_vids, (int64_t)p.smem, per_sm};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)err;
}
