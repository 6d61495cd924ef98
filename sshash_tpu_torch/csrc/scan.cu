// Scan kernel: exclusive int32 prefix sum, and the compaction of flagged
// lanes into rank order.
//
// Replaces sshash_tpu/ops/packed.py prefix_sum_ex (:359, the TPU's grouped
// two-level cumsum) and the rank scatters of sshash_tpu/streaming.py
// (:501, 545, 557-559: segment ranks, run-head ranks, compacted lane ids).
// Plain versions: sshash_tpu_torch/ops/packed.py prefix_sum_ex and
// compact_plain.
//
// Three launches per call: each block of 512 threads sums a tile of 4096
// elements (8 consecutive per thread); one block scans the tile sums in
// place (a loop of 512-wide block scans with a running carry); each block
// then rescans its tile from its base and writes the exclusive sums, or,
// for a compaction, the lane of every flagged element at its rank and the
// total count. Block scans are warp shuffles plus one shared-memory step.
// Sums are u32 and wrap, as JAX's int32 cumsum does.
//
// Bound: bytes. The input is read twice (tile sums, rescan) and the output
// written once: 12 bytes per element for a scan, 2 (+4 per flagged
// element) for a compaction; integer work is a few adds per element.
#include <cuda_runtime.h>

#include <cstdint>

namespace sshash {

constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;

// Exclusive scan of x over the block; *total (shared) gets the block sum.
// warp_sums holds 32 words of shared memory. Ends with a barrier, so the
// caller may reuse warp_sums and read *total.
__device__ __forceinline__ uint32_t block_scan_ex(uint32_t x, uint32_t* warp_sums,
                                                  uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t s = lane < nwarps ? warp_sums[lane] : 0u;
    uint32_t si = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, si, d);
      if (lane >= d) si += y;
    }
    warp_sums[lane] = si - s;
    if (lane == 31) *total = si;
  }
  __syncthreads();
  const uint32_t out = warp_sums[warp] + inc - x;
  __syncthreads();
  return out;
}

template <bool COMPACT>
__device__ __forceinline__ uint32_t load_item(const int32_t* v, const uint8_t* flags, int64_t e,
                                              int64_t n) {
  if (e >= n) return 0u;
  return COMPACT ? (flags[e] != 0) : (uint32_t)v[e];
}

template <bool COMPACT>
__global__ void __launch_bounds__(kScanThreads)
    tile_sums_kernel(const int32_t* __restrict__ v, const uint8_t* __restrict__ flags, int64_t n,
                     uint32_t* __restrict__ sums) {
  __shared__ uint32_t ws[32];
  __shared__ uint32_t total;
  const int64_t base = (int64_t)blockIdx.x * kScanTile + (int64_t)threadIdx.x * kScanItems;
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) s += load_item<COMPACT>(v, flags, base + i, n);
  block_scan_ex(s, ws, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: sums[0..nb) -> exclusive scan in place; *count = the total.
__global__ void __launch_bounds__(kScanThreads)
    scan_sums_kernel(uint32_t* __restrict__ sums, int64_t nb, int32_t* __restrict__ count) {
  __shared__ uint32_t ws[32];
  __shared__ uint32_t total;
  uint32_t carry = 0;
  for (int64_t b0 = 0; b0 < nb; b0 += blockDim.x) {
    const int64_t i = b0 + threadIdx.x;
    const uint32_t x = i < nb ? sums[i] : 0u;
    const uint32_t ex = block_scan_ex(x, ws, &total);
    if (i < nb) sums[i] = carry + ex;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0 && count) *count = (int32_t)carry;
}

template <bool COMPACT>
__global__ void __launch_bounds__(kScanThreads)
    tile_scan_kernel(const int32_t* __restrict__ v, const uint8_t* __restrict__ flags, int64_t n,
                     const uint32_t* __restrict__ sums, int32_t* __restrict__ out) {
  __shared__ uint32_t ws[32];
  __shared__ uint32_t total;
  const int64_t base = (int64_t)blockIdx.x * kScanTile + (int64_t)threadIdx.x * kScanItems;
  uint32_t x[kScanItems];
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    x[i] = load_item<COMPACT>(v, flags, base + i, n);
    s += x[i];
  }
  uint32_t run = sums[blockIdx.x] + block_scan_ex(s, ws, &total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t e = base + i;
    if (e < n) {
      if (COMPACT) {
        if (x[i]) out[run] = (int32_t)e;
      } else {
        out[e] = (int32_t)run;
      }
    }
    run += x[i];
  }
}

template <bool COMPACT>
cudaError_t launch_scan(const int32_t* v, const uint8_t* flags, int64_t n, uint32_t* sums,
                        int32_t* out, int32_t* count, cudaStream_t stream) {
  const int64_t nb = (n + kScanTile - 1) / kScanTile;
  tile_sums_kernel<COMPACT><<<(unsigned)nb, kScanThreads, 0, stream>>>(v, flags, n, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_sums_kernel<<<1, kScanThreads, 0, stream>>>(sums, nb, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan_kernel<COMPACT><<<(unsigned)nb, kScanThreads, 0, stream>>>(v, flags, n, sums, out);
  return cudaGetLastError();
}

}  // namespace sshash

// Tile sums scratch: one u32 per 4096 elements.
extern "C" int64_t sshash_scan_scratch(int64_t n) {
  return (n + sshash::kScanTile - 1) / sshash::kScanTile;
}

// C entry for ctypes: out[i] = v[0] + ... + v[i-1] (mod 2^32), int32 (n,).
// Returns the last launch's cudaError_t (0 on success).
extern "C" int sshash_scan(const void* v, int64_t n, void* sums, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return (int)sshash::launch_scan<false>((const int32_t*)v, nullptr, n, (uint32_t*)sums,
                                         (int32_t*)out, nullptr, (cudaStream_t)stream);
}

// C entry for ctypes: idx[rank] = i for every i with flags[i] != 0 (uint8
// (n,)), in order; *count = the number of flags set. idx positions past the
// count are left as they were. Returns the last launch's cudaError_t.
extern "C" int sshash_compact(const void* flags, int64_t n, void* sums, void* idx, void* count,
                              void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return (int)sshash::launch_scan<true>(nullptr, (const uint8_t*)flags, n, (uint32_t*)sums,
                                        (int32_t*)idx, (int32_t*)count, (cudaStream_t)stream);
}
