// Single-pass scans with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016), shared
// by the scan and compaction kernels (scan.cu) and the round-2 copy-forward
// (stream_derive.cu).
//
// A scan runs on a grid sized to the card (card_blocks): each block takes
// tiles in order from an atomic counter, so a tile's predecessors have all
// been taken by running blocks and a look-back never waits on a block that
// has not started. A tile publishes its aggregate, then its inclusive
// prefix, in a 64-bit status word (flag in the high half, value in the
// low, so no read is torn: release stores, relaxed loads at device
// scope). One warp looks back over the predecessors 32 status words at a
// time. The counter and
// the status words are one u64 scratch array, [counter, status of tile 0,
// ...], zeroed by one cudaMemsetAsync before the launch (a memset node
// when captured in a CUDA graph).
//
// Within a tile each thread holds NV vectors, vector v = i * blockDim +
// thread (the striped order of 16-byte loads, a warp's load instruction
// reading 512 contiguous bytes); the block's exclusive scan over vectors
// runs the NV scans side by side: warp shuffles, then one warp scans the
// NV x warps warp totals in vector order (32 lanes at 256 threads and 4
// vectors).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"

namespace sshash {

constexpr int kScanThreads = 256;

constexpr uint32_t kStatusAggregate = 1, kStatusInclusive = 2;  // 0: not yet published

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A status word holds its own value, so no other write needs ordering
// before its reader: a relaxed load at device scope suffices.
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* status, int64_t tile, uint32_t flag,
                                        uint32_t value) {
  store_release(status + tile, ((unsigned long long)flag << 32) | value);
}

// Sums, wrapping mod 2^32. The look-back stops at an inclusive prefix.
struct SumOp {
  static __device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) { return a + b; }
  static __device__ __forceinline__ bool stops(uint32_t flag, uint32_t) {
    return flag == kStatusInclusive;
  }
};

// Unsigned max over keys that grow with the position (0: none yet): the
// latest key wins, so the look-back also stops at any predecessor that
// holds a key.
struct MaxOp {
  static __device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) { return a > b ? a : b; }
  static __device__ __forceinline__ bool stops(uint32_t flag, uint32_t v) {
    return flag == kStatusInclusive || v != 0;
  }
};

// Warp 0, all lanes: the exclusive prefix of tile >= 1 from its
// predecessors' status words, nearest first. Waits until every word up to
// the first one it may stop at is published.
template <class Op>
__device__ __forceinline__ uint32_t look_back(const unsigned long long* status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  for (int64_t pos = tile - 1;; pos -= 32) {
    const int64_t t = pos - lane;
    uint32_t flag, value;
    unsigned stop;
    for (;;) {
      const unsigned long long s =
          t >= 0 ? load_status(status + t) : (unsigned long long)kStatusInclusive << 32;
      flag = (uint32_t)(s >> 32);
      value = (uint32_t)s;
      stop = __ballot_sync(0xFFFFFFFFu, Op::stops(flag, value));
      const unsigned upto = stop ? (2u << (__ffs(stop) - 1)) - 1u : 0xFFFFFFFFu;
      if (!(__ballot_sync(0xFFFFFFFFu, flag == 0) & upto)) break;
    }
    const int last = stop ? __ffs(stop) - 1 : 31;
    uint32_t v = lane <= last ? value : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = Op::apply(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
    prefix = Op::apply(prefix, v);
    if (stop) return prefix;
  }
}

// The block's scan of one tile of NV vectors a thread. s[i]: this
// thread's reduction of vector i; ex[i] gets its exclusive prefix over the
// whole input (the tile's predecessors included). wsum: 33 words of shared
// memory that no other thread touches until the caller's next barrier;
// word 32 gets the tile's inclusive prefix. Publishes the tile's status.
// Two barriers.
template <class Op, int NV>
__device__ __forceinline__ void tile_scan(const uint32_t (&s)[NV], uint32_t (&ex)[NV],
                                          uint32_t* wsum, unsigned long long* status,
                                          int64_t tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kScanThreads / 32;
  static_assert(NV * kWarps <= 32, "one warp scans the warp totals");
  uint32_t inc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    inc[i] = s[i];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, inc[i], d);
      if (lane >= d) inc[i] = Op::apply(y, inc[i]);
    }
    if (lane == 31) wsum[i * kWarps + warp] = inc[i];
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t x = lane < NV * kWarps ? wsum[lane] : 0u;
    uint32_t xi = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, xi, d);
      if (lane >= d) xi = Op::apply(y, xi);
    }
    const uint32_t total = __shfl_sync(0xFFFFFFFFu, xi, 31);
    uint32_t xe = __shfl_up_sync(0xFFFFFFFFu, xi, 1);
    if (lane == 0) xe = 0;
    uint32_t prefix = 0;
    if (tile == 0) {
      if (lane == 0) publish(status, 0, kStatusInclusive, total);
    } else {
      if (lane == 0) publish(status, tile, kStatusAggregate, total);
      prefix = look_back<Op>(status, tile);
      if (lane == 0) publish(status, tile, kStatusInclusive, Op::apply(prefix, total));
    }
    wsum[lane] = Op::apply(prefix, xe);
    if (lane == 0) wsum[32] = Op::apply(prefix, total);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    uint32_t e = __shfl_up_sync(0xFFFFFFFFu, inc[i], 1);
    if (lane == 0) e = 0;
    ex[i] = Op::apply(wsum[i * kWarps + warp], e);
  }
}

// The next tile for this block, from the scratch's counter (tiles are
// taken in order), or -1 once they are all taken. The barrier also orders
// the shared slot and tile_scan's words with the block's previous tile.
__device__ __forceinline__ int64_t next_tile(unsigned long long* counter, int64_t* slot,
                                             int64_t ntiles) {
  if (threadIdx.x == 0) *slot = (int64_t)atomicAdd(counter, 1ull);
  __syncthreads();
  const int64_t t = *slot;
  return t < ntiles ? t : -1;
}

}  // namespace sshash
