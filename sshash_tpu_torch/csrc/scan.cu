// Scan kernel: exclusive int32 prefix sum, and the compaction of flagged
// lanes into rank order.
//
// Replaces sshash_tpu/ops/packed.py prefix_sum_ex (:359, the TPU's grouped
// two-level cumsum) and the rank scatters of sshash_tpu/streaming.py
// (:501, 545, 557-559: segment ranks, run-head ranks, compacted lane ids).
// Plain versions: sshash_tpu_torch/ops/packed.py prefix_sum_ex and
// compact_plain.
//
// One launch a call, plus one memset of the scratch: a single pass with
// decoupled look-back (scan.cuh). A tile is 256 threads x 4 vectors of 16
// bytes: 4096 int32 or 16384 flags, loaded once with 16-byte loads in
// striped order. The scan stores each vector's four exclusive sums with one
// 16-byte store; the compaction writes the lane of every flagged element at
// its rank (a warp's 512 flags in 16 ballot rounds, so set lanes store side
// by side), the block of the last tile writes the count, and then every
// block, once the last tile has published the total, zero-fills its share
// of the positions past the count (part of the contract: compact_plain
// gives them), so the fill needs no launch of its own. An input that does
// not start 16-byte aligned (a slice) is read from the aligned address
// below it, the elements outside it masked; vectors at either end load
// element by element. Sums are u32 and wrap, as JAX's int32 cumsum does.
//
// Bound: bytes. 8 bytes per element for a scan (4 in, 4 out); 1 per flag,
// 4 per flagged lane and 4 per zero past the count for a compaction. The
// integer work is a few operations per element.
#include "scan.cuh"

namespace sshash {

constexpr int kScanVecs = 4;                                  // 16-byte vectors a thread
constexpr int kScanTile = kScanThreads * kScanVecs * 4;      // int32
constexpr int kCompactTile = kScanThreads * kScanVecs * 16;  // flags

// Vector k of the input in the element space that starts at the aligned
// address `base` (the input's element e is element e + off there): its
// 16 bytes, with the bytes of elements outside [off, off + n) zero.
template <int BYTES>
__device__ __forceinline__ uint4 load_vec(const uint8_t* base, int64_t k, int64_t off, int64_t n) {
  constexpr int kPer = 16 / BYTES;
  const int64_t e0 = k * kPer;
  if (e0 >= off && e0 + kPer <= off + n) return __ldg(reinterpret_cast<const uint4*>(base) + k);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t e = e0 + j;
    if (e >= off && e < off + n) {
      const uint32_t x = BYTES == 4 ? *reinterpret_cast<const uint32_t*>(base + 4 * e)
                                    : (uint32_t)base[e];
      w[(j * BYTES) >> 2] |= BYTES == 4 ? x : x << (8 * (j & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bit 7 of each nonzero byte of w.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}

// A warp's row of 32 flag vectors (512 consecutive flags, lane t's x from
// element e0): the lane ids of the flagged ones at their ranks, from ex,
// the exclusive count of lane 0's vector. 16 rounds of 32 flags in order:
// each lane takes its flag from the vector's owner by shuffles, one ballot
// ranks the round, and the set lanes store side by side (a lane storing
// its own vector's ranks would scatter a warp's stores over 32 lines).
__device__ __forceinline__ void compact_row(const uint4 x, uint32_t ex, int64_t e0,
                                            int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xFFFFFFFFu, below = (1u << lane) - 1u;
  uint32_t rank = __shfl_sync(full, ex, 0);
  const int64_t first = __shfl_sync(full, e0, 0);  // lane t's e0 is first + 16 t
  const int q = (lane & 15) >> 2, sh = 8 * (lane & 3);
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int owner = 2 * r + (lane >> 4);
    const uint32_t w0 = __shfl_sync(full, x.x, owner), w1 = __shfl_sync(full, x.y, owner);
    const uint32_t w2 = __shfl_sync(full, x.z, owner), w3 = __shfl_sync(full, x.w, owner);
    const uint32_t w = q == 0 ? w0 : q == 1 ? w1 : q == 2 ? w2 : w3;
    const bool set = (w >> sh) & 0xFFu;
    const unsigned m = __ballot_sync(full, set);
    if (set) out[rank + __popc(m & below)] = (int32_t)(first + 32 * r + lane);
    rank += __popc(m);
  }
}

template <bool COMPACT>
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const uint8_t* __restrict__ base, int64_t off, int64_t n,
                unsigned long long* __restrict__ scratch, int64_t ntiles,
                int32_t* __restrict__ out, int32_t* __restrict__ count) {
  __shared__ uint32_t wsum[33];
  __shared__ int64_t slot;
  constexpr int kTile = COMPACT ? kCompactTile : kScanTile;
  constexpr int kPer = COMPACT ? 16 : 4;
  unsigned long long* status = scratch + 1;
  for (int64_t tile; (tile = next_tile(scratch, &slot, ntiles)) >= 0;) {
    const int64_t k0 = tile * (kTile / kPer) + threadIdx.x;  // vector i: k0 + i * threads
    uint4 x[kScanVecs];
    uint32_t s[kScanVecs], ex[kScanVecs];
#pragma unroll
    for (int i = 0; i < kScanVecs; ++i)
      x[i] = load_vec<COMPACT ? 1 : 4>(base, k0 + i * kScanThreads, off, n);
#pragma unroll
    for (int i = 0; i < kScanVecs; ++i) {
      if (COMPACT) {
        s[i] = __popc(nonzero_bytes(x[i].x)) + __popc(nonzero_bytes(x[i].y)) +
               __popc(nonzero_bytes(x[i].z)) + __popc(nonzero_bytes(x[i].w));
      } else {
        s[i] = x[i].x + x[i].y + x[i].z + x[i].w;
      }
    }
    tile_scan<SumOp, kScanVecs>(s, ex, wsum, status, tile);
    if (COMPACT && tile == ntiles - 1 && threadIdx.x == 0) *count = (int32_t)wsum[32];
#pragma unroll
    for (int i = 0; i < kScanVecs; ++i) {
      const int64_t e0 = (k0 + i * kScanThreads) * kPer - off;  // the vector's first element
      if (COMPACT) {
        compact_row(x[i], ex[i], e0, out);
      } else {
        const uint32_t p0 = ex[i], p1 = p0 + x[i].x, p2 = p1 + x[i].y, p3 = p2 + x[i].z;
        if (off == 0 && e0 + 4 <= n) {
          *reinterpret_cast<int4*>(out + e0) = make_int4((int)p0, (int)p1, (int)p2, (int)p3);
        } else {
          const uint32_t p[4] = {p0, p1, p2, p3};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (e0 + j >= 0 && e0 + j < n) out[e0 + j] = (int32_t)p[j];
        }
      }
    }
  }
  if (!COMPACT) return;
  // every tile is taken: wait for the total, then zero out[total, n) over
  // the grid, 16-byte stores between the 4-element boundaries
  __shared__ uint32_t total;
  if (threadIdx.x == 0) {
    unsigned long long st;
    while (((st = load_status(status + ntiles - 1)) >> 32) != kStatusInclusive) {
    }
    total = (uint32_t)st;
  }
  __syncthreads();
  const int64_t lo = total, lo4 = (lo + 3) & ~int64_t(3), hi4 = n & ~int64_t(3);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (lo4 >= hi4) {
    for (int64_t e = lo + tid; e < n; e += stride) out[e] = 0;
    return;
  }
  if (tid < lo4 - lo) out[lo + tid] = 0;
  if (tid < n - hi4) out[hi4 + tid] = 0;
  for (int64_t v = lo4 / 4 + tid; v < hi4 / 4; v += stride)
    reinterpret_cast<int4*>(out)[v] = make_int4(0, 0, 0, 0);
}

template <bool COMPACT>
int64_t tiles_of(const void* in, int64_t n) {
  constexpr int kTile = COMPACT ? kCompactTile : kScanTile;
  const int64_t off = ((uintptr_t)in & 15) / (COMPACT ? 1 : 4);
  return (n + off + kTile - 1) / kTile;
}

// static: its occupancy cache stays this library's (a template's static
// locals are one object across every library of the process)
template <bool COMPACT>
static cudaError_t launch_scan(const void* in, int64_t n, unsigned long long* scratch, int32_t* out,
                        int32_t* count, cudaStream_t stream) {
  static PerDevice per_sm;
  const int64_t ntiles = tiles_of<COMPACT>(in, n);
  int64_t blocks = 0;
  cudaError_t err = card_blocks(scan_kernel<COMPACT>, kScanThreads, per_sm, &blocks);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (ntiles + 1), stream);
  if (err != cudaSuccess) return err;
  if (blocks > ntiles) blocks = ntiles;
  const uint8_t* base = (const uint8_t*)((uintptr_t)in & ~(uintptr_t)15);
  const int64_t off = ((const uint8_t*)in - base) / (COMPACT ? 1 : 4);
  scan_kernel<COMPACT><<<(unsigned)blocks, kScanThreads, 0, stream>>>(base, off, n, scratch,
                                                                       ntiles, out, count);
  return cudaGetLastError();
}

}  // namespace sshash

// Scratch of a call on n elements: u64 words, the most any start address
// needs (the tile counter, then one status word a tile).
extern "C" int64_t sshash_scan_scratch(int64_t n, int64_t compact) {
  const int64_t tile = compact ? sshash::kCompactTile : sshash::kScanTile;
  return 1 + (n + 15 + tile - 1) / tile;
}

// C entry for ctypes: out[i] = v[0] + ... + v[i-1] (mod 2^32), int32 (n,);
// out starts 16-byte aligned. Returns the first CUDA error (0 on success).
extern "C" int sshash_scan(const void* v, int64_t n, void* scratch, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return (int)sshash::launch_scan<false>(v, n, (unsigned long long*)scratch, (int32_t*)out,
                                         nullptr, (cudaStream_t)stream);
}

// C entry for ctypes: idx[rank] = i for every i with flags[i] != 0 (uint8
// (n,)), in order, and idx[*count:] = 0; *count = the number of flags set.
// idx starts 16-byte aligned. Returns the first CUDA error.
extern "C" int sshash_compact(const void* flags, int64_t n, void* scratch, void* idx, void* count,
                              void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return (int)sshash::launch_scan<true>(flags, n, (unsigned long long*)scratch, (int32_t*)idx,
                                        (int32_t*)count, (cudaStream_t)stream);
}
