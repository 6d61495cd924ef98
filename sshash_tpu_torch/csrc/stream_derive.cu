// Stream derivation: run-skip heads, the second lookup round's lanes, the
// merge of the lookup rounds, and the counters.
//
// Replaces sshash_tpu/streaming.py make_stream_step's derive_full and
// derive_fast (:460-486, 515-539, 551-629): the negative-minimizer run-skip
// (reference streaming_query.hpp:150-157), the per-head-rank
// minimizer_found record that picks the round-2 lanes, the scatter of the
// rounds' results back to their lanes, and the per-lane adjacency count.
// Plain versions: sshash_tpu_torch/streaming.py stream_heads_plain,
// stream_round2_plain, stream_merge_plain and stream_count_plain.
//
// Every kernel runs a grid sized to the card, not to P, and reads the
// misses' device count n once a block; the rank-space stages do work only
// below n.
//
// heads: rank j < n is a head unless the skip is on (JAX's gate: n > P/64,
// read on the device), rank j-1 is the previous lane, both strands'
// minimizers (kernel 1's mv_f, mv_r) are unchanged and the lane starts no
// read. One thread a rank in warp-strided passes; rank j-1's values come
// from the lane before by a shuffle (lane 0 loads them). Ranks from n up to
// the next warp's get 0, the rest of the P flags 0 with 16-byte stores.
// round2: rank j < n is a round-2 lane iff it is no head and its run head
// (the last head at or before j) found its kmer or its minimizer. One pass
// of scan.cuh's single-pass scan carries the latest head forward as a max
// of keys (j + 1) << 1 | that head's found-or-minimizer-found bit, so a run
// of any length (a poly-A read over a whole chunk) costs one pass. Tiles of
// 8192 ranks, 2 vectors of 16 a thread (4 ran slower; stream_ab.py keeps
// that side), the three flag arrays read with 16-byte loads and kept as
// bit masks, the result stored with 16-byte stores; the flags past the
// tiles only zeroed. merge: 16 ranks a thread, the rounds' found flags read
// with 16-byte loads; each rank j < n found by either round writes its
// lane (round 1 first). count: 8 lanes a thread a pass (kCountLanes; 16
// took 96 registers and ran slower), found read 8 lanes a load and the
// three fields 4 lanes a load (lane by lane where a field is not 16-byte
// aligned, as a sharded engine's rows may be); lane l-1 comes from the
// thread before by a shuffle; the sums stay in registers, then warp
// shuffles and shared memory reduce a block's, added with one atomicAdd per
// counter per block (a few hundred blocks; u32, exact mod 2^32 in any
// order); two threads write lane 0's and the last lane's rows.
//
// Bound: bytes. heads read 20 bytes a rank below n when the skip is on and
// write one flag a lane; round2 reads 3 bytes a rank below n and writes one
// flag a lane; merge reads 2 bytes a rank below n and 16 more per found
// rank, writing 13 per found rank; count reads 13 bytes a lane. All are a
// few integer operations per element.
#include "scan.cuh"

namespace sshash {

constexpr int kDeriveThreads = 256;
constexpr int kCountThreads = 256;
constexpr int kCountLanes = 8;  // lanes a thread a pass: 8 or 16
constexpr int kRound2Vecs = 2;  // 16-rank vectors a thread
constexpr int kRound2Tile = kScanThreads * kRound2Vecs * 16;

__device__ __forceinline__ bool bit_at(const uint32_t* bits, int64_t i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// Zero flags [from, P) of a P-flag array (16-byte aligned, from and P
// multiples of 16) over the grid.
__device__ __forceinline__ void zero_flags(uint8_t* flags, int64_t from, int64_t P) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = from / 16 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < P / 16;
       v += stride)
    reinterpret_cast<uint4*>(flags)[v] = make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kDeriveThreads)
    heads_kernel(const unsigned long long* __restrict__ mvf,
                 const unsigned long long* __restrict__ mvr, const int32_t* __restrict__ lanes,
                 const int32_t* __restrict__ count, const uint32_t* __restrict__ fbits, int64_t P,
                 int gate, uint8_t* __restrict__ head) {
  const int lane = threadIdx.x & 31;
  const int64_t n = misses(count, P), n32 = (n + 31) & ~int64_t(31);
  const bool on = gate < 0 ? n > P / 64 : gate != 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // j - lane, the warp's first rank, keeps the loop warp-uniform
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j - lane < n32; j += stride) {
    const bool in = j < n;
    bool h = in;
    if (on) {
      const int32_t l = in ? lanes[j] : 0;
      const unsigned long long f = in ? mvf[j] : 0ull, r = in ? mvr[j] : 0ull;
      int32_t pl = __shfl_up_sync(0xFFFFFFFFu, l, 1);
      unsigned long long pf = __shfl_up_sync(0xFFFFFFFFu, f, 1);
      unsigned long long pr = __shfl_up_sync(0xFFFFFFFFu, r, 1);
      if (lane == 0 && in && j > 0) pl = lanes[j - 1], pf = mvf[j - 1], pr = mvr[j - 1];
      if (in && j > 0) h = !(pl == l - 1 && f == pf && r == pr && !bit_at(fbits, l));
    }
    head[j] = h;
  }
  zero_flags(head, n32, P);
}

// Bit b of the result: byte b of v is nonzero.
__device__ __forceinline__ uint32_t byte_mask(const uint4 v) {
  uint32_t m = 0;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t z = (((w[q] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w[q]) & 0x80808080u;
    m |= ((z >> 7) & 1u | (z >> 14) & 2u | (z >> 21) & 4u | (z >> 28) & 8u) << (4 * q);
  }
  return m;
}

__global__ void __launch_bounds__(kScanThreads)
    round2_kernel(const uint8_t* __restrict__ head, const uint8_t* __restrict__ found,
                  const uint8_t* __restrict__ mfound, const int32_t* __restrict__ count, int64_t P,
                  unsigned long long* __restrict__ scratch, uint8_t* __restrict__ round2) {
  __shared__ uint32_t wsum[33];
  __shared__ int64_t slot;
  const int64_t n = misses(count, P), ntiles = (n + kRound2Tile - 1) / kRound2Tile;
  for (int64_t tile; (tile = next_tile(scratch, &slot, ntiles)) >= 0;) {
    const int64_t k0 = tile * (kRound2Tile / 16) + threadIdx.x;  // vector i: k0 + i * threads
    // per vector of 16 ranks: bit b set where rank j0 + b < n is a head
    // (hm), where its found or minimizer_found is (mm)
    uint32_t hm[kRound2Vecs], mm[kRound2Vecs], s[kRound2Vecs], ex[kRound2Vecs];
#pragma unroll
    for (int i = 0; i < kRound2Vecs; ++i) {
      const int64_t j0 = (k0 + i * kScanThreads) * 16;
      hm[i] = mm[i] = 0;
      if (j0 < n) {
        const uint4 f = __ldg(reinterpret_cast<const uint4*>(found + j0));
        const uint4 m = __ldg(reinterpret_cast<const uint4*>(mfound + j0));
        hm[i] = byte_mask(__ldg(reinterpret_cast<const uint4*>(head + j0)));
        mm[i] = byte_mask(make_uint4(f.x | m.x, f.y | m.y, f.z | m.z, f.w | m.w));
        if (n - j0 < 16) hm[i] &= (1u << (n - j0)) - 1u;
      }
      // the key of the vector's last head, 0 for none
      const int b = 31 - __clz(hm[i]);
      s[i] = hm[i] ? (uint32_t)(j0 + b + 1) << 1 | ((mm[i] >> b) & 1u) : 0u;
    }
    tile_scan<MaxOp, kRound2Vecs>(s, ex, wsum, scratch + 1, tile);
#pragma unroll
    for (int i = 0; i < kRound2Vecs; ++i) {
      const int64_t j0 = (k0 + i * kScanThreads) * 16;
      if (j0 >= P) continue;
      const uint32_t below = j0 >= n ? 0u : n - j0 >= 16 ? 0xFFFFu : (1u << (n - j0)) - 1u;
      uint32_t run = ex[i] & 1u, o = 0;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const uint32_t h = (hm[i] >> b) & 1u;
        run = h ? (mm[i] >> b) & 1u : run;
        o |= (run & ~h) << b;
      }
      o &= below;
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t t = o >> (4 * q);
        w[q] = (t & 1u) | (t & 2u) << 7 | (t & 4u) << 14 | (t & 8u) << 21;
      }
      *reinterpret_cast<uint4*>(round2 + j0) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  zero_flags(round2, ntiles * kRound2Tile < P ? ntiles * kRound2Tile : P, P);
}

struct MergeIO {
  const int32_t* lanes;
  const int32_t* count;
  const uint8_t* f1;
  const int32_t* sid1;
  const int32_t* kid1;
  const int32_t* ori1;
  const uint8_t* f2;
  const int32_t* sid2;
  const int32_t* kid2;
  const int32_t* ori2;
  uint8_t* found;
  int32_t* sid;
  int32_t* kid;
  int32_t* ori;
};

__global__ void __launch_bounds__(kDeriveThreads) merge_kernel(MergeIO io, int64_t P) {
  const int64_t n = misses(io.count, P), stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j0 = 16 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x); j0 < n;
       j0 += 16 * stride) {
    // ranks found by either round, bit b for rank j0 + b
    uint32_t hit;
    if (j0 + 16 <= n) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(io.f1 + j0));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(io.f2 + j0));
      hit = byte_mask(make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w));
    } else {
      hit = 0;
      for (int b = 0; j0 + b < n; ++b) hit |= (uint32_t)(io.f1[j0 + b] || io.f2[j0 + b]) << b;
    }
    for (; hit; hit &= hit - 1) {
      const int64_t j = j0 + __ffs(hit) - 1;
      const bool a = io.f1[j];
      const int64_t l = io.lanes[j];
      io.found[l] = 1;
      io.sid[l] = a ? io.sid1[j] : io.sid2[j];
      io.kid[l] = a ? io.kid1[j] : io.kid2[j];
      io.ori[l] = a ? io.ori1[j] : io.ori2[j];
    }
  }
}

__device__ __forceinline__ void count_row(const uint8_t* found, const uint32_t* sid,
                                          const uint32_t* kid, const int32_t* ori,
                                          const uint32_t* valid, int64_t l, uint32_t* row) {
  row[0] = found[l] && bit_at(valid, l), row[1] = sid[l], row[2] = kid[l];
  row[3] = (uint32_t)ori[l];
}

// kCountLanes lanes from l0 of a u32 field: vector loads when VEC (every
// field 16-byte aligned) and the lanes lie below P, else lane by lane.
template <bool VEC>
__device__ __forceinline__ void load_lanes(const uint32_t* x, int64_t l0, int64_t P,
                                           uint32_t (&v)[kCountLanes]) {
  if (VEC && l0 + kCountLanes <= P) {
#pragma unroll
    for (int q = 0; q < kCountLanes / 4; ++q) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(x + l0) + q);
      v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCountLanes; ++i) v[i] = l0 + i < P ? x[l0 + i] : 0u;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kCountThreads)
    count_kernel(const uint8_t* __restrict__ found, const uint32_t* __restrict__ sid,
                 const uint32_t* __restrict__ kid, const int32_t* __restrict__ ori,
                 const uint32_t* __restrict__ valid, const uint32_t* __restrict__ fbits,
                 const uint32_t* __restrict__ count, int64_t P, uint32_t* __restrict__ out) {
  constexpr int L = kCountLanes;
  constexpr uint32_t kLaneBits = (1u << L) - 1u;
  __shared__ uint32_t part[3][kCountThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t cnt = *count;
  const int64_t groups = (P + L - 1) / L, stride = (int64_t)gridDim.x * blockDim.x;
  uint32_t npos = 0, next = 0, nval = 0;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g - lane < groups;
       g += stride) {
    const int64_t l0 = g * L;
    const bool in = g < groups;
    uint32_t fw[L / 4] = {}, sv[L], kv[L], ov[L];
    uint32_t vb = 0, fb = 0;
    if (in) {
      if (VEC && l0 + L <= P) {
        if constexpr (L == 16) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(found + l0));
          fw[0] = w.x, fw[1] = w.y, fw[2] = w.z, fw[3] = w.w;
        } else {
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(found + l0));
          fw[0] = w.x, fw[1] = w.y;
        }
      } else {
        for (int i = 0; i < L && l0 + i < P; ++i)
          fw[i >> 2] |= (uint32_t)found[l0 + i] << (8 * (i & 3));
      }
      vb = (valid[l0 >> 5] >> (l0 & 31)) & kLaneBits;
      fb = (fbits[l0 >> 5] >> (l0 & 31)) & kLaneBits;
      if (l0 + L > P) vb &= (1u << (P - l0)) - 1u;
    }
    load_lanes<VEC>(sid, in ? l0 : P, P, sv);
    load_lanes<VEC>(kid, in ? l0 : P, P, kv);
    load_lanes<VEC>(reinterpret_cast<const uint32_t*>(ori), in ? l0 : P, P, ov);
    // lane l0 - 1: the last lane of the thread before, or loaded by lane 0
    const uint32_t last_f = ((fw[(L - 1) >> 2] >> 24) != 0) && ((vb >> (L - 1)) & 1u);
    uint32_t pf = __shfl_up_sync(0xFFFFFFFFu, last_f, 1);
    uint32_t ps = __shfl_up_sync(0xFFFFFFFFu, sv[L - 1], 1);
    uint32_t pk = __shfl_up_sync(0xFFFFFFFFu, kv[L - 1], 1);
    uint32_t po = __shfl_up_sync(0xFFFFFFFFu, ov[L - 1], 1);
    if (lane == 0 && in && l0 > 0) {
      const int64_t l = l0 - 1;
      pf = found[l] && bit_at(valid, l), ps = sid[l], pk = kid[l], po = (uint32_t)ori[l];
    }
    if (l0 == 0) pf = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t v = (vb >> i) & 1u, f = (((fw[i >> 2] >> (8 * (i & 3))) & 0xFFu) != 0) & v;
      nval += v;
      npos += f;
      next += f & pf & !((fb >> i) & 1u) & (sv[i] == ps) & (ov[i] == po) & (kv[i] == pk + po);
      pf = f, ps = sv[i], pk = kv[i], po = ov[i];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    npos += __shfl_down_sync(0xFFFFFFFFu, npos, d);
    next += __shfl_down_sync(0xFFFFFFFFu, next, d);
    nval += __shfl_down_sync(0xFFFFFFFFu, nval, d);
  }
  if (lane == 0) part[0][warp] = npos, part[1][warp] = next, part[2][warp] = nval;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t a = 0, b = 0, c = 0;
    for (int w = 0; w < kCountThreads / 32; ++w) a += part[0][w], b += part[1][w], c += part[2][w];
    atomicAdd(out + 1, a);
    atomicAdd(out + 2, b);
    atomicAdd(out + 3, (blockIdx.x == 0 ? cnt : 0u) - c);
    if (blockIdx.x == 0) out[0] = cnt;
  }
  if (blockIdx.x == 0 && threadIdx.x < 2) {
    const int64_t last = cnt == 0 ? 0 : ((int64_t)cnt - 1 < P - 1 ? (int64_t)cnt - 1 : P - 1);
    count_row(found, sid, kid, ori, valid, threadIdx.x == 0 ? 0 : last,
              out + (threadIdx.x == 0 ? 4 : 8));
  }
}

}  // namespace sshash

// C entry for ctypes: head (P,) bool over rank space, P a multiple of 32,
// head 16-byte aligned; gate 1 on, 0 off, -1 on iff *count > P/64. Returns
// the first CUDA error (0 on success).
extern "C" int sshash_stream_heads(const void* mv_f, const void* mv_r, const void* lanes,
                                   const void* count, const void* fbits, int64_t P, int64_t gate,
                                   void* head, void* stream) {
  using namespace sshash;
  static PerDevice per_sm;
  if (P <= 0 || P % 32) return (int)cudaErrorInvalidValue;
  int64_t blocks = 0;
  const cudaError_t err = pass_blocks(heads_kernel, kDeriveThreads, per_sm, P, &blocks);
  if (err != cudaSuccess) return (int)err;
  heads_kernel<<<(unsigned)blocks, kDeriveThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)mv_f, (const unsigned long long*)mv_r, (const int32_t*)lanes,
      (const int32_t*)count, (const uint32_t*)fbits, P, (int)gate, (uint8_t*)head);
  return (int)cudaGetLastError();
}

// u64 words of round 2's scratch for P ranks: the tile counter and one
// status word a tile.
extern "C" int64_t sshash_round2_scratch(int64_t P) {
  return 1 + (P + sshash::kRound2Tile - 1) / sshash::kRound2Tile;
}

// C entry for ctypes: round2 (P,) bool from head, found and
// minimizer_found (bool (P,)); P a multiple of 32, every array 16-byte
// aligned; scratch of sshash_round2_scratch(P) words, zeroed here. Returns
// the first CUDA error.
extern "C" int sshash_stream_round2(const void* head, const void* found, const void* mfound,
                                    const void* count, int64_t P, void* scratch, void* round2,
                                    void* stream) {
  using namespace sshash;
  static PerDevice per_sm;
  if (P <= 0 || P % 32 || P >= (int64_t(1) << 30)) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  int64_t blocks = 0;
  cudaError_t err = pass_blocks(round2_kernel, kScanThreads, per_sm, P / 16, &blocks);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, 8 * sshash_round2_scratch(P), s);
  if (err != cudaSuccess) return (int)err;
  round2_kernel<<<(unsigned)blocks, kScanThreads, 0, s>>>(
      (const uint8_t*)head, (const uint8_t*)found, (const uint8_t*)mfound, (const int32_t*)count,
      P, (unsigned long long*)scratch, (uint8_t*)round2);
  return (int)cudaGetLastError();
}

// C entry for ctypes: the found ranks j < *count of either round write
// their lane (round 1 first). Returns the first CUDA error.
extern "C" int sshash_stream_merge(const sshash::MergeIO* io, int64_t P, void* stream) {
  using namespace sshash;
  static PerDevice per_sm;
  if (P <= 0) return (int)cudaGetLastError();
  int64_t blocks = 0;
  const cudaError_t err = pass_blocks(merge_kernel, kDeriveThreads, per_sm, P / 16, &blocks);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(unsigned)blocks, kDeriveThreads, 0, (cudaStream_t)stream>>>(*io, P);
  return (int)cudaGetLastError();
}

// C entry for ctypes: out (3, 4) u32, zeroed here (one memset). Vector
// loads when found, sid, kid and ori all start 16-byte aligned. Returns
// the first CUDA error.
extern "C" int sshash_stream_count(const void* found, const void* sid, const void* kid,
                                   const void* ori, const void* valid, const void* fbits,
                                   const void* count, int64_t P, void* out, void* stream) {
  using namespace sshash;
  static PerDevice per_sm[2];
  if (P <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const bool vec = !(((uintptr_t)found | (uintptr_t)sid | (uintptr_t)kid | (uintptr_t)ori) & 15);
  const int64_t groups = (P + kCountLanes - 1) / kCountLanes;
  int64_t blocks = 0;
  cudaError_t err =
      vec ? pass_blocks(count_kernel<true>, kCountThreads, per_sm[1], groups, &blocks)
          : pass_blocks(count_kernel<false>, kCountThreads, per_sm[0], groups, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(out, 0, 12 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  auto fn = vec ? count_kernel<true> : count_kernel<false>;
  fn<<<(unsigned)blocks, kCountThreads, 0, s>>>(
      (const uint8_t*)found, (const uint32_t*)sid, (const uint32_t*)kid, (const int32_t*)ori,
      (const uint32_t*)valid, (const uint32_t*)fbits, (const uint32_t*)count, P, (uint32_t*)out);
  return (int)cudaGetLastError();
}
