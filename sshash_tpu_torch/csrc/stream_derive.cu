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
// heads: in the rank space of the compacted missing lanes, rank j is a head
// unless the skip is on (JAX's gate: more than P/64 misses, read from
// device memory), rank j-1 is the previous lane, both strands' minimizers
// (kernel 1's mv_f, mv_r of the two kmers) are unchanged and the lane
// starts no read. round2: one launch records each head's minimizer_found |
// found at its head rank, a second marks the non-heads whose head's record
// is set. merge: one thread per rank writes a found result to its lane.
// count: one thread per lane; warp shuffles and one shared-memory step
// reduce a block's positives, extensions and valid lanes, added with one
// atomicAdd each (u32 sums, exact mod 2^32 in any order); the threads of
// lane 0 and of the last lane write their rows.
//
// Bound: bytes. heads read 20 bytes per rank (two minimizers, a lane, a
// neighbour's lane) and write 1; round2 about 12; merge up to 26 per found
// rank; count reads 13 bytes per lane. All are a few integer operations
// per element.
#include <cuda_runtime.h>

#include <cstdint>

namespace sshash {

constexpr int kDeriveThreads = 256;

__device__ __forceinline__ bool bit_at(const uint32_t* bits, int64_t i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__global__ void heads_kernel(const uint64_t* __restrict__ mvf, const uint64_t* __restrict__ mvr,
                             const int32_t* __restrict__ lanes, const int32_t* __restrict__ count,
                             const uint32_t* __restrict__ fbits, int64_t P, int gate,
                             uint8_t* __restrict__ head) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  const int64_t n = *count;
  if (j >= n) {
    head[j] = 0;
    return;
  }
  const bool on = gate < 0 ? n > P / 64 : gate != 0;
  bool h = true;
  if (on && j > 0) {
    const int32_t l = lanes[j];
    h = !(lanes[j - 1] == l - 1 && mvf[j] == mvf[j - 1] && mvr[j] == mvr[j - 1] &&
          !bit_at(fbits, l));
  }
  head[j] = h;
}

__global__ void head_mf_kernel(const uint8_t* __restrict__ head, const int32_t* __restrict__ hs,
                               const uint8_t* __restrict__ mf, const int32_t* __restrict__ count,
                               int64_t P, uint8_t* __restrict__ head_mf) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P || j >= *count || !head[j]) return;
  head_mf[hs[j]] = mf[j] != 0;
}

__global__ void round2_kernel(const uint8_t* __restrict__ head, const int32_t* __restrict__ hs,
                              const int32_t* __restrict__ count,
                              const uint8_t* __restrict__ head_mf, int64_t P,
                              uint8_t* __restrict__ round2) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  const int32_t run = hs[j] > 0 ? hs[j] - 1 : 0;
  round2[j] = j < *count && !head[j] && head_mf[run];
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

__global__ void merge_kernel(MergeIO io, int64_t P) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P || j >= *io.count) return;
  const bool a = io.f1[j], b = io.f2[j];
  if (!a && !b) return;
  const int64_t l = io.lanes[j];
  io.found[l] = 1;
  io.sid[l] = a ? io.sid1[j] : io.sid2[j];
  io.kid[l] = a ? io.kid1[j] : io.kid2[j];
  io.ori[l] = a ? io.ori1[j] : io.ori2[j];
}

__device__ __forceinline__ uint32_t block_sum(uint32_t x, uint32_t* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xFFFFFFFFu, x, d);
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  x = lane < kDeriveThreads / 32 ? smem[lane] : 0u;
  if (warp == 0) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xFFFFFFFFu, x, d);
  }
  __syncthreads();
  return x;  // the block's sum in thread 0
}

__global__ void __launch_bounds__(kDeriveThreads)
    count_kernel(const uint8_t* __restrict__ found, const uint32_t* __restrict__ sid,
                 const uint32_t* __restrict__ kid, const int32_t* __restrict__ ori,
                 const uint32_t* __restrict__ valid, const uint32_t* __restrict__ fbits,
                 const uint32_t* __restrict__ count, int64_t P, uint32_t* __restrict__ out) {
  __shared__ uint32_t smem[kDeriveThreads / 32];
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t cnt = *count;
  uint32_t npos = 0, next = 0, nval = 0;
  if (l < P) {
    const bool v = bit_at(valid, l);
    const bool f = found[l] && v;
    nval = v;
    npos = f;
    if (f && l > 0 && found[l - 1] && bit_at(valid, l - 1) && !bit_at(fbits, l))
      next = sid[l] == sid[l - 1] && ori[l] == ori[l - 1] &&
             kid[l] == kid[l - 1] + (uint32_t)ori[l - 1];
    const int64_t last = cnt == 0 ? 0 : ((int64_t)cnt - 1 < P - 1 ? (int64_t)cnt - 1 : P - 1);
    if (l == 0 || l == last) {
      uint32_t* row = out + (l == 0 ? 4 : 8);
      if (l == 0 && l == last) {  // both rows
        out[8] = f, out[9] = sid[l], out[10] = kid[l], out[11] = (uint32_t)ori[l];
      }
      row[0] = f, row[1] = sid[l], row[2] = kid[l], row[3] = (uint32_t)ori[l];
    }
  }
  npos = block_sum(npos, smem);
  next = block_sum(next, smem);
  nval = block_sum(nval, smem);
  if (threadIdx.x == 0) {
    atomicAdd(out + 1, npos);
    atomicAdd(out + 2, next);
    atomicAdd(out + 3, 0u - nval);
    if (blockIdx.x == 0) {
      out[0] = cnt;
      atomicAdd(out + 3, cnt);
    }
  }
}

}  // namespace sshash

// C entry for ctypes: head (P,) uint8 over rank space; gate 1 on, 0 off,
// -1 on iff *count > P/64. Returns the launch's cudaError_t.
extern "C" int sshash_stream_heads(const void* mv_f, const void* mv_r, const void* lanes,
                                   const void* count, const void* fbits, int64_t P, int64_t gate,
                                   void* head, void* stream) {
  using namespace sshash;
  if (P <= 0) return (int)cudaGetLastError();
  heads_kernel<<<(unsigned)((P + kDeriveThreads - 1) / kDeriveThreads), kDeriveThreads, 0,
                 (cudaStream_t)stream>>>((const uint64_t*)mv_f, (const uint64_t*)mv_r,
                                         (const int32_t*)lanes, (const int32_t*)count,
                                         (const uint32_t*)fbits, P, (int)gate, (uint8_t*)head);
  return (int)cudaGetLastError();
}

// C entry for ctypes: round2 (P,) uint8; head_mf is P+1 bytes of zeroed
// scratch. Returns the last launch's cudaError_t.
extern "C" int sshash_stream_round2(const void* head, const void* hs, const void* mf,
                                    const void* count, int64_t P, void* head_mf, void* round2,
                                    void* stream) {
  using namespace sshash;
  if (P <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((P + kDeriveThreads - 1) / kDeriveThreads);
  auto s = (cudaStream_t)stream;
  head_mf_kernel<<<blocks, kDeriveThreads, 0, s>>>((const uint8_t*)head, (const int32_t*)hs,
                                                   (const uint8_t*)mf, (const int32_t*)count, P,
                                                   (uint8_t*)head_mf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round2_kernel<<<blocks, kDeriveThreads, 0, s>>>((const uint8_t*)head, (const int32_t*)hs,
                                                  (const int32_t*)count, (const uint8_t*)head_mf,
                                                  P, (uint8_t*)round2);
  return (int)cudaGetLastError();
}

// C entry for ctypes: the found ranks j < *count of either round write
// their lane (round 1 first). Returns the launch's cudaError_t.
extern "C" int sshash_stream_merge(const sshash::MergeIO* io, int64_t P, void* stream) {
  using namespace sshash;
  if (P <= 0) return (int)cudaGetLastError();
  merge_kernel<<<(unsigned)((P + kDeriveThreads - 1) / kDeriveThreads), kDeriveThreads, 0,
                 (cudaStream_t)stream>>>(*io, P);
  return (int)cudaGetLastError();
}

// C entry for ctypes: out (3, 4) u32, zeroed by the caller. Returns the
// launch's cudaError_t.
extern "C" int sshash_stream_count(const void* found, const void* sid, const void* kid,
                                   const void* ori, const void* valid, const void* fbits,
                                   const void* count, int64_t P, void* out, void* stream) {
  using namespace sshash;
  if (P <= 0) return (int)cudaErrorInvalidValue;
  count_kernel<<<(unsigned)((P + kDeriveThreads - 1) / kDeriveThreads), kDeriveThreads, 0,
                 (cudaStream_t)stream>>>((const uint8_t*)found, (const uint32_t*)sid,
                                         (const uint32_t*)kid, (const int32_t*)ori,
                                         (const uint32_t*)valid, (const uint32_t*)fbits,
                                         (const uint32_t*)count, P, (uint32_t*)out);
  return (int)cudaGetLastError();
}
