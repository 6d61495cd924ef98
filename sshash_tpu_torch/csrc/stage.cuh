// Row staging: a thread copies the head of a table row into its slot of
// shared memory with 16-byte loads of the aligned segments that cover it,
// every load issued before the first store, and reads the row from there
// at per-lane offsets (kernel 2 and the lookup kernel, probe.cu; access,
// access.cu). A warp's word-at-a-time loads from 32 random rows each cost
// 32 L1 wavefronts and find the rows evicted between them; registers
// would need a select chain per read at a runtime offset.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

namespace sshash {

// Words of a thread's shared-memory slot for a row head of n words: the
// 16-byte segments covering it (at most (n + 6) / 4 of them, the row
// starting at any word of a segment) and 3 words of slack before them;
// odd, so that the slots of a warp's threads start on 32 different banks.
__host__ __device__ __forceinline__ int stage_stride(int n) {
  return (3 + 4 * ((n + 6) >> 2)) | 1;
}

// The most segments a row head takes at kernel width W: status, cw_a and
// a candidate block of 1 + Wv + Ww + 4 words, with Wv <= (16W + 31) / 32
// and Ww <= 2W + 1 for any k of W words and m >= 1 (layout.py StaticCfg).
__host__ __device__ constexpr int head_segments(int W) {
  return (8 + 2 * W + (16 * W + 31) / 32 + 6) >> 2;
}

// Copy the first n words of the row at g into this thread's slot with
// 16-byte loads of the aligned segments that cover them (every load
// issued before the first store); returns the slot's view of the row,
// word i at [i]. A segment holding one byte of the table lies in its
// allocation, so the words it carries before or after the row read
// nothing out of bounds.
template <int NQ>
__device__ __forceinline__ const uint32_t* stage_head(const uint32_t* g, int n, uint32_t* slot) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const int o = (int)((a >> 2) & 3u);  // the row's first word in its segment
  const uint4* src = reinterpret_cast<const uint4*>(a - 4u * o);
  const int nq = (o + n + 3) >> 2;
  uint32_t* dst = slot + 3 - o;
#pragma unroll
  for (int q0 = 0; q0 < NQ; q0 += 4) {
    uint4 c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q0 + q < NQ && q0 + q < nq) c[q] = __ldg(src + q0 + q);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q0 + q < NQ && q0 + q < nq) {
        uint32_t* d = dst + 4 * (q0 + q);
        d[0] = c[q].x;
        d[1] = c[q].y;
        d[2] = c[q].z;
        d[3] = c[q].w;
      }
  }
  return slot + 3;
}

}  // namespace sshash
