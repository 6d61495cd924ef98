// The stream's anchor stage and k-mer reads: the lane -> read-position map
// of the stream step.
//
// Replaces sshash_tpu/streaming.py make_stream_step's masks and anchors
// (:334-385: segment-start and read-start bits scattered from pstart, the
// per-group popcounts whose scan gives each anchor's segment, apos = 16g +
// r_a(k-1), and the anchor's kmer by ops/packed.py read_kmers_at) and the
// same read for a list of compacted lanes (:557-567). Plain versions:
// sshash_tpu_torch/streaming.py stream_anchors_plain (stream_masks_plain,
// the group scan, stream_kmers_plain of the anchors) and stream_kmers_plain.
//
// anchors: one launch, one thread per group of 16 lanes, no atomics and no
// zero fill. The packer gives every read it packs at least one position,
// so pstart[:nreads] rises strictly and a group's segment starts are one
// run of it. Each thread finds the reads before its group's first lane
// (its group's scan entry) by a binary search of pstart[:nreads]
// (log2(nreads) + 1 dependent loads, from L2), walks its run (at most 16
// reads) into its 16-bit halves of the segment-start and read-start bits,
// pairs them with its neighbour's by a shuffle and writes whole words, and
// reads its anchor's kmer. Two more groups cover the bit arrays' last word
// (lanes P..P+31); a start past it is dropped, as JAX's scatter drops it.
// kmers: the misses' read, a thread a row, on a grid sized to the card
// (grid.cuh) whose warps stride up to the count on the device; each row's
// lane finds its segment from the group scan and the group's start bits
// up to the lane, then reads W words (plus one) of the packed chunk,
// clipped to the buffer, and funnel-shifts them; rows past the count are
// left unwritten, since nothing reads them.
// Both store their (n, W) rows through packed.cuh store_rows: a warp's
// stores cover contiguous bytes (rows of 1, 2, 4 and 8 words as vectors,
// the other widths staged in shared memory), and no block barrier.
// Widths 1..8 are templates; 9..16 words (k <= 255) run the wide form of
// packed.cuh. Counts (nreads, the misses) are read from device memory, so
// nothing waits on the host.
//
// Bound: bytes. anchors read pstart (4 bytes a read) and rfirst, write
// 8.25 bytes of bits and scan a group and W words an anchor, and read the
// chunk words that the anchors' reads touch; kmers read, for the count's
// rows only, a lane and its group's scan entry and bit word and write W
// words a row, and read the chunk words that the rows touch. The chunk
// sits in L2 and neighbouring reads share W of their W + 1 words, so each
// chunk word counts once.
#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"
#include "packed.cuh"

namespace sshash {

// The k-char kmer at char position pos of the packed chunk words (NW
// words; reads past the end clip to the last word).
template <int W>
__device__ __forceinline__ void read_kmer(const uint32_t* __restrict__ words, int64_t NW,
                                          uint32_t pos, int k, int nw, uint32_t (&km)[W]) {
  const int64_t w0 = pos >> 4;
  const uint32_t sh = 2 * (pos & 15);
  uint32_t g[W + 1];
#pragma unroll
  for (int w = 0; w <= W; ++w) g[w] = w <= nw ? words[w0 + w < NW ? w0 + w : NW - 1] : 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) km[w] = sh ? (g[w] >> sh) | (g[w + 1] << (32 - sh)) : g[w];
  mask_last_word(km, k, nw);
}

template <int W>
__global__ void anchors_kernel(const uint32_t* __restrict__ pstart,
                               const uint32_t* __restrict__ rfirst,
                               const uint32_t* __restrict__ nreads, int64_t R, int64_t A,
                               const uint32_t* __restrict__ words, int64_t NW, int k,
                               int64_t Wrt, uint32_t* __restrict__ sbits,
                               uint32_t* __restrict__ fbits, int32_t* __restrict__ cum_g,
                               uint32_t* __restrict__ out) {
  __shared__ RowStage<W> stage;
  const int nw = used_words<W>(Wrt);
  const int64_t g = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
  const bool live = g < A + 2;  // the groups of the P/32 + 1 bit words
  const uint32_t v = (uint32_t)(16 * g);
  const int64_t nr = (int64_t)*nreads < R ? (int64_t)*nreads : R;
  const int lane = threadIdx.x & 31;
  // a: the reads that start before lane v (pstart[:nr] rises strictly), by
  // a binary search of it
  int64_t a = 0;
  if (live) {
    for (int64_t step = nr ? (int64_t)1 << (63 - __clzll(nr)) : 0; step; step >>= 1)
      if (a + step <= nr && pstart[a + step - 1] < v) a += step;
  }
  uint32_t sh = 0, fh = 0;
  if (live) {
    for (int64_t r = a; r < nr && r < a + 16; ++r) {
      const uint32_t d = pstart[r] - v;
      if (d >= 16) break;
      sh |= 1u << d;
      fh |= ((rfirst[r >> 5] >> (r & 31)) & 1u) << d;
    }
  }
  // group g + 1's halves (the same warp: groups come in pairs, warps too)
  const uint32_t sh1 = __shfl_down_sync(0xFFFFFFFFu, sh, 1);
  const uint32_t fh1 = __shfl_down_sync(0xFFFFFFFFu, fh, 1);
  if (live && !(g & 1)) {
    sbits[g >> 1] = sh | (sh1 << 16);
    fbits[g >> 1] = fh | (fh1 << 16);
  }
  const bool anchor = g < A;
  uint32_t km[W] = {};
  if (anchor) {
    cum_g[g] = (int32_t)a;
    // the anchor's segment: the last one starting at or before lane v
    const int32_t r = (int32_t)a + (int32_t)(sh & 1u) - 1;
    read_kmer(words, NW, v + (uint32_t)r * (uint32_t)(k - 1), k, nw, km);
  }
  const int64_t left = A - (g - lane);  // the warp's rows
  store_rows(out, g - lane, (int)(left < 0 ? 0 : left < 32 ? left : 32), nw, anchor, km, stage);
}

// Char position of a lane: lane + r(k-1), r = its segment.
__device__ __forceinline__ uint32_t lane_position(uint32_t lane, const uint32_t* sbits,
                                                  const int32_t* cum_g, int k) {
  const uint32_t g = lane >> 4, t = lane & 15;
  const uint32_t half = (sbits[g >> 1] >> (16 * (g & 1))) & ((2u << t) - 1u);
  const int32_t r = cum_g[g] + __popc(half) - 1;
  return lane + (uint32_t)r * (uint32_t)(k - 1);
}

template <int W>
__global__ void kmers_kernel(const uint32_t* __restrict__ words, int64_t NW,
                             const uint32_t* __restrict__ sbits,
                             const int32_t* __restrict__ cum_g,
                             const int32_t* __restrict__ lanes,
                             const int32_t* __restrict__ count, int64_t P, int k, int64_t Wrt,
                             uint32_t* __restrict__ out) {
  __shared__ RowStage<W> stage;
  const int nw = used_words<W>(Wrt);
  const int64_t n = misses(count, P);
  const int lane = threadIdx.x & 31;
  // each warp strides over 32-row tiles on its own
  for (int64_t row0 = (int64_t)blockIdx.x * kRowThreads + (threadIdx.x - lane); row0 < n;
       row0 += (int64_t)gridDim.x * kRowThreads) {
    const int64_t j = row0 + lane;
    uint32_t km[W] = {};
    if (j < n)
      read_kmer(words, NW, lane_position((uint32_t)lanes[j], sbits, cum_g, k), k, nw, km);
    store_rows(out, row0, (int)(n - row0 < 32 ? n - row0 : 32), nw, j < n, km, stage);
  }
}

}  // namespace sshash

// C entry for ctypes: the anchor stage of a chunk of P lanes (P a multiple
// of 32) from the reads r < *nreads (at most R): sbits / fbits (P/32 + 1
// u32, every word written) get the segment / read starts, cum_g (A = P/16
// int32) the segment starts before each group of 16 lanes, out (A, W,
// 16-byte aligned) the kmer at each group's first lane. Needs pstart[:*nreads] strictly rising
// (every read at least one position). Returns the launch's cudaError_t.
extern "C" int sshash_stream_anchors(const void* pstart, const void* rfirst, const void* nreads,
                                     int64_t R, int64_t P, const void* words, int64_t NW,
                                     int64_t k, void* sbits, void* fbits, void* cum_g, void* out,
                                     void* stream) {
  using namespace sshash;
  if (R <= 0 || P <= 0 || P % 32 || P >= (int64_t)1 << 31 || NW < 1 || k < 1 || k > kMaxK ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t A = P / 16, W = (2 * k + 31) / 32;
  const unsigned blocks = (unsigned)((A + 2 + kRowThreads - 1) / kRowThreads);
  return (int)dispatch_width(W, [&](auto w) {
    anchors_kernel<decltype(w)::value><<<blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pstart, (const uint32_t*)rfirst, (const uint32_t*)nreads, R, A,
        (const uint32_t*)words, NW, (int)k, W, (uint32_t*)sbits, (uint32_t*)fbits,
        (int32_t*)cum_g, (uint32_t*)out);
    return cudaGetLastError();
  });
}

// C entry for ctypes: out (P, W, 16-byte aligned) gets the kmer at lane
// lanes[j] for rows j < *count (clamped to [0, P]); the rows after are not
// written. Returns
// the launch's cudaError_t.
extern "C" int sshash_stream_kmers(const void* words, int64_t NW, const void* sbits,
                                   const void* cum_g, const void* lanes, const void* count,
                                   int64_t P, int64_t k, void* out, void* stream) {
  using namespace sshash;
  static PerDevice per_sm[kMaxFixedW + 1];  // by kernel width
  if (P <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || NW < 1 || !lanes || !count || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t W = (2 * k + 31) / 32;
  return (int)dispatch_width(W, [&](auto w) {
    constexpr int WW = decltype(w)::value;
    int64_t blocks = 0;
    const cudaError_t err = pass_blocks(kmers_kernel<WW>, kRowThreads,
                                        per_sm[WW <= kMaxFixedW ? WW - 1 : kMaxFixedW], P,
                                        &blocks);
    if (err != cudaSuccess) return err;
    kmers_kernel<WW><<<(unsigned)blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, NW, (const uint32_t*)sbits, (const int32_t*)cum_g,
        (const int32_t*)lanes, (const int32_t*)count, P, (int)k, W, (uint32_t*)out);
    return cudaGetLastError();
  });
}
