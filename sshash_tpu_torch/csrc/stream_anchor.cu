// Stream masks and k-mer reads: the lane -> read-position map of the
// stream step.
//
// Replaces sshash_tpu/streaming.py make_stream_step's masks and anchors
// (:334-385: segment-start and read-start bits scattered from pstart, the
// per-group popcounts whose scan gives each anchor's segment, apos = 16g +
// r_a(k-1), and the anchor's kmer by ops/packed.py read_kmers_at) and the
// same read for a list of compacted lanes (:557-567). Plain versions:
// sshash_tpu_torch/streaming.py stream_masks_plain and stream_kmers_plain.
//
// masks: one thread per read segment sets its start bit (and its read-start
// bit) with atomicOr; a second launch popcounts each group's 16-bit half.
// kmers: one thread per output row finds its lane's segment from the
// group scan and the group's start bits up to the lane, then reads W words
// (plus one) of the packed chunk, clipped to the buffer, and funnel-shifts
// them; rows past the count are left unwritten, since nothing reads them.
// Widths 1..8 are templates; 9..16 words (k <= 255) run the wide form of
// packed.cuh.
// Counts (nreads, a compaction's size) are read from device memory, so
// nothing waits on the host.
//
// Bound: bytes. masks touch 4 bytes per segment and 4.25 per group; kmers
// read 4(W+1) bytes per row from a buffer that sits in L2 and write 4W,
// for the count's rows only.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace sshash {

__global__ void masks_kernel(const uint32_t* __restrict__ pstart,
                             const uint32_t* __restrict__ rfirst,
                             const uint32_t* __restrict__ nreads, int64_t R, int64_t nwords,
                             uint32_t* __restrict__ sbits, uint32_t* __restrict__ fbits) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R || r >= (int64_t)*nreads) return;
  const uint32_t p = pstart[r];
  if ((int64_t)(p >> 5) >= nwords) return;  // past the bit array: dropped
  const uint32_t bit = 1u << (p & 31);
  atomicOr(sbits + (p >> 5), bit);
  if ((rfirst[r >> 5] >> (r & 31)) & 1u) atomicOr(fbits + (p >> 5), bit);
}

__global__ void group_count_kernel(const uint32_t* __restrict__ sbits, int64_t A,
                                   int32_t* __restrict__ gcnt) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= A) return;
  gcnt[g] = __popc((sbits[g >> 1] >> (16 * (g & 1))) & 0xFFFFu);
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
                             const uint32_t* __restrict__ sbits, const int32_t* __restrict__ cum_g,
                             const int32_t* __restrict__ lanes, const int32_t* __restrict__ count,
                             int64_t n_out, int k, int64_t Wrt, uint32_t* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = count ? (int64_t)*count : n_out;
  if (j >= n_out || j >= n) return;  // rows past the count stay unwritten
  const int nw = used_words<W>(Wrt);
  const uint32_t lane = lanes ? (uint32_t)lanes[j] : (uint32_t)(16 * j);
  const uint32_t pos = lane_position(lane, sbits, cum_g, k);
  const int64_t w0 = pos >> 4;
  const uint32_t sh = 2 * (pos & 15);
  uint32_t g[W + 1], km[W];
#pragma unroll
  for (int w = 0; w <= W; ++w) g[w] = w <= nw ? words[w0 + w < NW ? w0 + w : NW - 1] : 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) km[w] = sh ? (g[w] >> sh) | (g[w + 1] << (32 - sh)) : g[w];
  mask_last_word(km, k, nw);
  store_kmer(out, j, nw, km);
}

template <int W>
cudaError_t launch_kmers(const uint32_t* words, int64_t NW, const uint32_t* sbits,
                         const int32_t* cum_g, const int32_t* lanes, const int32_t* count,
                         int64_t n_out, int k, int64_t Wrt, uint32_t* out, cudaStream_t stream) {
  const int threads = 256;
  kmers_kernel<W><<<(unsigned)((n_out + threads - 1) / threads), threads, 0, stream>>>(
      words, NW, sbits, cum_g, lanes, count, n_out, k, Wrt, out);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes: sbits / fbits (nwords = P/32+1 u32, zeroed by the
// caller) get the segment / read starts of reads r < *nreads; gcnt (A =
// P/16 int32) the segment starts per 16-lane group. Returns the last
// launch's cudaError_t.
extern "C" int sshash_stream_masks(const void* pstart, const void* rfirst, const void* nreads,
                                   int64_t R, int64_t P, void* sbits, void* fbits, void* gcnt,
                                   void* stream) {
  using namespace sshash;
  if (R <= 0 || P <= 0 || P % 32) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  auto s = (cudaStream_t)stream;
  masks_kernel<<<(unsigned)((R + threads - 1) / threads), threads, 0, s>>>(
      (const uint32_t*)pstart, (const uint32_t*)rfirst, (const uint32_t*)nreads, R, P / 32 + 1,
      (uint32_t*)sbits, (uint32_t*)fbits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t A = P / 16;
  group_count_kernel<<<(unsigned)((A + threads - 1) / threads), threads, 0, s>>>(
      (const uint32_t*)sbits, A, (int32_t*)gcnt);
  return (int)cudaGetLastError();
}

// C entry for ctypes: out (n_out, W) gets the kmer at lane lanes[j] (16*j
// when lanes is null) for rows j < *count (n_out when count is null); the
// rows after are not written. Returns the launch's cudaError_t.
extern "C" int sshash_stream_kmers(const void* words, int64_t NW, const void* sbits,
                                   const void* cum_g, const void* lanes, const void* count,
                                   int64_t n_out, int64_t k, void* out, void* stream) {
  using namespace sshash;
  if (n_out <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || NW < 1) return (int)cudaErrorInvalidValue;
  auto w_ = (const uint32_t*)words;
  auto sb = (const uint32_t*)sbits;
  auto cg = (const int32_t*)cum_g;
  auto ln = (const int32_t*)lanes;
  auto c = (const int32_t*)count;
  auto o = (uint32_t*)out;
  auto s = (cudaStream_t)stream;
  const int64_t W = (2 * k + 31) / 32;
  return (int)dispatch_width(W, [&](auto w) {
    return launch_kmers<decltype(w)::value>(w_, NW, sb, cg, ln, c, n_out, (int)k, W, o, s);
  });
}

