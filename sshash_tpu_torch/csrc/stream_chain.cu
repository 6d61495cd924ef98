// Stream chain extension: the 15 followers of every anchor, one thread per
// lane.
//
// Replaces sshash_tpu/streaming.py make_stream_step's phase 2 (:390-435:
// win16 on strings32 and on the packed chunk, charok, instr, the `under`
// guard and the chain prefix-AND) and the per-lane expansion of
// derive_full (:493-503). Plain version: sshash_tpu_torch/streaming.py
// stream_chain_plain.
//
// Thread 16g + t is lane t of anchor g: a half-warp holds one anchor's 16
// lanes. Every thread reads its anchor's fields and the two aligned 2-word
// windows of its 16 string chars and 16 read chars (the batched analog of
// the reference's extension cache, streaming_query.hpp:86-100); within a
// half-warp these are the same addresses, so each load is one broadcast
// (lane 0's loads passed on by shuffles measured no faster:
// access_chain_ab.py).
// It computes its own follower's condition: follower t > 0 extends the
// chain iff it is valid, starts no read or segment, its string char
// equals the read's (complemented on the backward strand) and its kmer
// stays inside the anchor's string; lane 0's is the anchor's own hit. The
// chain is the prefix-AND over the half-warp, one ballot: lane t is found
// iff lanes 0..t all hold. Each thread writes its own lane's found, string
// id, kmer id akid +- t (mod 2^32), orientation and need = valid & ~found,
// so consecutive threads write consecutive bytes and words and every store
// instruction is coalesced.
//
// Bound: bytes. Per anchor it reads 7 lookup fields, 4 mask halves and 4
// window words, and writes 14 bytes per lane (about 1 byte read and 14
// written per lane, against a few dozen integer operations). One thread
// per anchor, writing its 16 lanes, would make each store instruction
// write 32 addresses 16 lanes apart: 32 sectors for 32-128 bytes (10.5x
// the bound at a 2^22-lane chunk on the H100, PERF.md).
//
// Bucket shards (sshash_tpu/parallel/sharded.py ShardedStream, its swin at
// :431-438): strings32 is split by word range, so the string window comes
// in precomputed. swin_kernel reads each anchor's 16 string chars on the
// shard that owns the window's first word (0 elsewhere; the caller takes
// the unsigned max over the shards), and the chain kernel, given `swin`,
// reads no string. Bound: bytes, 8 read and 4 written per anchor.
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"

namespace sshash {

struct ChainIO {
  const uint8_t* afound;
  const uint32_t* aoff;
  const uint32_t* asid;
  const uint32_t* akid;
  const int32_t* aori;
  const uint32_t* abeg;
  const uint32_t* aend;
  const uint32_t* words;
  int64_t words_n;
  const uint32_t* strings;  // null when swin is given
  int64_t strings_n;
  const uint32_t* valid;
  const uint32_t* sbits;
  const uint32_t* fbits;
  const int32_t* cum_g;
  uint8_t* found;
  uint32_t* sid;
  uint32_t* kid;
  int32_t* ori;
  uint8_t* need;
  const uint32_t* swin;  // (A,) or null: each anchor's string window
};

// chars [base, base+16) as one u32; word reads clip to the array.
__device__ __forceinline__ uint32_t win16(const uint32_t* w, int64_t n, uint32_t base) {
  const int64_t i0 = base >> 4;
  const uint32_t w0 = w[i0 < n ? i0 : n - 1];
  const uint32_t w1 = w[i0 + 1 < n ? i0 + 1 : n - 1];
  const uint32_t sh = (base & 15u) * 2;
  return sh ? (w0 >> sh) | (w1 << (32 - sh)) : w0;
}

__device__ __forceinline__ uint32_t half16(const uint32_t* bits, int64_t g) {
  return (bits[g >> 1] >> (16 * (g & 1))) & 0xFFFFu;
}

// The first string char of an anchor's followers: after the anchor's kmer
// on the forward strand, up to 15 chars before it on the backward one.
__device__ __forceinline__ uint32_t window_base(uint32_t aoff, int32_t aori, int k) {
  return aori == 1 ? aoff + (uint32_t)(k - 1) : aoff - (aoff < 15u ? aoff : 15u);
}

__global__ void swin_kernel(const uint32_t* __restrict__ aoff, const int32_t* __restrict__ aori,
                            int64_t A, const uint32_t* __restrict__ strings, int64_t strings_n,
                            int k, int64_t word_lo, int64_t word_hi,
                            uint32_t* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= A) return;
  const uint32_t base = window_base(aoff[g], aori[g], k);
  const int64_t w0 = base >> 4;
  out[g] = w0 >= word_lo && w0 < word_hi
               ? win16(strings, strings_n, base - 16u * (uint32_t)word_lo)
               : 0u;
}

// What a lane needs of its anchor: the group's valid, first and start
// halves, the lookup fields and the two 16-char windows.
struct Anchor {
  uint32_t vh, fh, sh, aoff, asid, akid, abeg, aend, saw, raw;
  int32_t aori;
  bool afound;
};

__device__ __forceinline__ Anchor load_anchor(const ChainIO& io, int64_t g, int k) {
  Anchor a;
  a.vh = half16(io.valid, g);
  a.fh = half16(io.fbits, g);
  a.sh = half16(io.sbits, g);
  const int32_t r_a = io.cum_g[g] + (int32_t)(a.sh & 1u) - 1;
  const uint32_t apos = (uint32_t)(16 * g) + (uint32_t)r_a * (uint32_t)(k - 1);
  a.aoff = io.aoff[g];
  a.asid = io.asid[g];
  a.akid = io.akid[g];
  a.abeg = io.abeg[g];
  a.aend = io.aend[g];
  a.aori = io.aori[g];
  a.afound = io.afound[g];
  a.saw = io.swin ? io.swin[g] : win16(io.strings, io.strings_n, window_base(a.aoff, a.aori, k));
  a.raw = win16(io.words, io.words_n, apos + (uint32_t)(k - 1));
  return a;
}

// Launched with a multiple of 32 threads a block, so that each half-warp
// is one anchor's; threads past the last anchor join the ballot with a
// false condition and store nothing.
__global__ void __launch_bounds__(256) chain_kernel(ChainIO io, int64_t A, int k) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t g = lane >> 4;
  const uint32_t t = threadIdx.x & 15u;
  const bool in = g < A;
  const Anchor a = in ? load_anchor(io, g, k) : Anchor{};
  const bool fwd = a.aori == 1;
  const bool vt = (a.vh >> t) & 1u;
  bool cond;
  if (t == 0) {
    cond = a.afound && vt;
  } else {
    const uint32_t og = fwd ? a.aoff + t : a.aoff - t;
    const bool under = !fwd && a.aoff < t;
    const uint32_t idx_s = fwd ? t : og - window_base(a.aoff, a.aori, k);
    const uint32_t schar = (a.saw >> ((idx_s & 15u) * 2)) & 3u;
    const uint32_t rchar = (a.raw >> (2 * t)) & 3u;
    const bool charok = fwd ? schar == rchar : schar == (rchar ^ 2u);
    const bool instr = og >= a.abeg && og + (uint32_t)k <= a.aend;
    cond = vt && !((a.fh >> t) & 1u) && !((a.sh >> t) & 1u) && charok && instr && !under;
  }
  // the prefix-AND: lanes 0..t of this half-warp all hold
  const uint32_t h = (__ballot_sync(0xFFFFFFFFu, in && cond) >> (threadIdx.x & 16u)) & 0xFFFFu;
  const bool m = (~h & ((2u << t) - 1u)) == 0u;
  if (!in) return;
  io.found[lane] = m;
  io.sid[lane] = a.asid;
  io.kid[lane] = fwd ? a.akid + t : a.akid - t;
  io.ori[lane] = a.aori;
  io.need[lane] = vt && !m;
}

}  // namespace sshash

// C entry for ctypes: A anchors, lanes 16*A, one thread a lane. Returns
// the launch's cudaError_t (0 on success).
extern "C" int sshash_stream_chain(const sshash::ChainIO* io, int64_t A, int64_t k, void* stream) {
  using namespace sshash;
  if (A <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || io->words_n < 1 || (!io->swin && (!io->strings || io->strings_n < 1)))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  chain_kernel<<<(unsigned)((16 * A + threads - 1) / threads), threads, 0,
                 (cudaStream_t)stream>>>(*io, A, (int)k);
  return (int)cudaGetLastError();
}

// C entry for ctypes: the string window of each of A anchors on one shard.
// Returns the launch's cudaError_t (0 on success).
extern "C" int sshash_stream_swin(const void* aoff, const void* aori, int64_t A,
                                  const void* strings, int64_t strings_n, int64_t k,
                                  int64_t word_lo, int64_t word_hi, void* out, void* stream) {
  using namespace sshash;
  if (A <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || strings_n < 1 || word_lo < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  swin_kernel<<<(unsigned)((A + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)aoff, (const int32_t*)aori, A, (const uint32_t*)strings, strings_n,
      (int)k, word_lo, word_hi, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// C entry for ctypes: resident blocks an SM of the chain kernel, and the
// threads a block.
extern "C" int sshash_chain_occupancy(int* blocks_per_sm, int* threads) {
  *threads = 256;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sshash::chain_kernel,
                                                            *threads, 0);
}
