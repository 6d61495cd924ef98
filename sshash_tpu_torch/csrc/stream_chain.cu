// Stream chain extension: the 15 followers of every anchor, one thread per
// anchor.
//
// Replaces sshash_tpu/streaming.py make_stream_step's phase 2 (:390-435:
// win16 on strings32 and on the packed chunk, charok, instr, the `under`
// guard and the chain prefix-AND) and the per-lane expansion of
// derive_full (:493-503). Plain version: sshash_tpu_torch/streaming.py
// stream_chain_plain.
//
// The anchor's 16 string chars and 16 read chars are consecutive, so the
// thread reads one aligned 2-word window of each (the batched analog of
// the reference's extension cache, streaming_query.hpp:86-100). Follower t
// extends the chain iff it is valid, starts no read or segment, its string
// char equals the read's (complemented on the backward strand) and its
// kmer stays inside the anchor's string; the chain is the prefix-AND. The
// thread writes its 16 lanes: found, string id, kmer id akid +- t (mod
// 2^32), orientation, and need = valid & ~found.
//
// Bound: bytes. Per anchor it reads 7 lookup fields, 4 mask halves and 4
// window words, and writes 14 bytes per lane (about 1 byte read and 14
// written per lane, against a few dozen integer operations).
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

__global__ void chain_kernel(ChainIO io, int64_t A, int k) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= A) return;
  const uint32_t vh = half16(io.valid, g), fh = half16(io.fbits, g), sh = half16(io.sbits, g);
  const int32_t r_a = io.cum_g[g] + (int32_t)(sh & 1u) - 1;
  const uint32_t apos = (uint32_t)(16 * g) + (uint32_t)r_a * (uint32_t)(k - 1);
  const uint32_t aoff = io.aoff[g], asid = io.asid[g], akid = io.akid[g];
  const uint32_t abeg = io.abeg[g], aend = io.aend[g];
  const int32_t aori = io.aori[g];
  const bool fwd = aori == 1;
  const uint32_t k1 = (uint32_t)(k - 1);
  const uint32_t base_s = window_base(aoff, aori, k);
  const uint32_t saw = io.swin ? io.swin[g] : win16(io.strings, io.strings_n, base_s);
  const uint32_t raw = win16(io.words, io.words_n, apos + k1);
  bool m = io.afound[g] && (vh & 1u);
  for (uint32_t t = 0; t < 16; ++t) {
    const bool vt = (vh >> t) & 1u;
    if (t > 0) {
      const uint32_t og = fwd ? aoff + t : aoff - t;
      const bool under = !fwd && aoff < t;
      const uint32_t idx_s = fwd ? t : og - base_s;
      const uint32_t schar = (saw >> ((idx_s & 15u) * 2)) & 3u;
      const uint32_t rchar = (raw >> (2 * t)) & 3u;
      const bool charok = fwd ? schar == rchar : schar == (rchar ^ 2u);
      const bool instr = og >= abeg && og + (uint32_t)k <= aend;
      m = m && vt && !((fh >> t) & 1u) && !((sh >> t) & 1u) && charok && instr && !under;
    }
    const int64_t lane = 16 * g + t;
    io.found[lane] = m;
    io.sid[lane] = asid;
    io.kid[lane] = fwd ? akid + t : akid - t;
    io.ori[lane] = aori;
    io.need[lane] = vt && !m;
  }
}

}  // namespace sshash

// C entry for ctypes: A anchors, lanes 16*A. Returns the launch's
// cudaError_t (0 on success).
extern "C" int sshash_stream_chain(const sshash::ChainIO* io, int64_t A, int64_t k, void* stream) {
  using namespace sshash;
  if (A <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || io->words_n < 1 || (!io->swin && (!io->strings || io->strings_n < 1)))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  chain_kernel<<<(unsigned)((A + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      *io, A, (int)k);
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
