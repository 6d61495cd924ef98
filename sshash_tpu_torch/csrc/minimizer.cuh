// Both strands' minimizers of one kmer, in registers: the per-lane window
// walk of kernel 1 (minimizer.cu), shared with the lookup kernel
// (probe.cu sshash_lookup), which computes them without writing them out.
//
// The kmer stays in a per-lane word array; the windows walk it word by
// word (an unrolled loop, so every word index is a compile-time constant
// and the words stay in registers), and the window at char j = 16w + c is
// a funnel shift of words w, w+1 and w+2 by 2c bits: an m-mer of m <= 31
// spans at most three words, at any k. The RC kmer is packed.cuh's
// word-array reverse complement (revcomp_words).
//
// Tie rules: the forward scan keeps the leftmost minimum (strict <); the RC
// scan walks the forward windows and keeps the rightmost j (<=), which is
// the leftmost minimum in RC coordinates, reported as k-m-j.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "packed.cuh"
#include "u64.cuh"

namespace sshash {

struct Minimizers {
  uint64_t mv_f, mv_r;  // minimizer values: forward strand, RC strand
  int mp_f, mp_r;       // their positions, each in its own strand's coordinates
};

// The forward strand's minimizer and, when BOTH, the RC strand's, of the
// k-char kmer kw (m <= 31).
template <int W, bool BOTH>
__device__ __forceinline__ Minimizers kmer_minimizers(const uint32_t (&kw)[W], int k, int m,
                                                      uint64_t magic) {
  uint32_t km[W + 2];  // the kmer and two zero words past it
#pragma unroll
  for (int j = 0; j < W + 2; ++j) km[j] = j < W ? kw[j] : 0u;
  const uint64_t mask = (1ull << (2 * m)) - 1;
  const int nwin = k - m + 1;
  uint64_t bf_h = 0, bf_v = 0, br_h = 0, br_v = 0;
  int bf_p = 0, br_j = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (16 * w >= nwin) break;
    const uint64_t lo = km[w] | ((uint64_t)km[w + 1] << 32);
    const uint64_t hi = km[w + 2];
    const int cend = min(16, nwin - 16 * w);
#pragma unroll 1
    for (int c = 0; c < cend; ++c) {
      const int j = 16 * w + c;
      const uint64_t v = (c ? (lo >> (2 * c)) | (hi << (64 - 2 * c)) : lo) & mask;
      const uint64_t h = mixer64(v, magic);
      if (j == 0 || h < bf_h) {
        bf_h = h;
        bf_v = v;
        bf_p = j;
      }
      if (BOTH) {
        const uint64_t vr = revcomp_mmer64(v, m);
        const uint64_t hr = mixer64(vr, magic);
        if (j == 0 || hr <= br_h) {
          br_h = hr;
          br_v = vr;
          br_j = j;
        }
      }
    }
  }
  return {bf_v, br_v, bf_p, k - m - br_j};
}

}  // namespace sshash
