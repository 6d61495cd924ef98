// Kernel 2, and the whole lookup in one kernel: two entries over the
// per-lane probe body of probe.cuh, where the design is set out.
#include "probe.cuh"

namespace sshash {

template <int W, bool CANON, bool V2>
__global__ void probe_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  Lane L{false, true, Hit{false, 0, kForward, 0, 0, 0}};
  uint32_t hrow = kInvalid32;
  if (!io.active || io.active[i]) {
    const int nw = used_words<W>(p.W);
    uint32_t km[W], kr[W];
    load_kmer(io.kmers, i, nw, km);
#pragma unroll
    for (int w = 0; w < W; ++w) kr[w] = 0u;
    if (CANON) load_kmer(io.kmers_rc, i, nw, kr);
    const uint32_t kmw = (uint32_t)(p.k - p.m);
    uint32_t tries[kMaxTries];
    int ntries = 1;
    tries[0] = (uint32_t)io.minpos[i];
    if (CANON) {
      tries[1] = kmw - tries[0];
      ntries = 2;
      if (io.minpos2) {
        tries[2] = (uint32_t)io.minpos2[i];
        tries[3] = kmw - tries[2];
        ntries = 4;
      }
    }
    if (io.hrow_in) {
      // the hand-off's second pass: the heavy rows this shard holds
      const uint32_t r = io.hrow_in[i];
      if (r >= p.hrow_lo && r < p.hrow_hi) {
        const uint32_t* blk =
            t.sk_hrows + clip_row(r - (uint32_t)p.hrow_lo, t.sk_hrows_n) * p.blk_w;
        L.res = verify_block<W, CANON, V2>(blk, p, km, kr, tries, ntries);
        L.found = L.res.match;
      }
    } else {
      L = probe_lane<W, CANON, V2>(t, p, thread_slot(stage, p), km, kr, io.minval[i], tries,
                                   ntries, io.hrow_out ? &hrow : nullptr);
    }
  }
  write_result<V2>(io, p, i, L, L.found ? L.res.orient : kForward);
  if (io.hrow_out) io.hrow_out[i] = hrow;
}

template <int W, bool CANON, bool V2>
__global__ void __launch_bounds__(256, lookup_min_blocks(W, CANON))
    lookup_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  Lane L{false, true, Hit{false, 0, kForward, 0, 0, 0}};
  int32_t orient = kForward;
  if (!io.active || io.active[i]) {
    uint32_t km[W];
    load_kmer(io.kmers, i, used_words<W>(p.W), km);
    const Minimizers mz = kmer_minimizers<W, true>(km, (int)p.k, (int)p.m, p.magic);
    L = lookup_lane<W, CANON, V2>(t, p, thread_slot(stage, p), km, mz, orient);
  }
  write_result<V2>(io, p, i, L, orient);
}

template <int W, bool CANON>
cudaError_t launch_probe(const ProbeTables& t, const ProbeParams& p, const ProbeIO& io,
                         bool lookup, cudaStream_t stream) {
  const int threads = stage_threads(p);
  const size_t smem = (size_t)threads * stage_stride(2 + (int)p.blk_w) * 4;
  const unsigned blocks = (unsigned)((p.B + threads - 1) / threads);
  if (lookup && p.row_v2)
    lookup_kernel<W, CANON, true><<<blocks, threads, smem, stream>>>(t, p, io);
  else if (lookup)
    lookup_kernel<W, CANON, false><<<blocks, threads, smem, stream>>>(t, p, io);
  else if (p.row_v2)
    probe_kernel<W, CANON, true><<<blocks, threads, smem, stream>>>(t, p, io);
  else
    probe_kernel<W, CANON, false><<<blocks, threads, smem, stream>>>(t, p, io);
  return cudaGetLastError();
}

}  // namespace sshash

// C entries for ctypes. Each returns the launch's cudaError_t (0 on
// success).
extern "C" int sshash_probe(const sshash::ProbeTables* t, const sshash::ProbeParams* p,
                            const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  if (p->B <= 0) return (int)cudaGetLastError();
  if (bad_params(*t, *p, *io) || (p->canonical && !io->kmers_rc) ||
      ((io->hrow_out || io->hrow_in) && !(p->has_skew && p->skew_hrows)) ||
      (io->hrow_out && io->hrow_in) || io->count || io->minval_r || io->minpos_r)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return (int)dispatch_probe(*p, [&](auto w, auto c) {
    return launch_probe<decltype(w)::value, decltype(c)::value>(*t, *p, *io, false, s);
  });
}

// The lookup kernel: io carries kmers, active (or null) and the result
// fields; the minimizer inputs, the RC kmers and the hand-off stay null,
// and the slot range is the whole table.
extern "C" int sshash_lookup(const sshash::ProbeTables* t, const sshash::ProbeParams* p,
                             const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  if (p->B <= 0) return (int)cudaGetLastError();
  if (bad_params(*t, *p, *io) || io->kmers_rc || io->minval || io->minpos || io->minpos2 ||
      io->hrow_out || io->hrow_in || io->count || io->minval_r || io->minpos_r ||
      p->slot_lo != 0 || p->slot_hi != (1ll << 32))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return (int)dispatch_probe(*p, [&](auto w, auto c) {
    return launch_probe<decltype(w)::value, decltype(c)::value>(*t, *p, *io, true, s);
  });
}

// Resident blocks an SM of the lookup kernel (lookup != 0) or kernel 2 for
// these parameters, and the threads a block: the occupancy that the
// registers and the staging slots allow.
extern "C" int sshash_probe_occupancy(const sshash::ProbeParams* p, int64_t lookup,
                                      int* blocks_per_sm, int* threads) {
  using namespace sshash;
  *threads = stage_threads(*p);
  const size_t smem = (size_t)*threads * stage_stride(2 + (int)p->blk_w) * 4;
  return (int)dispatch_probe(*p, [&](auto w, auto c) {
    constexpr int W = decltype(w)::value;
    constexpr bool C = decltype(c)::value;
    const void* fn = lookup ? (p->row_v2 ? (const void*)lookup_kernel<W, C, true>
                                          : (const void*)lookup_kernel<W, C, false>)
                            : (p->row_v2 ? (const void*)probe_kernel<W, C, true>
                                          : (const void*)probe_kernel<W, C, false>);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, *threads, smem);
  });
}
