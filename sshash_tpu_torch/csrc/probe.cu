// Kernel 2 (over the whole table, or its shard form), and the whole lookup
// in one kernel: two entries over the per-lane probe body of probe.cuh,
// where the design is set out; the shard form's in shard.cuh.
#include "grid.cuh"
#include "probe.cuh"
#include "shard.cuh"

namespace sshash {

// Kernel 2 over the whole table: every lane stored.
template <int W, bool CANON, bool V2>
__global__ void probe_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  Lane L{false, true, Hit{false, 0, kForward, 0, 0, 0}};
  if (!io.active || io.active[i]) {
    uint32_t km[W], kr[W];
    const ProbeLane pl = load_lane<W, CANON>(p, io, i, km, kr);
    L = probe_lane<W, CANON, V2>(t, p, thread_slot(stage, p), km, kr, io.minval[i], pl.tries,
                                 pl.ntries, nullptr);
  }
  write_result<V2>(io, p, i, L, L.found ? L.res.orient : kForward);
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
//
// Kernel 2: p->store kStoreAll over the whole slot range, or its shard
// form (kStoreOwned, kStorePacked) on one shard's ranges, the hand-off's
// rows in or out in an index with skew classes.
extern "C" int sshash_probe(const sshash::ProbeTables* t, const sshash::ProbeParams* p,
                            const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  static PerDevice per_sm[kMaxFixedW + 1][2][2];  // the shard form's, by width, mode, rows
  if (p->B <= 0) return (int)cudaGetLastError();
  const bool all = p->store == kStoreAll;
  if (bad_params(*t, *p, *io) || (p->canonical && !io->kmers_rc) ||
      ((io->hrow_out || io->hrow_in) && !p->has_skew) ||
      (io->hrow_out && io->hrow_in) || io->count || io->minval_r || io->minpos_r ||
      p->B >= (1ll << 32) || (p->rc_round && p->store != kStoreOwned) ||
      (all && (io->hrow_out || io->hrow_in || p->slot_lo != 0 || p->slot_hi != (1ll << 32))))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return (int)dispatch_probe(*p, [&](auto w, auto c) {
    constexpr int W = decltype(w)::value;
    constexpr bool C = decltype(c)::value;
    if (all) return launch_probe<W, C>(*t, *p, *io, false, s);
    auto& cache = per_sm[W <= kMaxFixedW ? W - 1 : kMaxFixedW][C];
    return p->row_v2 ? launch_shard<W, C, true>(*t, *p, *io, cache[1], s)
                     : launch_shard<W, C, false>(*t, *p, *io, cache[0], s);
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
      p->store != kStoreAll || p->slot_lo != 0 || p->slot_hi != (1ll << 32))
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
