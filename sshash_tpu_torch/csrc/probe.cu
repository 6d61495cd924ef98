// Kernel 2 (over the whole table, or its shard form), and the whole lookup
// in one kernel: two entries over the per-lane probe body of probe.cuh,
// where the design is set out; the shard form's below.
#include "grid.cuh"
#include "probe.cuh"

namespace sshash {

// A lane's probe inputs after kernel 1: its kmer (and reverse complement in
// canonical mode) and position tries.
struct ProbeLane {
  int ntries;
  uint32_t tries[kMaxTries];
};

template <int W, bool CANON>
__device__ __forceinline__ ProbeLane load_lane(const ProbeParams& p, const ProbeIO& io, int64_t i,
                                               uint32_t (&km)[W], uint32_t (&kr)[W]) {
  const int nw = used_words<W>(p.W);
  load_kmer(io.kmers, i, nw, km);
#pragma unroll
  for (int w = 0; w < W; ++w) kr[w] = 0u;
  if (CANON) load_kmer(io.kmers_rc, i, nw, kr);
  const uint32_t kmw = (uint32_t)(p.k - p.m);
  ProbeLane pl;
  pl.ntries = 1;
  pl.tries[0] = (uint32_t)io.minpos[i];
  if (CANON) {
    pl.tries[1] = kmw - pl.tries[0];
    pl.ntries = 2;
    if (io.minpos2) {
      pl.tries[2] = (uint32_t)io.minpos2[i];
      pl.tries[3] = kmw - pl.tries[2];
      pl.ntries = 4;
    }
  }
  return pl;
}

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

// ---- kernel 2's shard form
//
// A lane's MPHF slot has one owner among the bucket shards (their slot
// ranges partition the table), and an hindex heavy lane's sk_hrows row
// one holder. So each shard stores only the lanes it owns:
//
//   kStoreOwned   (LocalMesh: every shard of a mesh row on this card) into
//       result tensors the row's shards share, launched in stream order,
//       so plain stores suffice: the first pass stores the lanes whose
//       slot the shard owns (and, with fill, the inactive lanes, as not
//       found); the hand-off's second pass only the hits of the rows it
//       holds (the first pass stored those lanes as not found, with
//       minimizer_found); the regular mode's RC round (rc_round) the lanes
//       the forward round left unfound whose RC slot it owns, merged in
//       place as engine._merge merges: BACKWARD, minimizer_found ORed with
//       the forward round's, the hit's fields where the RC probe finds the
//       lane. No combine follows.
//   kStorePacked  (DistMesh: one shard a rank) every lane into the packed
//       (F, B) int32 buffer of the mesh's combine (u32 fields with the top
//       bit flipped, then orientation, minimizer_found, -found), the
//       combine's identity on the lanes the shard does not own; the second
//       pass stores its hits over it (each at most the identity, so a
//       store is the min). One all_reduce MIN combines the ranks.
//
// Unowned lanes: each warp takes 128 lanes at a time (owner_lanes(W) a
// thread, every load of them issued before the first test), evaluates
// their MPHF slots (or reads the row's first shard's, or their handed
// rows), queues the lanes it owns in shared memory (a ballot and a prefix
// count) and probes when 32 are queued, so no warp probes for a quarter of
// its lanes while the rest wait, on a grid sized to the card (grid.cuh).
// shard_ab.py keeps the designs that lost: a thread a lane on the same grid
// ("exit"), and a thread a lane on a grid of one lane a thread ("simple").
constexpr int kOwnerLanes = 4;
constexpr int kShardQueue = 32 * kOwnerLanes + 32;  // a warp's queue: fewer than 31 + 128

// Lanes a thread tests at a time: kOwnerLanes for kmers of up to 4 words,
// 1 past them, where the lane state of the probe leaves no registers for
// more (widths 5..8 spilled at 4).
__host__ __device__ constexpr int owner_lanes(int W) { return W <= 4 ? kOwnerLanes : 1; }

// Lane i's fields in the shard form: the shared result tensors, or the
// packed buffer in the combine's order and form. minimizer_found only with mf.
template <bool V2>
__device__ __forceinline__ void store_shard(const ProbeIO& io, const ProbeParams& p, int64_t i,
                                            const Lane& L, int32_t orient, bool mf) {
  if (p.store != kStorePacked) {
    write_result<V2>(io, p, i, L, orient, mf);
    return;
  }
  const Fields f = lane_fields<V2>(p, L);
  int32_t* q = io.packed + i;
  const int64_t B = p.B;
  const auto put = [&](uint32_t v) {
    *q = (int32_t)(v ^ 0x80000000u);
    q += B;
  };
  put(f.kid);
  if (!V2 && p.full) {
    put(f.kis);
    put(f.off);
    put(f.sid);
    put(f.begin);
    put(f.end);
  }
  q[0] = orient;
  if (mf) q[B] = L.mfound;
  q[2 * B] = -(int32_t)L.found;
}

// Which of G lanes (i0, i0 + step, ...) this launch probes, as a bit
// mask, and their keys (the MPHF slot, or in the hand-off's second pass
// the handed sk_hrows row). Every load of the G lanes is issued before
// the first test, the slots evaluated for every lane (an inactive one's
// is not used), or read from slot_in, where the mesh row's first shard
// stored them (slot_out): a mesh row's shards in stream order evaluate
// each lane's slot once, not once a shard. What the shard does not own it stores at once where it
// must: the identity in the packed form, the inactive lanes as not found
// in the owned form's fill launch.
template <bool V2, int G>
__device__ __forceinline__ unsigned shard_owns(const ProbeTables& t, const ProbeParams& p,
                                               const ProbeIO& io, int64_t i0, int64_t step,
                                               uint32_t (&key)[G]) {
  const bool packed = p.store == kStorePacked;
  bool in[G], act[G];
  uint64_t mv[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t i = i0 + g * step;
    in[g] = i < p.B;
    act[g] = in[g] && (!io.active || io.active[i]);
  }
  // the owned form's RC round and second passes: the lanes not found yet
  if (!packed && (p.rc_round || io.hrow_in)) {
#pragma unroll
    for (int g = 0; g < G; ++g) act[g] = act[g] && !io.found[i0 + g * step];
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t i = in[g] ? i0 + g * step : 0;
    if (io.hrow_in)
      key[g] = io.hrow_in[i];
    else if (io.slot_in)
      key[g] = io.slot_in[i];
    else
      mv[g] = io.minval[i];
  }
  unsigned own = 0;
  if (io.hrow_in) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      own |= (unsigned)(act[g] && key[g] >= p.hrow_lo && key[g] < p.hrow_hi) << g;
    return own;
  }
  if (!io.slot_in) {
#pragma unroll
    for (int g = 0; g < G; ++g) key[g] = mphf_slot(t, p, mv[g]);
    if (io.slot_out) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (act[g]) io.slot_out[i0 + g * step] = key[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t i = i0 + g * step;
    const bool mine = act[g] && key[g] >= p.slot_lo && key[g] < p.slot_hi;
    own |= (unsigned)mine << g;
    if (in[g] && !mine && (packed || (!act[g] && p.fill))) {
      store_shard<V2>(io, p, i, Lane{false, true, Hit{false, 0, kForward, 0, 0, 0}}, kForward,
                      true);
      if (io.hrow_out) io.hrow_out[i] = kInvalid32;
    }
  }
  return own;
}

// The probe of lane i, which this shard owns (key: its slot, or its handed
// row in the second pass), and its stores.
template <int W, bool CANON, bool V2>
__device__ __forceinline__ void shard_lane(const ProbeTables& t, const ProbeParams& p,
                                           const ProbeIO& io, uint32_t* slot, int64_t i,
                                           uint32_t key) {
  uint32_t km[W], kr[W];
  const ProbeLane pl = load_lane<W, CANON>(p, io, i, km, kr);
  if (io.hrow_in) {
    const uint32_t* blk =
        t.sk_hrows + clip_row(key - (uint32_t)p.hrow_lo, t.sk_hrows_n) * p.blk_w;
    const Hit h = verify_block<W, CANON, V2>(blk, p, km, kr, pl.tries, pl.ntries);
    if (h.match)
      store_shard<V2>(io, p, i, Lane{true, true, h}, p.rc_round ? kBackward : h.orient, false);
    return;
  }
  const uint32_t* grow = slot_row(t, p, key);
  const uint32_t* row = stage_head<head_segments(W)>(grow, 2 + (int)p.blk_w, slot);
  uint32_t hrow = kInvalid32;
  const Lane L = probe_row<W, CANON, V2>(t, p, grow, row, km, kr, io.minval[i], pl.tries,
                                         pl.ntries, io.hrow_out ? &hrow : nullptr);
  if (io.hrow_out) io.hrow_out[i] = hrow;
  if (!p.rc_round) {
    store_shard<V2>(io, p, i, L, L.found ? L.res.orient : kForward, true);
    return;
  }
  io.minimizer_found[i] = io.minimizer_found[i] | L.mfound;
  if (L.found)
    store_shard<V2>(io, p, i, L, kBackward, false);
  else
    io.kmer_orientation[i] = kBackward;
}

// 3 blocks of 256 threads an SM (80 registers a thread): the queue's state
// stays live across the probe, as in lookup_ranks.cu.
template <int W, bool CANON, bool V2>
__global__ void __launch_bounds__(256, W > kMaxFixedW ? 1 : 3)
    shard_probe_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  uint32_t* slot = thread_slot(stage, p);
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* queue = stage + blockDim.x * stage_stride(2 + (int)p.blk_w) + warp * 2 * kShardQueue;
  int held = 0;  // lanes queued, the same in every thread of the warp
  constexpr int G = owner_lanes(W);
  int64_t base = 32 * G * ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp);
  for (;;) {
    // take the warp's next 32 x G lanes until 32 owned ones are queued
    for (; held < 32 && base < p.B; base += 32 * G * warps) {
      uint32_t key[G];
      const unsigned own = shard_owns<V2, G>(t, p, io, base + lane, 32, key);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const bool mine = (own >> g) & 1u;
        const unsigned mask = __ballot_sync(0xFFFFFFFFu, mine);
        if (mine) {
          const int at = held + __popc(mask & ((1u << lane) - 1u));
          queue[at] = (uint32_t)(base + 32 * g + lane);
          queue[kShardQueue + at] = key[g];
        }
        held += __popc(mask);
      }
    }
    if (held == 0) break;
    __syncwarp();
    const int take = held < 32 ? held : 32;  // 32, or the last lanes
    if (lane < take) shard_lane<W, CANON, V2>(t, p, io, slot, queue[lane], queue[kShardQueue + lane]);
    __syncwarp();
    // the rest (at most 127) move down by 32: each lane moves the entries
    // at its own index mod 32, so no lane reads what another writes
    for (int r = lane; r < held - take; r += 32) {
      queue[r] = queue[r + take];
      queue[kShardQueue + r] = queue[kShardQueue + r + take];
    }
    held -= take;
    __syncwarp();
  }
}

// Shared memory of a shard-form block: the staging slots and a queue a warp.
inline size_t shard_smem(const ProbeParams& p, int threads) {
  return (size_t)threads * stage_stride(2 + (int)p.blk_w) * 4 +
         (size_t)(threads / 32) * 2 * kShardQueue * 4;
}

inline int shard_threads(const ProbeParams& p) {
  return shard_smem(p, 256) <= 48 * 1024 ? 256 : 128;
}

// static: the occupancy cache passed in stays this library's
template <int W, bool CANON, bool V2>
static cudaError_t launch_shard(const ProbeTables& t, const ProbeParams& p, const ProbeIO& io,
                                PerDevice& per_sm, cudaStream_t stream) {
  const int threads = shard_threads(p);
  const size_t smem = shard_smem(p, threads);
  int64_t blocks = 0;
  const cudaError_t err =
      pass_blocks(shard_probe_kernel<W, CANON, V2>, threads, per_sm, p.B, &blocks, smem);
  if (err != cudaSuccess) return err;
  shard_probe_kernel<W, CANON, V2><<<(unsigned)blocks, threads, smem, stream>>>(t, p, io);
  return cudaGetLastError();
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
// rows in or out in an hindex index.
extern "C" int sshash_probe(const sshash::ProbeTables* t, const sshash::ProbeParams* p,
                            const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  static PerDevice per_sm[kMaxFixedW + 1][2][2];  // the shard form's, by width, mode, rows
  if (p->B <= 0) return (int)cudaGetLastError();
  const bool all = p->store == kStoreAll;
  if (bad_params(*t, *p, *io) || (p->canonical && !io->kmers_rc) ||
      ((io->hrow_out || io->hrow_in) && !(p->has_skew && p->skew_hrows)) ||
      (io->hrow_out && io->hrow_in) || io->count || io->minval_r || io->minpos_r ||
      p->B >= (1ll << 32) ||
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
