// Kernel 2's shard form and its rank form: the per-lane inputs of kernel
// 2 after kernel 1, the owned and packed stores, the shard form's warp
// queue of owned lanes and its kernel, and the rank form's list pass and
// list probe, with their launches. probe.cu instantiates the shard form
// (sshash_probe), lookup_ranks.cu the rank form (sshash_rank_lists,
// sshash_probe_ranks); two translation units, so that the library's nvcc
// processes build them side by side.
#pragma once
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

// A rank's probe inputs in the rank form, from kernel 1's rank-form
// minimizers of both strands (minimizer.cu sshash_minimizer_ranks), which
// carry no RC kmer: in canonical mode the fold of engine.canonical_fold
// (the smaller minimizer value and its position; on a tie the other
// strand's position too, a repeated one adding nothing) with the RC kmer
// formed here; in regular mode the forward strand, or in the RC round the
// RC kmer (formed here, in km) and the RC strand's minimizer. Sets minval,
// the minimizer whose MPHF slot the rank probes.
template <int W, bool CANON>
__device__ __forceinline__ ProbeLane load_rank(const ProbeParams& p, const ProbeIO& io, int64_t i,
                                               uint32_t (&km)[W], uint32_t (&kr)[W],
                                               uint64_t& minval) {
  const int nw = used_words<W>(p.W);
  const uint32_t kmw = (uint32_t)(p.k - p.m);
  load_kmer(io.kmers, i, nw, km);
  ProbeLane pl;
  if (CANON) {
    const uint64_t mv_f = io.minval[i], mv_r = io.minval_r[i];
    const bool rc_first = mv_r < mv_f;
    const uint32_t mp_r = (uint32_t)io.minpos_r[i];
    const uint32_t mp1 = rc_first ? mp_r : (uint32_t)io.minpos[i];
    const uint32_t mp2 = mv_r == mv_f ? mp_r : mp1;
    revcomp_words(km, (int)p.k, nw, kr);
    minval = rc_first ? mv_r : mv_f;
    pl.tries[0] = mp1;
    pl.tries[1] = kmw - mp1;
    pl.tries[2] = mp2;
    pl.tries[3] = kmw - mp2;
    pl.ntries = mp2 == mp1 ? 2 : 4;
    return pl;
  }
  if (p.rc_round) {
    revcomp_words(km, (int)p.k, nw, kr);
#pragma unroll
    for (int w = 0; w < W; ++w) km[w] = kr[w];
  }
#pragma unroll
  for (int w = 0; w < W; ++w) kr[w] = 0u;
  minval = p.rc_round ? io.minval_r[i] : io.minval[i];
  pl.tries[0] = (uint32_t)(p.rc_round ? io.minpos_r[i] : io.minpos[i]);
  pl.ntries = 1;
  return pl;
}

// The minimizer whose MPHF slot rank i probes in the rank form (load_rank's
// minval, read without the rest), for the list pass.
template <bool CANON>
__device__ __forceinline__ uint64_t rank_minval(const ProbeParams& p, const ProbeIO& io,
                                                int64_t i) {
  if (CANON) {
    const uint64_t mv_f = io.minval[i], mv_r = io.minval_r[i];
    return mv_r < mv_f ? mv_r : mv_f;
  }
  return p.rc_round ? io.minval_r[i] : io.minval[i];
}

// ---- kernel 2's shard form
//
// A lane's MPHF slot has one owner among the bucket shards (their slot
// ranges partition the table), and a heavy lane's sk_hrows row one
// holder. So each shard stores only the lanes it owns:
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
//
// The rank form (RANKS) serves the bucket-sharded stream (ShardedStream):
// the stream's missed lanes, compacted in rank order, and its anchors. It
// replaces, on a shard, the lookup rounds of sshash_tpu/streaming.py
// make_stream_step (run_windows :551-588, derive_corr :631) that
// sshash_tpu/parallel/sharded.py ShardedStream (:376-450) runs through its
// bucket-sharded lookup: they size the work to the misses' count on the
// device, and so does this form. It takes two steps, each over the ranks
// below the device count *io.count only, on grids sized to the card, and
// writes nothing at or past the count; the counts stay on the device, so
// the stream step stays one sequence of launches a CUDA graph replays:
//
//   the list pass (rank_list_kernel, sshash_rank_lists), once for the
//       shards of a mesh row: each rank's active flag (and, in the owned
//       form's RC round and second passes, its found flag), the MPHF slot
//       of each active rank evaluated once (or its handed sk_hrows row
//       read, in the hand-off's second pass), the rank and its key appended
//       to one list if the key is in the range of p (the row's slots or
//       rows; the rank's shard's in the packed form), a warp's entries
//       contiguous, one atomicAdd a tile on the list's device count; and at
//       once the stores of the ranks the list does not take: the inactive
//       ranks' not found with fill, the combine's identity in the packed
//       form;
//   the list probe (shard_list_kernel, sshash_probe_ranks), once over the
//       list: a thread an entry, the shard form's probe and stores at the
//       entry's rank on the tables of the shard owning its key (up to
//       kMaxRowShards of a mesh row's shards, all on one card, in one
//       launch), no queue, the lookup kernel's register budget.
//
// So no shard walks the ranks it does not own, and each active rank's slot
// is evaluated once a round, not once a shard. The list order (blocks race
// for their places) changes no output: each entry's stores are its rank's.
// Its inputs are kernel 1's rank-form minimizers of both strands, which
// carry no RC kmer, so a rank's RC kmer is formed in the thread
// (load_rank), as lookup_lane forms it for lookup_ranks.cu. In the owned
// form it writes the lookup's fields (p.full: the anchors') or the
// stream's five (ids fields and string_id: the misses'); in the packed
// form a regular round's RC strand is probed with rc_round and merged after
// the combine. Bound, a round's launches together: the owned ranks' probe
// (dependent row reads) and each rank's kmer, minimizers and flag read and
// fields written, below the count. Plain versions:
// sshash_tpu_torch/engine.py rank_lists_plain, probe_ranks_plain.
constexpr int kOwnerLanes = 4;
constexpr int kShardQueue = 32 * kOwnerLanes + 32;  // a warp's queue: fewer than 31 + 128

// Lanes a thread tests at a time: kOwnerLanes for kmers of up to 4 words,
// 1 past them, where the lane state of the probe leaves no registers for
// more (widths 5..8 spilled at 4).
__host__ __device__ constexpr int owner_lanes(int W) { return W <= 4 ? kOwnerLanes : 1; }

// Lane i's fields in the shard form: the shared result tensors, or the
// packed buffer in the combine's order and form. minimizer_found only with
// mf. RANKS: the rank form's owned stores may carry the stream's fields.
template <bool V2, bool RANKS>
__device__ __forceinline__ void store_shard(const ProbeIO& io, const ProbeParams& p, int64_t i,
                                            const Lane& L, int32_t orient, bool mf) {
  if (p.store != kStorePacked) {
    write_result<V2, RANKS>(io, p, i, L, orient, mf);
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

// Which of G lanes (i0, i0 + step, ...) below n this launch probes, as a
// bit mask, and their keys (the MPHF slot, or in the hand-off's second pass
// the handed sk_hrows row). Every load of the G lanes is issued before
// the first test, the slots evaluated for every lane (an inactive one's
// is not used), or read from slot_in, where the mesh row's first shard
// stored them (slot_out): a mesh row's shards in stream order evaluate
// each lane's slot once, not once a shard. What the shard does not own it stores at once where it
// must: the identity in the packed form, the inactive lanes as not found
// in the owned form's fill launch.
template <bool CANON, bool V2, int G>
__device__ __forceinline__ unsigned shard_owns(const ProbeTables& t, const ProbeParams& p,
                                               const ProbeIO& io, int64_t i0, int64_t step,
                                               uint32_t (&key)[G]) {
  const bool packed = p.store == kStorePacked;
  const int64_t n = p.B;
  bool in[G], act[G];
  uint64_t mv[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t i = i0 + g * step;
    in[g] = i < n;
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
      store_shard<V2, false>(io, p, i, Lane{false, true, Hit{false, 0, kForward, 0, 0, 0}},
                             kForward, true);
      if (io.hrow_out) io.hrow_out[i] = kInvalid32;
    }
  }
  return own;
}

// The probe of lane i, which this shard owns (key: its slot, or its handed
// row in the second pass), and its stores.
template <int W, bool CANON, bool V2, bool RANKS>
__device__ __forceinline__ void shard_lane(const ProbeTables& t, const ProbeParams& p,
                                           const ProbeIO& io, uint32_t* slot, int64_t i,
                                           uint32_t key) {
  uint32_t km[W], kr[W];
  uint64_t rank_mv = 0;  // the rank form's minimizer (load_rank)
  ProbeLane pl;
  if constexpr (RANKS)
    pl = load_rank<W, CANON>(p, io, i, km, kr, rank_mv);
  else
    pl = load_lane<W, CANON>(p, io, i, km, kr);
  if (io.hrow_in) {
    const uint32_t* blk =
        t.sk_hrows + clip_row(key - (uint32_t)p.hrow_lo, t.sk_hrows_n) * p.blk_w;
    const Hit h = verify_block<W, CANON, V2>(blk, p, km, kr, pl.tries, pl.ntries);
    // the owned form's RC round merges in place: BACKWARD (the rank
    // form's packed RC round merges after the combine)
    const bool merge = p.rc_round && !(RANKS && p.store == kStorePacked);
    if (h.match)
      store_shard<V2, RANKS>(io, p, i, Lane{true, true, h}, merge ? kBackward : h.orient, false);
    return;
  }
  const uint32_t* grow = slot_row(t, p, key);
  const uint32_t* row = stage_head<head_segments(W)>(grow, 2 + (int)p.blk_w, slot);
  uint32_t hrow = kInvalid32;
  const Lane L = probe_row<W, CANON, V2>(t, p, grow, row, km, kr, RANKS ? rank_mv : io.minval[i],
                                         pl.tries, pl.ntries, io.hrow_out ? &hrow : nullptr);
  if (io.hrow_out) io.hrow_out[i] = hrow;
  // the rank form's packed RC round is stored as a first round: the merge
  // follows the combine
  if (!p.rc_round || (RANKS && p.store == kStorePacked)) {
    store_shard<V2, RANKS>(io, p, i, L, L.found ? L.res.orient : kForward, true);
    return;
  }
  io.minimizer_found[i] = io.minimizer_found[i] | L.mfound;
  if (L.found)
    store_shard<V2, RANKS>(io, p, i, L, kBackward, false);
  else
    io.kmer_orientation[i] = kBackward;
}

// 3 blocks of 256 threads an SM (80 registers a thread): the queue's state
// stays live across the probe; 2 at the regular mode's 8 words, which
// spilled 4 bytes at 80 once the skew eval read one row.
template <int W, bool CANON, bool V2>
__global__ void __launch_bounds__(256, W > kMaxFixedW ? 1 : !CANON && W == 8 ? 2 : 3)
    shard_probe_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  uint32_t* slot = thread_slot(stage, p);
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* queue = stage + blockDim.x * stage_stride(2 + (int)p.blk_w) + warp * 2 * kShardQueue;
  int held = 0;  // lanes queued, the same in every thread of the warp
  constexpr int G = owner_lanes(W);
  int64_t base = 32 * G * ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp);
  const int64_t n = p.B;
  for (;;) {
    // take the warp's next 32 x G lanes until 32 owned ones are queued
    for (; held < 32 && base < n; base += 32 * G * warps) {
      uint32_t key[G];
      const unsigned own = shard_owns<CANON, V2, G>(t, p, io, base + lane, 32, key);
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
    if (lane < take)
      shard_lane<W, CANON, V2, false>(t, p, io, slot, queue[lane], queue[kShardQueue + lane]);
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

// ---- kernel 2's rank form: the list pass and the list probe

constexpr int kListRanks = 4;  // ranks a thread of the list pass takes a tile

// The list pass: tiles of kListRanks x blockDim ranks, each thread's ranks
// a block apart (a warp's reads contiguous). Every load of a thread's
// ranks is issued before the first test: their flags, then their keys'
// inputs (kernel 1's minimizers, or the handed rows), then the MPHF's
// pilots (an inactive rank reads rank 0's, unused). The list (io.list, its
// length at *io.list_count) takes the active ranks whose key is in p's
// range (slots, or sk_hrows rows with hrow_in): a warp's places by a
// ballot, the block's warps' by one prefix, the tile's by one atomicAdd on
// the device count (each warp's own atomicAdd lost: shard_ab.py's
// "warpatomic" side).
template <bool CANON>
__global__ void __launch_bounds__(256) rank_list_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  constexpr int G = kListRanks;
  __shared__ int warp_at[32], tile_at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool packed = p.store == kStorePacked;
  // the owned form's RC round and second passes list the ranks not found yet
  const bool unfound = !packed && (p.rc_round || io.hrow_in);
  const int64_t n = misses(io.count, p.B), span = (int64_t)G * blockDim.x;
  for (int64_t t0 = (int64_t)blockIdx.x * span; t0 < n; t0 += (int64_t)gridDim.x * span) {
    int64_t i[G];
    bool act[G], listed[G];
    uint32_t key[G];
    uint64_t mv[G];
    int at[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      i[g] = t0 + g * blockDim.x + threadIdx.x;
      const int64_t r = i[g] < n ? i[g] : 0;
      const bool a = !io.active || io.active[r];
      act[g] = i[g] < n && a && !(unfound && io.found[r]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int64_t r = act[g] ? i[g] : 0;
      if (io.hrow_in)
        key[g] = io.hrow_in[r];
      else
        mv[g] = rank_minval<CANON>(p, io, r);
    }
    if (!io.hrow_in) {
#pragma unroll
      for (int g = 0; g < G; ++g) key[g] = mphf_slot(t, p, mv[g]);
    }
    int held = 0;  // the warp's ranks listed in this tile, the same in every lane
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // the key range read where it is tested (kept in registers through
      // the tile, it made the canonical form spill)
      listed[g] = act[g] && (io.hrow_in ? key[g] >= p.hrow_lo && key[g] < p.hrow_hi
                                        : key[g] >= p.slot_lo && key[g] < p.slot_hi);
      // the ranks the list does not take: not found with fill, or the combine's identity
      if (i[g] < n && !listed[g] && !io.hrow_in && (packed || (!act[g] && p.fill))) {
        store_shard<false, true>(io, p, i[g], Lane{false, true, Hit{false, 0, kForward, 0, 0, 0}},
                                 kForward, true);
        if (io.hrow_out) io.hrow_out[i[g]] = kInvalid32;
      }
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, listed[g]);
      at[g] = held + __popc(mask & ((1u << lane) - 1u));
      held += __popc(mask);
    }
    if (lane == 0) warp_at[warp] = held;
    __syncthreads();
    if (threadIdx.x == 0) {  // the warps' places in the tile, and the tile's in the list
      int sum = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        const int c = warp_at[w];
        warp_at[w] = sum;
        sum += c;
      }
      tile_at = sum ? atomicAdd(io.list_count, sum) : 0;
    }
    __syncthreads();
    const int base = tile_at + warp_at[warp];
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (listed[g])
        reinterpret_cast<uint2*>(io.list)[base + at[g]] = make_uint2((uint32_t)i[g], key[g]);
    __syncthreads();  // warp_at and tile_at are rewritten for the next tile
  }
}

// Blocks of 256 threads an SM that the list probe's launch bounds ask
// registers for: the lookup kernel's (lookup_min_blocks), but 3 at the
// canonical widths of 3 words or more, where the shard form's stores
// beside the probe spilled at 4 (5 words since the skew eval reads one
// row).
__host__ __device__ constexpr int list_min_blocks(int W, bool canon) {
  return W > kMaxFixedW ? 1 : canon && W >= 3 ? 3 : lookup_min_blocks(W, canon);
}

// The shards one list probe launch serves: their tables, and their keys,
// shard j's [lo + j * per, lo + (j + 1) * per) (its slots, or its sk_hrows
// rows in the hand-off's second pass). A mesh row's shards all sit on the
// card of a LocalMesh, so one launch probes every listed rank on its owner
// shard's tables; a row of more shards takes a launch for each
// kMaxRowShards of them (the parameter's tables are a __grid_constant__).
constexpr int kMaxRowShards = 8;

struct RankShards {
  ProbeTables t[kMaxRowShards];
  int64_t n, lo, per;
};

// The list probe: a thread an entry of the list (io.list, its length at
// *io.list_count, read again at each step rather than kept), the shard
// form's probe and stores at the entry's rank on the tables of the shard
// owning its key (p's ranges start at 0: the key is made the shard's own);
// an entry whose shard is not among the launch's is left to another
// launch. One list for a mesh row's shards keeps a warp's entries within a
// few hundred ranks, where a list a shard spread them four times as far
// and its launches' reads and stores over as many more sectors (PERF.md,
// PR 18). No queue's state stays live across the probe.
template <int W, bool CANON>
__global__ void __launch_bounds__(256, list_min_blocks(W, CANON))
    shard_list_kernel(ProbeParams p, ProbeIO io, const __grid_constant__ RankShards s) {
  extern __shared__ uint32_t stage[];
  const uint2* list = reinterpret_cast<const uint2*>(io.list);
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < misses(io.list_count, p.B);
       e += gridDim.x * blockDim.x) {
    const uint2 en = list[e];
    const int64_t d = (int64_t)en.y - s.lo;
    const int64_t j = s.n == 1 ? 0 : d / s.per;
    if (d < 0 || j >= s.n) continue;  // a key no shard of the launch owns
    shard_lane<W, CANON, false, true>(s.t[j], p, io, thread_slot(stage, p), en.x,
                                      (uint32_t)(d - j * s.per));
  }
}

// The list pass's launch: its grid fits the card, or fewer blocks where
// the P ranks (p.B, the most the count can reach) need fewer; the list's
// count zeroed first, in stream order.
template <bool CANON>
static cudaError_t launch_rank_lists(const ProbeTables& t, const ProbeParams& p,
                                     const ProbeIO& io, PerDevice& per_sm, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(io.list_count, 0, 4, stream);
  if (err != cudaSuccess) return err;
  int64_t blocks = 0;
  err = pass_blocks(rank_list_kernel<CANON>, 256, per_sm, (p.B + kListRanks - 1) / kListRanks,
                    &blocks);
  if (err != cudaSuccess) return err;
  rank_list_kernel<CANON><<<(unsigned)blocks, 256, 0, stream>>>(t, p, io);
  return cudaGetLastError();
}

// The list probe's launch, on a grid sized to the card by the longest the
// list can be (p.B).
template <int W, bool CANON>
static cudaError_t launch_list_probe(const ProbeParams& p, const ProbeIO& io,
                                     const RankShards& s, PerDevice& per_sm,
                                     cudaStream_t stream) {
  const int threads = stage_threads(p);
  const size_t smem = (size_t)threads * stage_stride(2 + (int)p.blk_w) * 4;
  int64_t blocks = 0;
  const cudaError_t err =
      pass_blocks(shard_list_kernel<W, CANON>, threads, per_sm, p.B, &blocks, smem);
  if (err != cudaSuccess) return err;
  shard_list_kernel<W, CANON><<<(unsigned)blocks, threads, smem, stream>>>(p, io, s);
  return cudaGetLastError();
}

}  // namespace sshash
