// The stream's lookup of its missed lanes in rank space: the lookup
// kernel's lane (probe.cuh lookup_lane: the canonical fold or the regular
// mode's RC retry, then the probe) over the ranks below the misses'
// device count, from kernel 1's rank-form minimizers.
//
// Replaces the lookup rounds of sshash_tpu/streaming.py make_stream_step:
// run_windows (:551-588) and derive_corr (:631), which size the work to the
// misses by looping windows of Wp lanes up to their count in a device
// while_loop. Here a grid sized to the card (grid.cuh) walks the ranks j <
// *count of the compacted (P, W) kmers; the count stays on the device, so
// the step is one sequence of launches a CUDA graph replays. Ranks at or
// past the count are not written. A rank below it that is not active
// reports not found (found and minimizer_found 0, kmer and string id
// 0xFFFFFFFF, orientation FORWARD); an active rank (a run head in round 1,
// a round-2 rank in round 2) is looked up from both strands' minimizers:
// those kernel 1's rank form (minimizer.cu) computed for every rank below
// the count (the run-skip heads need them all), or at few windows the same
// walk again in the thread (below). The fields written are the
// five the stream reads (streaming.stream_round2 and stream_merge: found,
// minimizer_found, string_id, kmer_id, kmer_orientation), where the lookup
// kernel's full form writes nine; JAX's run_windows likewise carries
// packed kid and orientation, sid and mf. Plain version:
// sshash_tpu_torch/engine.py lookup_ranks_plain.
//
// Active ranks are scattered: at low hit a quarter of the ranks in round 1
// and a few thousand in round 2. A thread a rank would run each warp's
// lookup for its one or two active lanes while the rest wait. So each warp
// takes 32 ranks at a time, writes the inactive ones at once, queues the
// active ones in shared memory (a ballot and a prefix count) and runs the
// lookup only when 32 are queued, every lane on an active rank; the last
// partial queue runs at the end. stream_ab.py keeps the designs that lost
// to it at the low-hit, mixed and 100M high-hit chunks (PERF.md): a
// block's tile of ranks compacted with one block-wide prefix, a thread an
// entry, nothing carried between tiles ("tiles", and "tiles4" at 4 blocks
// an SM); a warp's tile compacted by a ballot ("warptile"); a list pass
// and a lookup launch over the list ("lists"); this queue at 4 blocks an
// SM where the lookup kernel takes them ("queued4"); a thread a rank over
// a grid-stride loop ("strided"). The queue's registers (3 blocks an SM)
// do not hold it back: at 4 blocks it is no faster.
//
// Kernel 1's minimizers or the walk: an active rank's 24 bytes of
// minimizers are a scattered read; walking its k-m+1 windows again costs
// integer work. On the misses' kernels the walk was 8-10% faster at 15
// windows (k31 m17, low-hit and mixed reads), 1 us slower at 11 (k31 m21,
// 1,512 ranks; the step unchanged) and 57% slower at 41 (k65 m25), in
// stream_ab.py (sides "walk" and "read"), so a kmer of at most
// kWalkWindows windows walks (JAX's own cut for its fused two-strand scan,
// ops/packed.py compute_minimizer_two_strand, is the same 24) and a longer
// one reads. Such a kmer has at most 54 chars (m <= 31): 4 words, so only
// widths 1..4 build the walking form.
//
// Bound: the active ranks' probe (dependent row reads, as the lookup
// kernel's) and 24 bytes of minimizers and the kmer each; 14 bytes written
// and one flag read a rank below the count. Kmers of 1..8 words are
// templates; 9..16 run the wide form. The stream needs v1 rows, so no v2
// form is built.
#include "grid.cuh"
#include "probe.cuh"
#include "shard.cuh"

namespace sshash {

constexpr int kQueue = 64;  // a warp's queue of active ranks: fewer than 32 + 32
constexpr int kWalkWindows = 24;  // the most windows a rank walks again
constexpr int kWalkMaxW = 4;      // the widest kmer of so few windows: 54 chars

__device__ __forceinline__ void write_not_found(const ProbeIO& io, int64_t i) {
  io.kmer_id[i] = kInvalid32;
  io.kmer_orientation[i] = kForward;
  io.minimizer_found[i] = 0;
  io.found[i] = 0;
  io.string_id[i] = kInvalid32;
}

// The lookup of active rank i, from kernel 1's minimizers of its kmer:
// walked again (WALK) or read.
template <int W, bool CANON, bool WALK>
__device__ __forceinline__ void lookup_rank(const ProbeTables& t, const ProbeParams& p,
                                            const ProbeIO& io, uint32_t* slot, int64_t i) {
  uint32_t km[W];
  load_kmer(io.kmers, i, used_words<W>(p.W), km);
  Minimizers mz;
  if constexpr (WALK)
    mz = kmer_minimizers<W, true>(km, (int)p.k, (int)p.m, p.magic);
  else
    mz = Minimizers{io.minval[i], io.minval_r[i], io.minpos[i], io.minpos_r[i]};
  int32_t orient = kForward;
  const Lane L = lookup_lane<W, CANON, false>(t, p, slot, km, mz, orient);
  write_stream_result(io, p, i, L, orient);
}

// 3 blocks of 256 threads an SM (80 registers a thread), at every fixed
// width: the queue's state stays live across the lookup, and at the
// lookup kernel's 4 blocks (64 registers) the narrow canonical widths
// spilled; 2 blocks at the regular mode's 6-8 words, which spilled 4-8
// bytes at 80 once the skew eval read one row.
template <int W, bool CANON, bool WALK>
__global__ void __launch_bounds__(256, W > kMaxFixedW ? 1 : !CANON && W >= 6 ? 2 : 3)
    lookup_ranks_kernel(ProbeTables t, ProbeParams p, ProbeIO io) {
  extern __shared__ uint32_t stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = misses(io.count, p.B), warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  uint32_t* slot = thread_slot(stage, p);
  int32_t* queue = reinterpret_cast<int32_t*>(stage + blockDim.x * stage_stride(2 + (int)p.blk_w)) +
                   warp * kQueue;
  int held = 0;  // ranks queued, the same in every lane
  int64_t base = 32 * ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp);
  for (;;) {
    // take the warp's next 32 ranks until 32 active ones are queued
    for (; held < 32 && base < n; base += 32 * warps) {
      const int64_t i = base + lane;
      const bool in = i < n, on = in && io.active[i];
      if (in && !on) write_not_found(io, i);
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, on);
      if (on) queue[held + __popc(mask & ((1u << lane) - 1u))] = (int32_t)i;
      held += __popc(mask);
    }
    if (held == 0) break;
    __syncwarp();
    const int take = held < 32 ? held : 32;  // 32, or the last ranks
    if (lane < take) lookup_rank<W, CANON, WALK>(t, p, io, slot, queue[lane]);
    __syncwarp();
    if (lane < held - take) queue[lane] = queue[lane + take];
    held -= take;
    __syncwarp();
  }
}

// Shared memory of a block: the lookup kernel's staging slots and a queue
// a warp.
inline size_t ranks_smem(const ProbeParams& p, int threads) {
  return (size_t)threads * stage_stride(2 + (int)p.blk_w) * 4 +
         (size_t)(threads / 32) * kQueue * 4;
}

// Threads a block: 256 while the block's shared memory fits the 48 KB a
// launch takes without an attribute, else 128 (the widest row heads).
inline int ranks_threads(const ProbeParams& p) {
  return ranks_smem(p, 256) <= 48 * 1024 ? 256 : 128;
}

// static: the occupancy cache passed in stays this library's
template <int W, bool CANON, bool WALK>
static cudaError_t launch_ranks(const ProbeTables& t, const ProbeParams& p, const ProbeIO& io,
                                PerDevice& per_sm, cudaStream_t stream) {
  const int threads = ranks_threads(p);
  const size_t smem = ranks_smem(p, threads);
  int64_t blocks = 0;
  const cudaError_t err =
      pass_blocks(lookup_ranks_kernel<W, CANON, WALK>, threads, per_sm, p.B, &blocks, smem);
  if (err != cudaSuccess) return err;
  lookup_ranks_kernel<W, CANON, WALK><<<(unsigned)blocks, threads, smem, stream>>>(t, p, io);
  return cudaGetLastError();
}

}  // namespace sshash

// C entry for ctypes: the ranks below *io->count of the (B, W) kmers (B the
// stream's P); io carries kmers, kernel 1's minimizers of both strands
// (minval, minpos, minval_r, minpos_r), active, count and the five stream
// fields (kmer_id, kmer_orientation, minimizer_found, found, string_id); v1
// rows, ids fields in p, the whole slot range. Returns the launch's
// cudaError_t (0 on success).
extern "C" int sshash_lookup_ranks(const sshash::ProbeTables* t, const sshash::ProbeParams* p,
                                   const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  static PerDevice per_sm[kMaxFixedW + 1][2][2];  // by kernel width, mode, walk
  if (p->B <= 0) return (int)cudaGetLastError();
  if (bad_params(*t, *p, *io) || p->row_v2 || p->full || !io->count || !io->active ||
      !io->string_id || !io->minval || !io->minpos || !io->minval_r || !io->minpos_r ||
      io->kmers_rc || io->minpos2 || io->hrow_out || io->hrow_in || p->store != kStoreAll ||
      p->slot_lo != 0 || p->slot_hi != (1ll << 32))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const bool walk = p->k - p->m + 1 <= kWalkWindows;
  return (int)dispatch_probe(*p, [&](auto w, auto c) {
    constexpr int W = decltype(w)::value;
    constexpr bool C = decltype(c)::value;
    auto& cache = per_sm[W <= kMaxFixedW ? W - 1 : kMaxFixedW][C];
    if constexpr (W <= kWalkMaxW) {
      if (walk) return launch_ranks<W, C, true>(*t, *p, *io, cache[1], s);
    }
    return launch_ranks<W, C, false>(*t, *p, *io, cache[0], s);
  });
}

// Kernel 2's rank form, in two entries (shard.cuh): the list pass, then
// the list probe over its list (io->list, (B, 2) (rank, key) pairs, and
// io->list_count, its length). Both take its shard form's parameters
// (p->store kStoreOwned or kStorePacked, the hand-off's rows in or out in
// an index with skew classes) over the ranks below *io->count of the (B, W) kmers (B
// the stream's P, or its anchors' count); io carries kmers, kernel 1's
// rank-form minimizers of both strands (minval, minpos, minval_r,
// minpos_r), active (or null: every rank), count and the fields (owned:
// the lookup's with p->full, else the ids fields and string_id; packed:
// the buffer); the RC kmers, minpos2 and the slots stay null. v1 rows
// only.
static bool bad_rank_form(const sshash::ProbeTables& t, const sshash::ProbeParams& p,
                          const sshash::ProbeIO& io) {
  using namespace sshash;
  return bad_params(t, p, io) || p.row_v2 || p.store == kStoreAll || !io.count || !io.minval ||
         !io.minpos || !io.minval_r || !io.minpos_r || io.kmers_rc || io.minpos2 ||
         io.slot_out || io.slot_in || !io.list || !io.list_count ||
         ((io.hrow_out || io.hrow_in) && !p.has_skew) ||
         (io.hrow_out && io.hrow_in) ||
         (p.store == kStoreOwned && !p.full && !io.string_id) || p.B >= (1ll << 31);
}

// The list pass: the list (its count zeroed here) of the active ranks
// whose key is in p's range (slot_lo..slot_hi, or hrow_lo..hrow_hi with
// io->hrow_in: the mesh row's, or in the packed form the rank's shard's);
// with fill the inactive ranks' not found, in the packed form the
// combine's identity on the ranks it does not list.
extern "C" int sshash_rank_lists(const sshash::ProbeTables* t, const sshash::ProbeParams* p,
                                 const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  static PerDevice per_sm[2];  // by mode
  if (bad_rank_form(*t, *p, *io)) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (p->B <= 0) return (int)cudaMemsetAsync(io->list_count, 0, 4, s);
  return (int)(p->canonical ? launch_rank_lists<true>(*t, *p, *io, per_sm[1], s)
                            : launch_rank_lists<false>(*t, *p, *io, per_sm[0], s));
}

// The list probe over the n shards of tables t[0..n) (n <= kMaxRowShards:
// a mesh row's on one card, a launch for each kMaxRowShards of them, or
// one shard), whose keys are [lo + j * per, lo + (j + 1) * per) (their
// slots, or their sk_hrows rows with io->hrow_in; the ranges in p are not
// read): the entries of io->list below *io->list_count whose key one of
// them owns, each probed on its key's shard and stored at its rank; what
// the list pass stored (fill, identity) it leaves, so fill stays off. The
// packed form takes one shard.
extern "C" int sshash_probe_ranks(const sshash::ProbeTables* t, int64_t n, int64_t lo,
                                  int64_t per, const sshash::ProbeParams* p,
                                  const sshash::ProbeIO* io, void* stream) {
  using namespace sshash;
  static PerDevice per_sm[kMaxFixedW + 1][2];  // by width, mode
  if (p->B <= 0) return (int)cudaGetLastError();
  if (n < 1 || n > kMaxRowShards || lo < 0 || per < 1 || p->fill ||
      (p->store == kStorePacked && n != 1))
    return (int)cudaErrorInvalidValue;
  RankShards s{};
  for (int64_t j = 0; j < n; ++j) {
    if (bad_rank_form(t[j], *p, *io)) return (int)cudaErrorInvalidValue;
    s.t[j] = t[j];
  }
  s.n = n;
  s.lo = lo;
  s.per = per;
  ProbeParams q = *p;  // the key the kernel passes on is its shard's own
  q.slot_lo = q.hrow_lo = 0;
  q.slot_hi = q.hrow_hi = 1ll << 32;
  auto st = (cudaStream_t)stream;
  return (int)dispatch_probe(q, [&](auto w, auto c) {
    constexpr int W = decltype(w)::value;
    constexpr bool C = decltype(c)::value;
    return launch_list_probe<W, C>(q, *io, s, per_sm[W <= kMaxFixedW ? W - 1 : kMaxFixedW][C],
                                   st);
  });
}
