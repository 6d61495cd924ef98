// The per-lane probe body of kernel 2 and of the lookup kernel (probe.cu),
// and of the stream's rank-space lookup (lookup_ranks.cu).
//
// sshash_probe (kernel 2): the fused-row probe of lanes whose minimizers
// kernel 1 (minimizer.cu) has computed, one thread per lane. Replaces
// sshash_tpu/engine.py mphf_eval_minimizer (:663), _pilot_read (:531),
// skew_slot (:687, both branches), skew_eval (:713, the legacy heavy path)
// and lookup_with_info (:739) with its verify_fused (:812, v1 and v2 rows)
// and pair_window (:982) sweep; ops/u64.py splitmix64, fmix32, mulhi32,
// hash64_words; ops/packed.py extract_window_dyn, extract_kmer_dyn,
// kmer_equal, kmer_less. Plain version: sshash_tpu_torch/engine.py
// probe_plain. The bucket-sharded engine and its stream call it.
//
// sshash_lookup (the lookup kernel): the whole jitted lookup of
// sshash_tpu/engine.py make_lookup.fn (:1079-1258) with _merge (:1260),
// from the (B, W) kmers alone. Per thread: both strands' minimizers and
// the RC kmer (minimizer.cuh, kernel 1's window walk), then in canonical
// mode the fold of engine.canonical_fold (the smaller minimizer value
// wins; a tie adds the other strand's two position tries) and one probe;
// in regular mode a forward probe and, on a miss, a probe of the RC kmer
// in the same thread, merged as _merge does (a lane that missed forward
// reports BACKWARD whether or not the RC probe finds it, and ORs
// minimizer_found over both probes). Only the result fields are written:
// kernel 1's outputs and the fold's tensors never reach device memory.
// Plain version: sshash_tpu_torch/engine.py lookup_plain.
//
// sshash_lookup_ranks (lookup_ranks.cu): the lookup kernel's lane
// (lookup_lane) over the ranks below a device count, the stream's missed
// lanes, writing the stream's fields only. sshash_probe_ranks
// (lookup_ranks.cu, from shard.cuh): kernel 2's shard form over such ranks,
// for the bucket-sharded stream.
//
// Per lane: minimizer -> raw MPHF slot (one pilot read, one seed-row read
// when partitioned) -> one cw_row read carrying the candidate-0 block (and
// candidate 1 when c1_in_row) -> minimizer guard -> candidate tries; heavy
// lanes hash the canonical kmer into their skew class (a partitioned or a
// plain class MPHF) and read one sk_hrows block (a pre-v1.2 index's too:
// layout.class_hindex derives its rows on the host, so no lane walks the
// TPU's slot -> position -> heavy row chain); mid buckets
// past the row's candidates loop over mid_rows in the lane itself (the TPU
// compacted them into pair windows).
//
// Row formats: v1 blocks resolve a match to a char offset and its string
// with their resolve quad (sid0, ep0, ep1, ep2); v2 ("rebased") blocks
// carry the in-window offset and the resolve words (kid0, rel_ep1), so a
// match resolves straight to its kmer id and no char offset is read or
// formed (indexes of >= 2^32 chars). v2 serves the id fields only, which
// never need sid0, so its blocks leave it out: a 10-word row at k31 m21
// (40 bytes: 2 sectors and 3 staging loads wherever a row starts, as v1's
// 12-word row), and a v2 cw_row is padded to a multiple of 4 words where
// that stages its head in fewer loads or touches fewer sectors
// (layout.row_pad; bad_row_w).
//
// Bound: dependent random reads of device memory, three to four rounds per
// lane (pilot, row, then heavy or mid rows for a few lanes; the legacy
// heavy path one round more), each a row of 10..34 words at k <= 63 and up
// to 52 at k = 255; the lookup kernel adds kernel 1's integer work (k-m+1
// windows a lane), which one warp's hashing can hide under another's row
// wait. The row read: the head of the row (status, cw_a and the candidate-0
// block) is copied into the thread's slot of shared memory with 16-byte
// loads of the aligned segments that cover it (3 loads for a 12-word v1
// row or a 10-word v2 row at k31, at most 4 for any row of <= 13 words),
// and every later read of it (guard, valid bits, window words, the resolve
// words) is a shared
// memory read at a per-lane offset: a warp's word-at-a-time loads from 32
// rows each cost 32 L1 wavefronts and find rows evicted between them;
// registers would need a select chain per read at a runtime offset. Other
// blocks (candidate 1, mid, heavy rows) are read in place, as before.
// Kmers of 1..8 words are templates whose word arrays (the kmer, its RC,
// the candidate read) stay in registers; 9..16 words (k <= 255) run the
// wide form of packed.cuh, whose arrays may spill to local memory.
//
// Every table read clamps its index as jnp.take(..., mode="clip") does
// after the JAX package's int32 cast, so a lane reads exactly the entries
// the JAX program reads, for absent and inactive lanes too.
//
// Bucket shards (kernel 2's shard form, shard.cuh shard_probe_kernel;
// sshash_tpu/parallel/sharded.py _branchfree_lookup, the owner masks of
// engine.py:778-784 and :904-911): a shard holds the rows of MPHF slots
// [slot_lo, slot_hi), its own mid rows (cw_a local), and in an index with
// skew classes the sk_hrows rows [hrow_lo, hrow_hi). Only the slot's
// owner knows a heavy lane's global sk_hrows row, so such a probe
// splits there: with hrow_out the heavy lanes write that row and verify
// nothing; with hrow_in each shard verifies the rows it holds. probe.cu
// sets out where each lane is stored. An unsharded call passes the whole
// slot range and stores every lane.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "minimizer.cuh"
#include "packed.cuh"
#include "stage.cuh"
#include "tables.cuh"
#include "u64.cuh"

namespace sshash {

constexpr uint32_t kInvalid32 = 0xFFFFFFFFu;
constexpr int32_t kForward = 1;
constexpr int32_t kBackward = -1;
constexpr int kMaxTries = 4;
// sk_params rows (sshash_tpu_torch/layout.py SKEW_PARAMS), 8 classes each
enum SkewParam { kTable, kNBuckets, kSeedmixHi, kSeedmixLo, kPilotOff, kPosOff, kNp2, kSeedOff };

// Layouts mirrored by ctypes Structures in sshash_tpu_torch/kernels.py:
// every field is 8 bytes, so neither side pads.
struct ProbeTables {
  const uint32_t* cw_row;
  int64_t cw_rows;
  const uint32_t* mid_rows;
  int64_t mid_n;
  const uint32_t* sk_hrows;
  int64_t sk_hrows_n;
  const uint32_t* pilots;
  int64_t pilots_n;
  const uint32_t* mphf_seedrows;
  int64_t mphf_seedrows_n;
  const uint32_t* sk_pilots;
  int64_t sk_pilots_n;
  const uint32_t* sk_seedrows;
  int64_t sk_seedrows_n;
  const uint32_t* sk_params;  // (8 params, 8 classes)
};

struct ProbeParams {
  int64_t B, W, k, m, canonical, full;
  int64_t win_words, vbits_words, max_start_word, row_w, blk_w;
  int64_t c1_in_row, has_skew, row_v2, skew_partitioned;
  int64_t mphf_partitioned, mphf_P, mphf_part_table, mphf_part_buckets;
  int64_t mphf_nbuckets, mphf_table, pilot_w, sk_pilot_w;
  int64_t slot_lo, slot_hi, hrow_lo, hrow_hi;  // this shard's slots and sk_hrows rows
  int64_t store;     // StoreMode: every lane, or the shard form's owned or packed stores
  int64_t fill;      // kStoreOwned: this launch also stores the inactive lanes
  int64_t rc_round;  // the regular mode's RC round: kStoreOwned merges it in place;
                     // the rank form's kStorePacked probes the RC strand
  uint64_t mphf_seedmix;
  uint64_t magic;  // the minimizer hash's (the lookup kernel's kernel-1 work)
};

// The lookup kernel reads kmers and active only; the rank-space lookup
// (lookup_ranks.cu) and kernel 2's rank form (shard.cuh) kmers, both
// strands' minimizers, active and count.
struct ProbeIO {
  const uint32_t* kmers;     // (B, W)
  const uint32_t* kmers_rc;  // (B, W), canonical only
  const uint64_t* minval;    // (B,)
  const int32_t* minpos;     // (B,)
  const int32_t* minpos2;    // (B,) or null: the tie fold's extra tries
  const uint8_t* active;     // (B,) or null: every lane
  uint32_t* kmer_id;
  int32_t* kmer_orientation;
  uint8_t* minimizer_found;
  uint8_t* found;
  uint32_t* kmer_id_in_string;  // full fields, null in ids mode
  uint32_t* kmer_offset;
  uint32_t* string_id;
  uint32_t* string_begin;
  uint32_t* string_end;
  uint32_t* hrow_out;       // (B,) or null: hand the heavy lanes' rows on
  const uint32_t* hrow_in;  // (B,) or null: verify the handed rows held here
  // the rank-space lookup (lookup_ranks.cu) and kernel 2's rank form only,
  // null elsewhere: the device count, and the RC strand's minimizers beside
  // minval / minpos
  const int32_t* count;
  const uint64_t* minval_r;
  const int32_t* minpos_r;
  // kStorePacked only, null elsewhere: the (F, B) combine buffer
  int32_t* packed;
  // kStoreOwned only, or null: the lanes' MPHF slots, stored by a mesh
  // row's first shard as it evaluates them, read by the others
  uint32_t* slot_out;
  const uint32_t* slot_in;
  // kernel 2's rank form only, null elsewhere: the list of (rank, key)
  // pairs and its length on the device, which its list pass writes and its
  // list probe reads (shard.cuh)
  int32_t* list;
  int32_t* list_count;
};

// Where kernel 2 stores its lanes (probe.cu): every lane (unsharded), or
// in its shard form the lanes this shard owns into result tensors every
// shard of a mesh row shares, or every lane into a packed buffer whose
// signed min over the shards is their combine.
enum StoreMode { kStoreAll = 0, kStoreOwned = 1, kStorePacked = 2 };

// engine._pilot_read: field `bucket` of a table packed at width w (4..32)
__device__ __forceinline__ uint32_t pilot_read(int w, const uint32_t* words, int64_t n,
                                               uint32_t bucket, uint32_t word_off) {
  if (w == 32) return words[clip_row(word_off + bucket, n)];
  const uint32_t ppw = 32u / w;
  const uint32_t shift = 31 - __clz(ppw);
  const uint32_t word = words[clip_row(word_off + (bucket >> shift), n)];
  return (word >> ((bucket & (ppw - 1)) * w)) & ((1u << w) - 1);
}

__device__ __forceinline__ uint32_t skp(const ProbeTables& t, int p, uint32_t cls) {
  return t.sk_params[p * 8 + clip_row(cls, 8)];
}

// engine.mphf_eval_minimizer: minimizer -> raw slot in [0, table_size)
__device__ __forceinline__ uint32_t mphf_slot(const ProbeTables& t, const ProbeParams& p,
                                              uint64_t minval) {
  const uint64_t mh = splitmix64(minval ^ p.mphf_seedmix);
  if (p.mphf_partitioned) {
    const uint32_t pid = mulhi32(hi32(mh), (uint32_t)p.mphf_P);
    const uint32_t* row = t.mphf_seedrows + 2 * clip_row(pid, t.mphf_seedrows_n);
    const uint64_t h2 = splitmix64(mh ^ (((uint64_t)row[0] << 32) | row[1]));
    const uint32_t nb = (uint32_t)p.mphf_part_buckets, T = (uint32_t)p.mphf_part_table;
    const uint32_t bucket = pid * nb + mulhi32(hi32(h2), nb);
    const uint32_t pilot = pilot_read((int)p.pilot_w, t.pilots, t.pilots_n, bucket, 0);
    return pid * T + mulhi32(fmix32(lo32(h2) ^ fmix32(pilot)), T);
  }
  const uint32_t bucket = mulhi32(hi32(mh), (uint32_t)p.mphf_nbuckets);
  const uint32_t pilot = pilot_read((int)p.pilot_w, t.pilots, t.pilots_n, bucket, 0);
  return mulhi32(fmix32(lo32(mh) ^ fmix32(pilot)), (uint32_t)p.mphf_table);
}

// engine.skew_slot: the kmer's slot in its size class's MPHF, partitioned
// (v1.2+ builds) or plain (older ones)
template <int W>
__device__ __forceinline__ uint32_t skew_slot(const ProbeTables& t, const ProbeParams& p,
                                              const uint32_t (&canon)[W], uint32_t cls) {
  const uint64_t seedmix = ((uint64_t)skp(t, kSeedmixHi, cls) << 32) | skp(t, kSeedmixLo, cls);
  const uint64_t h = hash64_words(canon, used_words<W>(p.W), seedmix);
  const uint32_t nb = skp(t, kNBuckets, cls), table = skp(t, kTable, cls);
  if (!p.skew_partitioned) {
    const uint32_t bucket = mulhi32(hi32(h), nb);
    const uint32_t pilot = pilot_read((int)p.sk_pilot_w, t.sk_pilots, t.sk_pilots_n, bucket,
                                      skp(t, kPilotOff, cls));
    return mulhi32(fmix32(lo32(h) ^ fmix32(pilot)), table);
  }
  const uint32_t pid2 = mulhi32(hi32(h), skp(t, kNp2, cls));
  const uint32_t* row =
      t.sk_seedrows + 2 * clip_row(skp(t, kSeedOff, cls) + pid2, t.sk_seedrows_n);
  const uint64_t h2 = splitmix64(h ^ (((uint64_t)row[0] << 32) | row[1]));
  const uint32_t bucket = pid2 * nb + mulhi32(hi32(h2), nb);
  const uint32_t pilot = pilot_read((int)p.sk_pilot_w, t.sk_pilots, t.sk_pilots_n, bucket,
                                    skp(t, kPilotOff, cls));
  return pid2 * table + mulhi32(fmix32(lo32(h2) ^ fmix32(pilot)), table);
}

struct Hit {
  bool match;
  uint32_t off;  // matching char offset (v1 rows) or the kmer id (v2 rows)
  int32_t orient;
  uint32_t sid, begin, end;  // v1 rows only
};

// In-window char offset of a block's candidate: v2 rows store it, v1 rows
// store the candidate's char offset (the window starts at word
// max(0, cand-(k-m)) >> 4).
template <bool V2>
__device__ __forceinline__ uint32_t ext_off(uint32_t col0, uint32_t kmw) {
  return V2 ? col0 : col0 - (((col0 - min(col0, kmw)) >> 4) << 4);
}

// engine.lookup_with_info.verify_fused: verify and resolve one candidate
// block [col0, vbits (Wv), window (Ww), resolve words] at each position
// try, in order; the first hit wins. v1 quad (sid0, ep0, ep1, ep2); v2
// (kid0, rel_ep1): the id is kid0 - pos - over*(k-1), over = (k-m-pos) >=
// rel_ep1.
template <int W, bool CANON, bool V2>
__device__ __forceinline__ Hit verify_block(const uint32_t* blk, const ProbeParams& p,
                                            const uint32_t (&km)[W], const uint32_t (&kr)[W],
                                            const uint32_t (&tries)[kMaxTries], int ntries) {
  Hit h{false, 0, kForward, 0, 0, 0};
  const int Wv = (int)p.vbits_words, Ww = (int)p.win_words;
  const uint32_t kmw = (uint32_t)(p.k - p.m);
  const uint32_t cand = blk[0];
  const uint32_t* vbw = blk + 1;
  const uint32_t* win = blk + 1 + Wv;
  const uint32_t* rsv = blk + 1 + Wv + Ww;
  const uint32_t ext0 = ext_off<V2>(cand, kmw);
  for (int t = 0; t < ntries; ++t) {
    const uint32_t pos = tries[t];
    if (ext0 < pos) continue;
    const uint32_t j = kmw - pos;
    const uint32_t vword = (j >> 5) < (uint32_t)Wv ? vbw[j >> 5] : 0u;
    if (!((vword >> (j & 31u)) & 1u)) continue;
    uint32_t read[W];
    extract_kmer_dyn(win, Ww, (ext0 - pos) * 2u, (int)p.k, (int)p.max_start_word,
                     used_words<W>(p.W), read);
    const bool eq_f = kmer_equal(read, km);
    const bool eq_r = CANON && kmer_equal(read, kr);
    if (!(eq_f || eq_r)) continue;
    h.match = true;
    h.orient = (eq_r && !eq_f) ? kBackward : kForward;
    if (V2) {
      h.off = rsv[0] - pos - (j >= rsv[1] ? (uint32_t)(p.k - 1) : 0u);
      break;
    }
    const uint32_t off = cand - pos;
    const uint32_t ep1 = rsv[2];
    const bool over = off >= ep1;  // at most one string boundary in the span
    h.off = off;
    h.sid = rsv[0] + (over ? 1u : 0u);
    h.begin = over ? ep1 : rsv[1];
    h.end = over ? rsv[3] : ep1;
    break;
  }
  return h;
}

struct Lane {
  bool found, mfound;
  Hit res;
};

// The fused row of MPHF slot s in this shard's cw_row.
__device__ __forceinline__ const uint32_t* slot_row(const ProbeTables& t, const ProbeParams& p,
                                                    uint32_t s) {
  return t.cw_row + clip_row(s - (uint32_t)p.slot_lo, t.cw_rows) * p.row_w;
}

// One lane's probe of its fused row grow, whose head is staged at row:
// guard, candidate 0, the skew index for heavy lanes, candidate 1 and the
// mid sweep. hrow non-null: a heavy lane writes its sk_hrows row there and
// verifies nothing (the hand-off's first pass).
template <int W, bool CANON, bool V2>
__device__ __forceinline__ Lane probe_row(const ProbeTables& t, const ProbeParams& p,
                                          const uint32_t* grow, const uint32_t* row,
                                          const uint32_t (&km)[W], const uint32_t (&kr)[W],
                                          uint64_t minval, const uint32_t (&tries)[kMaxTries],
                                          int ntries, uint32_t* hrow) {
  Lane L{false, true, Hit{false, 0, kForward, 0, 0, 0}};
  const uint32_t sb = row[0], cw_a = row[1];
  const uint32_t status = sb & 3u, cw_b = sb >> 2;
  const bool heavy = status == 2, midload = status == 1;
  const uint32_t size = midload ? cw_b : 1u;
  const uint32_t* c0 = row + 2;

  // minimizer guard on the candidate-0 window (spss:47-65)
  const int Wv = (int)p.vbits_words, Ww = (int)p.win_words;
  const uint32_t gext0 = ext_off<V2>(c0[0], (uint32_t)(p.k - p.m));
  const uint64_t gv = extract_window_dyn(c0 + 1 + Wv, Ww, gext0 * 2u, (int)(2 * p.m),
                                         (int)p.max_start_word);
  bool guard_ok = gv == minval;
  if (CANON) guard_ok |= gv == revcomp_mmer64(minval, (int)p.m);

  if (!heavy) {
    L.res = verify_block<W, CANON, V2>(c0, p, km, kr, tries, ntries);
  } else if (p.has_skew) {
    uint32_t canon[W];
    const bool use_rc = CANON && kmer_less(kr, km);
#pragma unroll
    for (int w = 0; w < W; ++w) canon[w] = use_rc ? kr[w] : km[w];
    const uint32_t hidx = skp(t, kPosOff, cw_b) + skew_slot(t, p, canon, cw_b);
    if (hrow) {
      *hrow = hidx;  // verified by the shard holding that row
    } else {
      L.res = verify_block<W, CANON, V2>(t.sk_hrows + clip_row(hidx, t.sk_hrows_n) * p.blk_w,
                                         p, km, kr, tries, ntries);
    }
  }
  L.found = L.res.match;
  L.mfound = guard_ok || heavy;
  // a failed guard proves the bucket belongs to another minimizer: no
  // further candidate can match
  if (L.mfound && midload && !L.found) {
    if (p.c1_in_row && size >= 2) {
      L.res = verify_block<W, CANON, V2>(grow + 2 + p.blk_w, p, km, kr, tries, ntries);
      L.found = L.res.match;
    }
    for (uint32_t j = p.c1_in_row ? 2u : 1u; !L.found && j < size; ++j) {
      const uint32_t* mrow = t.mid_rows + clip_row(cw_a + j, t.mid_n) * p.blk_w;
      L.res = verify_block<W, CANON, V2>(mrow, p, km, kr, tries, ntries);
      L.found = L.res.match;
    }
  }
  return L;
}

// One lane's probe from its minimizer: its MPHF slot (a lane whose slot is
// not this shard's is inactive here), then probe_row on the row, its head
// staged in slot.
template <int W, bool CANON, bool V2>
__device__ __forceinline__ Lane probe_lane(const ProbeTables& t, const ProbeParams& p,
                                           uint32_t* slot, const uint32_t (&km)[W],
                                           const uint32_t (&kr)[W], uint64_t minval,
                                           const uint32_t (&tries)[kMaxTries], int ntries,
                                           uint32_t* hrow) {
  const uint32_t s = mphf_slot(t, p, minval);
  if (s < p.slot_lo || s >= p.slot_hi) return Lane{false, true, Hit{false, 0, kForward, 0, 0, 0}};
  const uint32_t* grow = slot_row(t, p, s);
  const uint32_t* row = stage_head<head_segments(W)>(grow, 2 + (int)p.blk_w, slot);
  return probe_row<W, CANON, V2>(t, p, grow, row, km, kr, minval, tries, ntries, hrow);
}

// A lane's u32 result fields (0xFFFFFFFF where not found).
struct Fields {
  uint32_t kid, kis, off, sid, begin, end;
};

template <bool V2>
__device__ __forceinline__ Fields lane_fields(const ProbeParams& p, const Lane& L) {
  const bool found = L.found;
  const Hit& res = L.res;
  const uint32_t off = found ? res.off : 0u;
  return Fields{!found ? kInvalid32 : V2 ? off : off - res.sid * (uint32_t)(p.k - 1),
                found ? off - res.begin : kInvalid32, found ? off : kInvalid32,
                found ? res.sid : kInvalid32, found ? res.begin : kInvalid32,
                found ? res.end : kInvalid32};
}

// The result fields of lane i (minimizer_found only with mf). V2: rebased
// rows (ids only); v1 rows write the string fields too when p.full (a
// uniform branch, so the two field forms share one instantiation and the
// build stays short). SID (kernel 2's rank form, shard.cuh): the ids
// fields' form also writes string_id where io.string_id is given (the
// stream's fields); the other kernels leave it out at compile time, so
// their ids form keeps no string id in registers.
template <bool V2, bool SID = false>
__device__ __forceinline__ void write_result(const ProbeIO& io, const ProbeParams& p, int64_t i,
                                             const Lane& L, int32_t orient, bool mf = true) {
  const bool FULL = !V2 && p.full;
  const Fields f = lane_fields<V2>(p, L);
  io.kmer_id[i] = f.kid;
  io.kmer_orientation[i] = orient;
  if (mf) io.minimizer_found[i] = L.mfound;
  io.found[i] = L.found;
  if (FULL) {
    io.kmer_offset[i] = f.off;
    io.string_id[i] = f.sid;
    io.string_begin[i] = f.begin;
    io.string_end[i] = f.end;
    io.kmer_id_in_string[i] = f.kis;
  } else if (SID && !V2 && io.string_id) {
    io.string_id[i] = f.sid;
  }
}

__device__ __forceinline__ uint32_t* thread_slot(uint32_t* stage, const ProbeParams& p) {
  return stage + threadIdx.x * stage_stride(2 + (int)p.blk_w);
}


// Blocks of 256 threads an SM that the lookup kernels' launch bounds ask
// registers for: 4 (half the SM's threads) where the lane's state fits 64
// registers without a spill (canonical widths 1..7, regular 1..3), else 3
// (80 registers); none asked of the wide form. The regular mode's two
// probes in one thread hold more.
__host__ __device__ constexpr int lookup_min_blocks(int W, bool canon) {
  return W > kMaxFixedW ? 1 : (canon ? W <= 7 : W <= 3) ? 4 : 3;
}

// One lane's lookup of its kmer km from both strands' minimizers mz
// (kernel 1's, minimizer.cuh): in canonical mode the fold of
// engine.canonical_fold (the smaller minimizer value and its position; on
// a tie the other strand's position too, and a repeated position adds
// nothing: its tries failed already) and one probe; in regular mode the
// forward probe and, on a miss, the RC kmer (formed only then, in place in
// km) with the RC strand's minimizer (engine._merge: BACKWARD on every lane
// that missed forward, minimizer_found over both probes). Sets orient.
template <int W, bool CANON, bool V2>
__device__ __forceinline__ Lane lookup_lane(const ProbeTables& t, const ProbeParams& p,
                                            uint32_t* slot, uint32_t (&km)[W],
                                            const Minimizers& mz, int32_t& orient) {
  const int nw = used_words<W>(p.W);
  const int k = (int)p.k;
  const uint32_t kmw = (uint32_t)(p.k - p.m);
  uint32_t tries[kMaxTries];
  Lane L{false, true, Hit{false, 0, kForward, 0, 0, 0}};
  if (CANON) {
    const bool rc_first = mz.mv_r < mz.mv_f;
    const uint32_t mp1 = (uint32_t)(rc_first ? mz.mp_r : mz.mp_f);
    const uint32_t mp2 = mz.mv_r == mz.mv_f ? (uint32_t)mz.mp_r : mp1;
    uint32_t kr[W];
    revcomp_words(km, k, nw, kr);
    tries[0] = mp1;
    tries[1] = kmw - mp1;
    tries[2] = mp2;
    tries[3] = kmw - mp2;
    L = probe_lane<W, true, V2>(t, p, slot, km, kr, rc_first ? mz.mv_r : mz.mv_f, tries,
                                mp2 == mp1 ? 2 : 4, nullptr);
    orient = L.found ? L.res.orient : kForward;
    return L;
  }
#pragma unroll 1
  for (int strand = 0; strand < 2; ++strand) {
    tries[0] = (uint32_t)(strand ? mz.mp_r : mz.mp_f);
    const Lane R = probe_lane<W, false, V2>(t, p, slot, km, km, strand ? mz.mv_r : mz.mv_f,
                                            tries, 1, nullptr);
    L.found = R.found;
    L.res = R.res;
    L.mfound = strand ? L.mfound || R.mfound : R.mfound;
    orient = strand ? kBackward : R.found ? R.res.orient : kForward;
    if (R.found || strand) break;
    uint32_t rc[W];
    revcomp_words(km, k, nw, rc);
#pragma unroll
    for (int w = 0; w < W; ++w) km[w] = rc[w];
  }
  return L;
}

// The stream's fields of rank i (v1 rows): what streaming.stream_round2
// and stream_merge read (found, minimizer_found, string_id, kmer_id,
// kmer_orientation).
__device__ __forceinline__ void write_stream_result(const ProbeIO& io, const ProbeParams& p,
                                                    int64_t i, const Lane& L, int32_t orient) {
  const bool found = L.found;
  io.kmer_id[i] = found ? L.res.off - L.res.sid * (uint32_t)(p.k - 1) : kInvalid32;
  io.kmer_orientation[i] = orient;
  io.minimizer_found[i] = L.mfound;
  io.found[i] = found;
  io.string_id[i] = found ? L.res.sid : kInvalid32;
}

// Threads a block of kernel 2 or the lookup kernel: 256 while their slots
// fit the 48 KB of static shared memory, else 128 (row heads past 47
// words, k > 190).
inline int stage_threads(const ProbeParams& p) {
  return 256 * stage_stride(2 + (int)p.blk_w) * 4 <= 48 * 1024 ? 256 : 128;
}

// layout.head_loads and layout.head_sectors times 8: the 16-byte loads that
// stage a row head of n words, and the 32-byte sectors it touches, summed
// over 8 rows of a table of R-word rows.
inline int head_loads8(int n, int R) {
  int s = 0;
  for (int r = 0; r < 8; ++r) s += (r * R % 4 + n + 3) >> 2;
  return s;
}
inline int head_sectors8(int n, int R) {
  int s = 0;
  for (int r = 0; r < 8; ++r) s += (4 * r * R % 32 + 4 * n + 31) >> 5;
  return s;
}

// cw_row's width against the layout's (layout.row_width): status, cw_a and
// 1 or 2 candidate blocks, and in v2 layout.row_pad's zero words: a row
// padded to a multiple of 4 words where that stages its head in fewer
// loads or touches fewer sectors.
inline bool bad_row_w(const ProbeParams& p) {
  const int n = 2 + (int)p.blk_w, R = 2 + (p.c1_in_row ? 2 : 1) * (int)p.blk_w;
  const int pad = (4 - R % 4) % 4;
  const bool padded = p.row_v2 && pad &&
                      (head_loads8(n, R + pad) < head_loads8(n, R) ||
                       head_sectors8(n, R + pad) < head_sectors8(n, R));
  return p.row_w != R + (padded ? pad : 0);
}

// The parameters every probe entry checks: widths, row and block widths of the
// table layout, the skew form's tables, the field form, the shard ranges.
inline bool bad_params(const ProbeTables& t, const ProbeParams& p, const ProbeIO& io) {
  const int W = p.W <= kMaxFixedW ? (int)p.W : kWideW;
  return p.k > kMaxK || p.m < 1 || p.m > 31 || p.W != (2 * p.k + 31) / 32 ||
         (p.full && !io.kmer_offset && !io.packed) || (p.full && p.row_v2) ||
         p.store < kStoreAll || p.store > kStorePacked || (p.store == kStorePacked) != !!io.packed ||
         (p.store != kStorePacked && (!io.kmer_id || !io.found || !io.minimizer_found)) ||
         (p.fill && p.store != kStoreOwned) || (p.rc_round && p.store == kStoreAll) ||
         (p.rc_round && p.canonical) ||
         ((io.slot_out || io.slot_in) && (p.store != kStoreOwned || io.hrow_in)) ||
         (io.slot_out && io.slot_in) ||
         p.blk_w != 1 + p.vbits_words + p.win_words + (p.row_v2 ? 2 : 4) || bad_row_w(p) ||
         (2 + p.blk_w + 6) >> 2 > head_segments(W) ||
         (p.has_skew && !t.sk_hrows) ||
         (p.has_skew && p.skew_partitioned && !t.sk_seedrows) || p.slot_lo < 0 ||
         p.slot_hi > (1ll << 32) || p.hrow_lo < 0 || p.hrow_hi > (1ll << 32);
}

template <typename F>
cudaError_t dispatch_probe(const ProbeParams& p, F&& f) {
  const bool c = p.canonical != 0;
  return dispatch_width(p.W, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return c ? f(std::integral_constant<int, W>{}, std::true_type{})
             : f(std::integral_constant<int, W>{}, std::false_type{});
  });
}

}  // namespace sshash
